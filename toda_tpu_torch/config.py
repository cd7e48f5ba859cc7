"""Global config system: YAML files with ``_BASE_CONFIG_`` inheritance and typed
dotted-path CLI overrides.

Reference surface: pcdet/config.py:1-86 (global ``cfg`` EasyDict, ``cfg_from_yaml_file``,
recursive ``merge_new_config``, ``cfg_from_list``). Re-implemented from scratch with a
local attribute-dict (no easydict dependency). The port's own copy of
``toda_tpu/config.py``; ``_BASE_CONFIG_`` paths resolve against the working
directory, so callers run from the repository root.
"""

from pathlib import Path

import yaml


class EDict(dict):
    """Minimal attribute-access dict (recursive)."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d is None:
            d = {}
        d = dict(d, **kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, EDict):
            return EDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(EDict._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, EDict._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError:
            raise AttributeError(k)

    def copy(self):
        return EDict({k: (v.copy() if isinstance(v, EDict) else v) for k, v in self.items()})


# Global config object, mirrored from the reference's module-level ``cfg``.
cfg = EDict()
cfg.ROOT_DIR = (Path(__file__).resolve().parent / "..").resolve()
cfg.LOCAL_RANK = 0


def log_config_to_file(cfg_dict, pre="cfg", logger=None):
    for key, val in cfg_dict.items():
        if isinstance(val, EDict):
            logger.info("----------- %s -----------", key)
            log_config_to_file(val, pre=pre + "." + key, logger=logger)
            continue
        logger.info("%s.%s: %s", pre, key, val)


def merge_new_config(config, new_config):
    """Recursively merge ``new_config`` into ``config``; ``_BASE_CONFIG_`` loads a
    parent YAML first (reference: pcdet/config.py:37-52)."""
    if "_BASE_CONFIG_" in new_config:
        with open(new_config["_BASE_CONFIG_"], "r") as f:
            yaml_config = yaml.safe_load(f)
        # the parent may itself carry (nested) _BASE_CONFIG_ entries — resolve
        # them recursively before merging the child on top
        config.update(merge_new_config(EDict(), EDict(yaml_config)))

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config.get(key), dict):
                config[key] = EDict()
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file, config=None):
    if config is None:
        config = cfg
    with open(cfg_file, "r") as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config=config, new_config=new_config)
    config.TAG = Path(cfg_file).stem
    # e.g. tools/cfgs/nuscenes_models/foo.yaml -> EXP_GROUP_PATH "nuscenes_models"
    parts = str(cfg_file).split("/")
    if "cfgs" in parts:
        config.EXP_GROUP_PATH = "/".join(parts[parts.index("cfgs") + 1 : -1])
    else:
        config.EXP_GROUP_PATH = ""
    return config


def cfg_from_list(cfg_list, config=None):
    """Set config keys from a list ``['KEY.SUBKEY', 'value', ...]`` with literal-eval
    typing (reference: pcdet/config.py:16-35)."""
    from ast import literal_eval

    if config is None:
        config = cfg
    assert len(cfg_list) % 2 == 0, "override list must be key/value pairs"
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split(".")
        d = config
        for subkey in key_list[:-1]:
            assert subkey in d, f"NotFoundKey: {subkey}"
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, f"NotFoundKey: {subkey}"
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        if type(value) != type(d[subkey]) and isinstance(d[subkey], EDict):
            key_val_list = v.split(",")
            for kv in key_val_list:
                k1, v1 = kv.split(":")
                src = type(d[subkey][k1])
                d[subkey][k1] = src(v1)
        elif type(value) != type(d[subkey]) and isinstance(d[subkey], list):
            val_list = v.split(",")
            for i, x in enumerate(val_list):
                try:
                    val_list[i] = literal_eval(x)
                except (ValueError, SyntaxError):
                    pass
            d[subkey] = val_list
        else:
            d[subkey] = value
    return config
