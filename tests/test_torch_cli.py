"""The port's CLIs (``toda_tpu_torch/tools``) on the CPU, against the JAX
package's where they share a surface.

The tiny TODA stage configs (``toda_tpu_torch/tools/cfgs/toda_tiny``: the
tiny CenterPoint-Res of ``test_torch_model.tiny`` on synthetic domains, as
``tests/test_toda_pipeline.py``) are resolved and written under
``tmp_path``, and ``cfg.ROOT_DIR`` points there, so every run directory is
the test's. Checked: the stage-1 -> pseudo labels -> stage-2 CL -> test
chain through each ``main(argv)``; checkpoint names, the keep count and the
resume from the newest; ``train.py`` and ``stage2_mixup_train.py``;
``test.py --eval_all``; the pseudo-info pickle's keys, types and shapes and
the eval result's keys against JAX's ``generate_pseudo_labels`` and
``eval_one_epoch`` on the same tiny domain; ``resolve_launcher`` against
JAX's on the same environment; ``run_toda.sh`` parses and its checkpoint
glob finds the newest ``.pth``.
"""

import argparse
import pickle
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from toda_tpu_torch.config import cfg as port_cfg
from toda_tpu_torch.tools import (
    cli_args,
    generate_pseudo_labels,
    stage1_cutmix_train,
    stage2_mixup_train,
    stage2_mixup_train_cl,
    test as test_cli,
    train,
)
from toda_tpu_torch.utils.scalar_writer import JsonlScalarWriter

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "toda_tpu_torch/tools/cfgs/toda_tiny"
RUN_TODA = REPO / "toda_tpu_torch/tools/scripts/run_toda.sh"
PSEUDO_KEYS = {"index", "gt_boxes", "gt_names", "score", "point_perturb", "p_voxel_coords",
               "p_voxel_perturb", "p_voxel_size", "p_pc_range"}


def plain(v):
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    return v


def write_cfgs(root):
    """The tiny stage configs resolved and written to <root>/cfgs/toda_tiny
    (so the run directories are output/toda_tiny/<stage>/<tag>)."""
    out = root / "cfgs" / "toda_tiny"
    out.mkdir(parents=True)
    paths = {}
    for name in ("stage1", "pseudo", "stage2"):
        c = cli_args.load_cfg(str(TINY / f"{name}.yaml"))
        for k in ("ROOT_DIR", "LOCAL_RANK", "TAG", "EXP_GROUP_PATH"):
            c.pop(k)
        paths[name] = out / f"{name}.yaml"
        paths[name].write_text(yaml.safe_dump(plain(c)))
    return paths


@pytest.fixture
def run(tmp_path, monkeypatch):
    monkeypatch.setattr(port_cfg, "ROOT_DIR", tmp_path)
    return tmp_path, write_cfgs(tmp_path)


def ckpts(root, stage, tag):
    return sorted(p.name for p in (root / "output/toda_tiny" / stage / tag / "ckpt").iterdir())


def jax_eval_keys(cfg_path):
    """The keys of JAX's eval_one_epoch result on the config's test domain
    (a fake predictor: the keys do not depend on the model)."""
    from toda_tpu.config import EDict, cfg_from_yaml_file
    from toda_tpu.datasets import build_dataloader
    from toda_tpu.runtime.eval_utils import eval_one_epoch

    c = cfg_from_yaml_file(str(cfg_path), EDict())
    ds, loader, _ = build_dataloader(c.DATA_CONFIG_TEST, c.CLASS_NAMES, batch_size=2,
                                     training=False)
    bundle = argparse.Namespace(post_cfg=c.MODEL.POST_PROCESSING)
    res, _ = eval_one_epoch(bundle, None, loader, ds, c.CLASS_NAMES,
                            predict_step=lambda v, a: JaxFake().predict(v, a))
    return set(res)


class JaxFake:
    """A JAX bundle stand-in for ``generate_pseudo_labels``: one box at the
    mean of each frame's points, and a loss quadratic in the points."""

    post_cfg = {}

    def predict(self, variables, batch):
        pts, w = batch["points"], batch["points_mask"].astype(jnp.float32)[..., None]
        center = (pts[..., :3] * w).sum(1) / jnp.clip(w.sum(1), 1.0, None)
        b = pts.shape[0]
        boxes = jnp.zeros((b, 4, 7)).at[:, 0, :3].set(center).at[:, 0, 3:6].set(
            jnp.asarray([4.0, 2.0, 1.6]))
        mask = jnp.zeros((b, 4), jnp.int32).at[:, 0].set(1)
        return {"pred_boxes": boxes, "pred_scores": 0.9 * mask, "pred_labels": mask,
                "pred_mask": mask}

    def loss(self, variables, batch, training=False, mutable=()):
        pts = batch["points"]
        return ((pts[..., :3] - 1.0) ** 2 * batch["points_mask"][..., None]).sum(), {}


def jax_pseudo_infos(cfg_path):
    from toda_tpu.config import EDict, cfg_from_yaml_file
    from toda_tpu.datasets import build_dataloader
    from toda_tpu.runtime.pseudo_label import generate_pseudo_labels as j_generate

    c = cfg_from_yaml_file(str(cfg_path), EDict())
    ds, loader, _ = build_dataloader(c.DATA_CONFIG, c.CLASS_NAMES, batch_size=2, training=False)
    return j_generate(JaxFake(), None, loader, ds, c.CLASS_NAMES, score_thresh=0.0,
                      with_perturb=True, eps=1.0)


def test_toda_chain_through_the_clis(run):
    """stage 1 -> pseudo labels (--perturb) -> stage-2 CL -> test, each
    through its main(argv) on the CPU."""
    root, cfgs = run
    dev = ["--device", "cpu"]
    res1 = stage1_cutmix_train.main(["--cfg_file", str(cfgs["stage1"]), "--extra_tag", "t",
                                     "--epochs", "1", *dev])
    assert ckpts(root, "stage1", "t") == ["checkpoint_epoch_1.pth"]
    s1 = root / "output/toda_tiny/stage1/t/ckpt/checkpoint_epoch_1.pth"
    out = generate_pseudo_labels.main(["--cfg_file", str(cfgs["pseudo"]), "--ckpt", str(s1),
                                       "--perturb", "--score_thresh", "0.0", "--output",
                                       str(root / "pseudo.pkl"), *dev])
    with open(out, "rb") as f:
        infos = pickle.load(f)
    ref = jax_pseudo_infos(cfgs["pseudo"])
    assert len(infos) == len(ref) == 4
    for mine, theirs in zip(infos, ref):
        assert set(mine) == set(theirs) == PSEUDO_KEYS
        assert mine["index"] == theirs["index"]
        for k in PSEUDO_KEYS - {"index"}:
            a, b = np.asarray(mine[k]), np.asarray(theirs[k])
            assert a.dtype.kind == b.dtype.kind and a.ndim == b.ndim, k
            assert a.shape[1:] == b.shape[1:], k
            if k in ("point_perturb", "p_voxel_size", "p_pc_range"):
                assert a.shape == b.shape and a.dtype == b.dtype, k
        assert set(np.unique(mine["point_perturb"])) <= {-1.0, 0.0, 1.0}
    assert sum(len(i["gt_boxes"]) for i in infos) > 0

    res2 = stage2_mixup_train_cl.main(["--cfg_file", str(cfgs["stage2"]), "--pseudo_info_path",
                                       str(out), "--pretrained_model", str(s1), "--extra_tag",
                                       "t", "--epochs", "1", *dev])
    s2 = root / "output/toda_tiny/stage2/t/ckpt/checkpoint_epoch_1.pth"
    assert ckpts(root, "stage2", "t") == [s2.name]
    result = test_cli.main(["--cfg_file", str(cfgs["stage2"]), "--ckpt", str(s2),
                            "--extra_tag", "t", *dev])
    keys = jax_eval_keys(cfgs["stage2"])
    assert set(result) == set(res1) == set(res2) == keys and "compile_sec" in keys
    with open(root / "output/toda_tiny/stage2/t/eval/epoch_1/result.pkl", "rb") as f:
        assert len(pickle.load(f)) == 4
    # the stage-2 weights are not the stage-1 ones
    w1 = torch.load(s1, weights_only=True)["model"]
    w2 = torch.load(s2, weights_only=True)["model"]
    assert any(not torch.equal(w1[k], w2[k]) for k in w1)


def test_checkpoints_keep_count_and_resume_from_newest(run):
    root, cfgs = run
    args = ["--cfg_file", str(cfgs["stage1"]), "--extra_tag", "r", "--skip_eval",
            "--max_ckpt_save_num", "2", "--device", "cpu"]
    stage1_cutmix_train.main([*args, "--epochs", "3"])
    assert ckpts(root, "stage1", "r") == ["checkpoint_epoch_2.pth", "checkpoint_epoch_3.pth"]
    ckdir = root / "output/toda_tiny/stage1/r/ckpt"
    before = (ckdir / "checkpoint_epoch_3.pth").read_bytes()
    steps = torch.load(ckdir / "checkpoint_epoch_3.pth", weights_only=True)["optimizer"]["count"]
    assert steps % 3 == 0 and steps > 0
    # a longer run resumes from epoch 3 and trains one epoch only
    stage1_cutmix_train.main([*args, "--epochs", "4"])
    assert ckpts(root, "stage1", "r") == ["checkpoint_epoch_3.pth", "checkpoint_epoch_4.pth"]
    assert (ckdir / "checkpoint_epoch_3.pth").read_bytes() == before
    last = torch.load(ckdir / "checkpoint_epoch_4.pth", weights_only=True)
    assert last["epoch"] == 4 and last["optimizer"]["count"] == steps // 3 * 4
    # --eval_all evaluates each checkpoint once, recorded across restarts
    ev = ["--cfg_file", str(cfgs["stage1"]), "--extra_tag", "r", "--eval_all",
          "--max_waiting_mins", "0", "--device", "cpu"]
    assert set(test_cli.main(ev)) == {3, 4}
    assert test_cli.main(ev) == {}
    assert set(test_cli.main([*ev, "--eval_tag", "again", "--start_epoch", "4"])) == {4}


def test_train_and_plain_stage2_clis(run, monkeypatch):
    """tools/train.py (scalars, post-train evals) and the stage-2 MixUp
    trainer without the consistency loss."""
    root, cfgs = run
    monkeypatch.setattr(train, "create_scalar_writer", JsonlScalarWriter)
    result = train.main(["--cfg_file", str(cfgs["stage1"]), "--extra_tag", "p", "--epochs", "1",
                         "--batch_size", "2", "--eval_after_train", "--num_epochs_to_eval", "1",
                         "--fix_random_seed", "--device", "cpu"])
    assert ckpts(root, "stage1", "p") == ["checkpoint_epoch_1.pth"]
    run_dir = root / "output/toda_tiny/stage1/p"
    assert (run_dir / "stage1.yaml").exists() and "mAP" in result
    tags = {yaml.safe_load(line)["tag"] for line in
            (run_dir / "tensorboard/scalars.jsonl").read_text().splitlines()}
    assert {"train/loss", "meta_data/learning_rate", "meta_data/batch_time", "eval/mAP"} <= tags

    pseudo = root / "empty_pseudo.pkl"
    with open(pseudo, "wb") as f:
        pickle.dump([], f)
    res = stage2_mixup_train.main(["--cfg_file", str(cfgs["stage2"]), "--pseudo_info_path",
                                   str(pseudo), "--extra_tag", "p", "--epochs", "1",
                                   "--device", "cpu", "--skip_eval"])
    assert res is None and ckpts(root, "stage2", "p") == ["checkpoint_epoch_1.pth"]


def test_cli_device_rule(monkeypatch):
    """The CLIs run on CUDA unless told otherwise, and raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_args.init_from_args(argparse.Namespace(
            launcher="none", slurm=False, coordinator_address=None, num_processes=None,
            process_id=None, device=None))


def test_resolve_launcher_matches_jax(monkeypatch):
    """--launcher pytorch reads torchrun's env as JAX's resolve_launcher does."""
    sys.path.insert(0, str(REPO / "tools"))
    import cli_args as j_cli

    def both(argv):
        out = []
        for mod in (cli_args, j_cli):
            p = argparse.ArgumentParser()
            mod.add_common_train_args(p)
            a = mod.resolve_launcher(p.parse_args(argv))
            out.append((a.coordinator_address, a.num_processes, a.process_id, a.slurm))
        return out

    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    for argv in (["--launcher", "pytorch"],
                 ["--launcher", "pytorch", "--coordinator_address", "h:1", "--num_processes",
                  "2", "--process_id", "1"],
                 ["--launcher", "pytorch", "--tcp_port", "18888"],
                 ["--launcher", "slurm"], []):
        mine, theirs = both(argv)
        assert mine == theirs, argv
    assert both(["--launcher", "pytorch"])[0] == ("10.0.0.7:29500", 4, 2, False)
    monkeypatch.delenv("MASTER_ADDR")
    for mod in (cli_args, j_cli):
        p = argparse.ArgumentParser()
        mod.add_common_train_args(p)
        with pytest.raises(RuntimeError, match="torchrun"):
            mod.resolve_launcher(p.parse_args(["--launcher", "pytorch"]))


def test_run_toda_script_parses_and_finds_the_newest_pth(tmp_path):
    subprocess.run(["bash", "-n", str(RUN_TODA)], check=True)
    text = RUN_TODA.read_text()
    assert "toda_tpu_torch.tools.stage2_mixup_train_cl" in text
    line = text[text.index("STAGE1_CKPT=$("):]
    line = line[:line.index("\n\n")]
    ckdir = tmp_path / "output/stage1_targetmix/stage1/tag/ckpt"
    ckdir.mkdir(parents=True)
    for n in (1, 2, 10):
        (ckdir / f"checkpoint_epoch_{n}.pth").touch()
    (ckdir / "checkpoint_epoch_11").mkdir()  # a JAX (orbax) checkpoint is not taken
    got = subprocess.run(["bash", "-c", f"set -euo pipefail; STAGE1_CFG=x/stage1.yaml; "
                          f"TAG=tag; {line}; echo $STAGE1_CKPT"], cwd=tmp_path, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert got == "output/stage1_targetmix/stage1/tag/ckpt/checkpoint_epoch_10.pth"
