"""The TODA slice on real-format data: the stage configs' own Waymo and
nuScenes domain configs, in both packages, over tiny fabricated files.

``chip_smoke.fabricate_nuscenes`` / ``fabricate_waymo`` write a tiny tree of
each dataset (16 nuScenes key frames of ~2k points a scan, 10 Waymo frames
of a 16 x 256 range image); the port's ``create_infos`` builds their infos
and gt databases and ``fabricate_nuscenes_splits`` the labelled-percentage
splits. The stage configs
(``stage1_targetmix/centerpoint_20_waymo_01_nus_targetmix.yaml``,
``stage2_advmix/centerpoint_5_lab_nus_advmix.yaml``,
``pseudo_labels/centerpoint_generate_90_pseudo_nus_frames.yaml``) are cut
only as ``tests/test_torch_data.py``'s ``small`` cuts a config (range,
NUM_POINTS, voxel size) and point at those files.

Checked: ``CutMixDataset`` samples equal JAX's, given JAX's domains the
7-column boxes the port reads; and the repairs, each beside JAX's
behaviour: a nuScenes pseudo frame read through its 'frame_info' (JAX's
MixUpDataset raises TypeError), the pseudo-label CLI sweeping the
unlabelled split (JAX's CLI loader holds the val split), the mixers fed
boxes of one width (JAX's raise on Waymo's 7 columns beside nuScenes' 9),
the perturbation's targets without the velocity columns (JAX's center head
gets targets two columns wider than its output). Then the ``run_toda.sh``
recipe (stage 1, pseudo labels with the perturbation, stage-2 CL) and
``test`` through the CLIs' mains on the CPU with the tiny CenterPoint-Res of
``toda_tpu_torch/tools/cfgs/toda_tiny``: the test result's metric equals
JAX's ``evaluation`` (``nuscenes_eval``) of the same detections.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from toda_tpu.config import EDict as JEDict
from toda_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from toda_tpu.datasets import build_dataloader as j_build_dataloader
from toda_tpu.datasets import build_dataset as j_build_dataset
from toda_tpu.models.dense_heads.center_head import CenterHead as JCenterHead
from toda_tpu.utils import loss_utils as j_loss_utils
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.config import cfg as port_cfg
from toda_tpu_torch.datasets import build_dataset
from toda_tpu_torch.models import build_network
from toda_tpu_torch.runtime import pseudo_label
from toda_tpu_torch.runtime.pseudo_label import FRAME_INFO_KEYS, generate_pseudo_labels
from toda_tpu_torch.tools import (
    create_infos,
    generate_pseudo_labels as pseudo_cli,
    stage1_cutmix_train,
    stage2_mixup_train_cl,
    test as test_cli,
)

torch.set_num_threads(1)
RANGE = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
STAGE1 = "tools/cfgs/stage1_targetmix/centerpoint_20_waymo_01_nus_targetmix.yaml"
STAGE2 = "tools/cfgs/stage2_advmix/centerpoint_5_lab_nus_advmix.yaml"
PSEUDO = "tools/cfgs/pseudo_labels/centerpoint_generate_90_pseudo_nus_frames.yaml"
TINY_MODEL = "toda_tpu_torch/tools/cfgs/toda_tiny/centerpoint_res_tiny_model.yaml"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("toda_real")
    nus, waymo = root / "nuscenes", root / "waymo"
    chip_smoke.fabricate_nuscenes(nus, scenes=4, samples_per_scene=4, sweeps=2, azimuths=96)
    chip_smoke.fabricate_waymo(waymo / "raw", sequences=1, frames=10, rows=16, cols=256)
    create_infos.main(["nuscenes", "--data_path", str(nus), "--version",
                       chip_smoke.NUS_VERSION, "--with_gt_db", "--classes",
                       ",".join(chip_smoke.NUS_CLASSES)])
    create_infos.main(["waymo", "--data_path", str(waymo / "raw"), "--save_path", str(waymo),
                       "--with_gt_db", "--classes", "Vehicle,Pedestrian,Cyclist"])
    assert chip_smoke.fabricate_nuscenes_splits(nus, frames=4) == {
        "train_01": 4, "train_5": 4, "train_unlabeled_90": 8}
    return root


def cut(d):
    """``tests/test_torch_data.small``'s cut of a dataset config."""
    d.POINT_CLOUD_RANGE = list(RANGE)
    for proc in d.get("DATA_PROCESSOR", []):
        if proc.NAME == "sample_points":
            proc.NUM_POINTS = {"train": 1024, "test": 1024}
        elif proc.NAME == "transform_points_to_voxels":
            proc.VOXEL_SIZE = [0.5, 0.5, 0.5]
    return d


def stage_cfgs(cls, loader, root):
    """(stage 1, stage 2, pseudo) configs of one package over ``root``'s
    files, cut."""
    s1, s2, pl = (loader(f, cls()) for f in (STAGE1, STAGE2, PSEUDO))
    nus, waymo = str(root / "nuscenes"), str(root / "waymo")
    for d, path in ((s1.DATA_CONFIG.SOURCE_CFG, waymo), (s1.DATA_CONFIG.TARGET_CFG, nus),
                    (s1.DATA_CONFIG_TEST, nus), (s2.DATA_CONFIG.BASE_CFG, nus),
                    (s2.DATA_CONFIG_TEST, nus), (pl.DATA_CONFIG, nus)):
        d.DATA_PATH = path
        cut(d)
    cut(s1.DATA_CONFIG)
    cut(s2.DATA_CONFIG)
    return s1, s2, pl


def j_trimmed(dataset):
    """A JAX domain dataset whose scenes carry the 7 box columns the
    port's mixing datasets read."""
    raw = dataset.get_raw_scene

    def get_raw_scene(i):
        points, boxes, names = raw(i)
        return points, boxes[:, :7], names

    dataset.get_raw_scene = get_raw_scene
    return dataset


def assert_sample_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_cutmix_samples_equal_jax_and_box_width_repair(data):
    """The stage-1 CutMixDataset of the stage config (Waymo source with
    SAMPLED_INTERVAL and gt_sampling, nuScenes target with 10 sweeps,
    CBGS, gt_sampling; mixed and plain samples): JAX's raises on the
    first mixed sample (Waymo's 7-column boxes beside nuScenes' 9); given
    JAX's domains 7-column boxes, its samples equal the port's."""
    j1, _, _ = stage_cfgs(JEDict, j_cfg_from_yaml_file, data)
    p1, _, _ = stage_cfgs(EDict, cfg_from_yaml_file, data)
    np.random.seed(0)
    j = j_build_dataset(j1.DATA_CONFIG, j1.CLASS_NAMES, training=True)
    np.random.seed(2)
    with pytest.raises(ValueError, match="dimension"):
        for i in range(len(j)):
            j[i]
    out = []
    for build, cfg, trim in ((j_build_dataset, j1, True), (build_dataset, p1, False)):
        np.random.seed(0)
        ds = build(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=True)
        if trim:
            j_trimmed(ds.source), j_trimmed(ds.target)
        np.random.seed(2)
        out.append([ds[i % len(ds)] for i in range(8)])
    assert len(ds) == 2 + 4
    for g, w in zip(out[1], out[0]):
        assert_sample_equal(g, w)
        assert g["gt_boxes"].shape == (256, 8)


def unlabelled_records(pl, root):
    with open(root / "nuscenes" / pl.DATA_CONFIG.INFO_PATH["train"][0], "rb") as f:
        infos = pickle.load(f)
    return infos, [{"index": fi["token"], "gt_boxes": fi["gt_boxes"][:2, :7],
                    "gt_names": fi["gt_names"][:2], "score": np.ones(2, np.float32),
                    "frame_info": {k: fi[k] for k in FRAME_INFO_KEYS if k in fi}}
                   for fi in infos]


def test_pseudo_frame_read_through_frame_info_repair(data):
    """A pseudo record of the unlabelled split in stage 2: JAX's
    MixUpDataset indexes its labelled base by the record's nuScenes token
    and raises TypeError; the port's loads the frame through its
    'frame_info' with the base's reader: exactly the points JAX's
    NuScenesDataset over the unlabelled split gives for that frame."""
    _, j2, jpl = stage_cfgs(JEDict, j_cfg_from_yaml_file, data)
    _, p2, _ = stage_cfgs(EDict, cfg_from_yaml_file, data)
    _, records = unlabelled_records(jpl, data)
    with open(data / "nuscenes" / j2.DATA_CONFIG.BASE_CFG.INFO_PATH["train"][0], "rb") as f:
        base_tokens = {i["token"] for i in pickle.load(f)}
    assert not base_tokens & {r["index"] for r in records}
    jcfg = jpl.DATA_CONFIG
    jcfg.INFO_PATH = {"train": [], "test": jcfg.INFO_PATH["train"]}
    unl = j_build_dataset(jcfg, jpl.CLASS_NAMES, training=False)
    for k in (0, 5):
        rec = [records[k]]
        j = j_build_dataset(j2.DATA_CONFIG, j2.CLASS_NAMES, training=True, pseudo_infos=rec)
        with pytest.raises(TypeError):
            j._pseudo_sample(np.random.RandomState(0))
        p = build_dataset(p2.DATA_CONFIG, p2.CLASS_NAMES, training=True, pseudo_infos=rec)
        got = p._pseudo_sample(np.random.RandomState(0))
        want = unl.get_raw_scene(k)
        np.testing.assert_array_equal(got["points"], want[0])
        np.testing.assert_array_equal(got["gt_boxes"], records[k]["gt_boxes"])


def test_pseudo_label_cli_sweeps_the_unlabelled_split_repair(data):
    """The loader of the pseudo-label CLI: JAX's
    (``build_dataloader(data_cfg, training=False)``, as
    tools/generate_pseudo_labels.py builds it) holds the val split's
    frames; the port's (``build_unlabelled_loader``) holds the config's
    unlabelled ones, in order, in test mode (the last batch padded)."""
    _, _, jpl = stage_cfgs(JEDict, j_cfg_from_yaml_file, data)
    _, _, ppl = stage_cfgs(EDict, cfg_from_yaml_file, data)
    tokens = {}
    for split in ("val", "train_unlabeled_90"):
        with open(data / "nuscenes" / f"nuscenes_infos_10sweeps_{split}.pkl", "rb") as f:
            tokens[split] = [i["token"] for i in pickle.load(f)]
    _, jloader, _ = j_build_dataloader(jpl.DATA_CONFIG, jpl.CLASS_NAMES, batch_size=3,
                                       training=False)
    ds, loader = pseudo_cli.build_unlabelled_loader(ppl, 3)
    jids = [t for b in jloader for t in b["frame_id"]]
    pids = [t for b in loader for t in b["frame_id"]]
    assert jids[:len(tokens["val"])] == tokens["val"] and len(tokens["val"]) == 4
    assert pids == tokens["train_unlabeled_90"] + tokens["train_unlabeled_90"][:1]
    assert not ds.training and ds.data_augmentor is None


def test_mixup_box_width_repair(data):
    """Stage 2's MixUp of a labelled nuScenes frame (9-column boxes) and a
    pseudo frame (7): JAX's raises in the mixer; the port's reads both
    with 7 columns."""
    _, j2, jpl = stage_cfgs(JEDict, j_cfg_from_yaml_file, data)
    _, p2, _ = stage_cfgs(EDict, cfg_from_yaml_file, data)
    for cfg in (j2, p2):
        cfg.DATA_CONFIG.update(MIXUP_PROB=1.0, MIXUP_TYPE="ps_gt", ADV_ALPHA=0.0)
    _, records = unlabelled_records(jpl, data)
    # JAX reads a record by an index of its base: give it one it can read
    jrec = [dict(records[0], index=0)]
    np.random.seed(1)
    j = j_build_dataset(j2.DATA_CONFIG, j2.CLASS_NAMES, training=True, pseudo_infos=jrec)
    with pytest.raises(ValueError, match="dimension"):
        j.get_raw_item(0)
    np.random.seed(1)
    p = build_dataset(p2.DATA_CONFIG, p2.CLASS_NAMES, training=True, pseudo_infos=records)
    item = p.get_raw_item(0)
    assert item["gt_boxes"].shape[1] == 7 and len(item["gt_boxes"]) > 0


def tiny_model(cls, loader):
    m = loader(TINY_MODEL, cls())
    m.CLASS_NAMES = ["car"]
    m.MODEL.DENSE_HEAD.CLASS_NAMES_EACH_HEAD = [["car"]]
    return m


def test_perturbation_targets_repair(data, monkeypatch):
    """The FGSM step's targets on a nuScenes test batch (boxes with
    velocity, 10 columns): JAX's center head turns 10-column targets into
    10 regression targets beside its 8 outputs, and its loss raises; the
    port's generate_pseudo_labels gives the loss the box columns the head
    decodes and the class (8 columns) and runs, where the same loss on the
    batch's own 10-column boxes raises too. A head that regresses velocity
    gets 10 columns, velocity included."""
    j1, _, _ = stage_cfgs(JEDict, j_cfg_from_yaml_file, data)
    _, _, ppl = stage_cfgs(EDict, cfg_from_yaml_file, data)
    jm = tiny_model(JEDict, j_cfg_from_yaml_file).MODEL
    _, jloader, _ = j_build_dataloader(j1.DATA_CONFIG_TEST, ["car"], batch_size=2,
                                       training=False)
    gt = next(iter(jloader))["gt_boxes"]
    assert gt.shape[-1] == 10
    head = JCenterHead(model_cfg=jm.DENSE_HEAD, input_channels=16, num_class=1,
                       class_names=("car",), grid_size=(64, 64, 8),
                       point_cloud_range=tuple(RANGE), voxel_size=(0.5, 0.5, 0.5))
    (tgt,) = head.assign_targets(jnp.asarray(np.zeros_like(gt)))
    outputs = sum(v["out_channels"] for v in jm.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_DICT.values())
    assert tgt["box_targets"].shape[-1] == 10 and outputs == 8
    with pytest.raises(ValueError, match="Incompatible shapes"):
        j_loss_utils.reg_loss_centernet(jnp.zeros((2, 64 * 64, outputs)), tgt["box_targets"],
                                        tgt["ind"], tgt["mask"])
    ds, loader = pseudo_cli.build_unlabelled_loader(ppl, 2)
    bundle = build_network(tiny_model(EDict, cfg_from_yaml_file).MODEL, 1, ds, device="cpu",
                           seed=0)
    batch = next(iter(loader))
    with pytest.raises(RuntimeError, match="size"):
        bundle.loss(bundle.to_device(batch), training=False)
    widths = []
    make_perturb_step = pseudo_label.make_perturb_step

    def recording(b):
        step = make_perturb_step(b)

        def run(arrays):
            widths.append(arrays["gt_boxes"].shape[-1])
            return step(arrays)
        return run

    monkeypatch.setattr(pseudo_label, "make_perturb_step", recording)
    infos = generate_pseudo_labels(bundle, [batch], ds, ["car"], score_thresh=0.0,
                                   with_perturb=True)
    assert len(infos) == 2 and infos[0]["point_perturb"].shape == (1024, 3)
    vm = tiny_model(EDict, cfg_from_yaml_file).MODEL
    head = vm.DENSE_HEAD
    head.SEPARATE_HEAD_CFG.HEAD_ORDER = [*head.SEPARATE_HEAD_CFG.HEAD_ORDER, "vel"]
    head.SEPARATE_HEAD_CFG.HEAD_DICT["vel"] = EDict({"out_channels": 2, "num_conv": 2})
    head.LOSS_CONFIG.LOSS_WEIGHTS.code_weights = [1.0] * 10
    vbundle = build_network(vm, 1, ds, device="cpu", seed=0)
    infos = generate_pseudo_labels(vbundle, [batch], ds, ["car"], score_thresh=0.0,
                                   with_perturb=True)
    assert len(infos) == 2 and np.isfinite(infos[0]["point_perturb"]).all()
    assert widths == [8, 10]


def plain(v):
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    return v


def test_run_toda_chain_on_real_format_files(data, tmp_path, monkeypatch):
    """The run_toda.sh recipe (stage 1, pseudo labels with --perturb at
    score 0.2, stage-2 CL, each as the script calls it) and ``test`` on
    the stage-2 checkpoint, through the CLIs' mains on the CPU, on the
    stage configs' domains with the tiny model: every stage's
    target-domain result has the nuScenes metric's keys, finite; the
    pseudo infos name the unlabelled frames and carry their frame_info;
    the test result's metric equals JAX's ``evaluation`` of the same
    detections on the val split."""
    monkeypatch.setattr(port_cfg, "ROOT_DIR", tmp_path)
    s1, s2, pl = stage_cfgs(EDict, cfg_from_yaml_file, data)
    tiny = tiny_model(EDict, cfg_from_yaml_file)
    files = {}
    for name, c in (("stage1", s1), ("pseudo", pl), ("stage2", s2)):
        c.CLASS_NAMES, c.OPTIMIZATION = tiny.CLASS_NAMES, tiny.OPTIMIZATION
        c.MODEL = dict(tiny.MODEL, **({"CL_CFG": c.MODEL.CL_CFG} if "CL_CFG" in c.MODEL else {}))
        out = {k: v for k, v in plain(c).items()
               if k not in ("ROOT_DIR", "LOCAL_RANK", "TAG", "EXP_GROUP_PATH")}
        files[name] = tmp_path / "cfgs" / "toda_real" / f"{name}.yaml"
        files[name].parent.mkdir(parents=True, exist_ok=True)
        files[name].write_text(yaml.safe_dump(out))
    dev, tag = ["--device", "cpu", "--batch_size", "2"], "real"
    np.random.seed(0)
    res1 = stage1_cutmix_train.main(["--cfg_file", str(files["stage1"]), "--extra_tag", tag,
                                     "--epochs", "1", *dev])
    run = tmp_path / "output" / "toda_real"
    ck1 = run / "stage1" / tag / "ckpt" / "checkpoint_epoch_1.pth"
    out = pseudo_cli.main(["--cfg_file", str(files["pseudo"]), "--ckpt", str(ck1), "--perturb",
                           "--score_thresh", "0.2", "--output", str(tmp_path / "pseudo.pkl"),
                           *dev])
    with open(out, "rb") as f:
        infos = pickle.load(f)
    unlabelled, _ = unlabelled_records(pl, data)
    assert [i["index"] for i in infos] == [i["frame_info"]["token"] for i in infos] \
        == [u["token"] for u in unlabelled]
    res2 = stage2_mixup_train_cl.main(["--cfg_file", str(files["stage2"]),
                                       "--pseudo_info_path", str(out), "--pretrained_model",
                                       str(ck1), "--extra_tag", tag, "--epochs", "1", *dev])
    ck2 = run / "stage2" / tag / "ckpt" / "checkpoint_epoch_1.pth"
    result = test_cli.main(["--cfg_file", str(files["stage2"]), "--ckpt", str(ck2),
                            "--extra_tag", tag, *dev])
    metric = {"mAP", "NDS", "AP_car", "mTRANS_ERR", "mSCALE_ERR", "mORIENT_ERR", "mVEL_ERR",
              "mATTR_ERR"} | {f"AP_car@{d}" for d in (0.5, 1.0, 2.0, 4.0)}
    for res in (res1, res2, result):
        assert metric <= set(res) and all(np.isfinite(float(res[k])) for k in metric)
    with open(run / "stage2" / tag / "eval" / "epoch_1" / "result.pkl", "rb") as f:
        det_annos = pickle.load(f)
    _, js2, _ = stage_cfgs(JEDict, j_cfg_from_yaml_file, data)
    jval = j_build_dataset(js2.DATA_CONFIG_TEST, ["car"], training=False)
    assert len(det_annos) == len(jval) == 4
    _, want = jval.evaluation(det_annos, ["car"])
    assert set(want) == metric
    for k in metric:
        assert float(result[k]) == want[k], k
