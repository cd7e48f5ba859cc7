"""The port's nuScenes path (``toda_tpu_torch/datasets/nuscenes``, the
native metric) against the JAX package's on the same files.

A tiny nuScenes tree from ``chip_smoke.fabricate_nuscenes`` (4 scenes of 3
key frames, 2 sweeps each, 96 azimuth steps: ~2k points a scan; cars,
trucks, pedestrians and barriers, some moving) goes through both packages:
infos from the raw tables, raw scenes with sweeps under CBGS and
LABELED_PERCENTAGE, test and training batches of
``tools/cfgs/dataset_configs/nuscenes_dataset.yaml`` (gt_sampling over the
port-built database), the metric on hand-made cases and through
``evaluation``, and the sub-database selection. Exact equality; the metric
at rtol 1e-12. The gt databases differ by design (box-relative ``.bin``
files and a ``path`` key, ``tests/test_torch_gt_sampling.py``): their
objects' points are held equal here.
"""

import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from toda_tpu.config import EDict as JEDict
from toda_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from toda_tpu.datasets import build_dataloader as j_build_dataloader
from toda_tpu.datasets import build_dataset as j_build_dataset
from toda_tpu.datasets.nuscenes.nuscenes_utils import (
    create_nuscenes_infos as j_create_nuscenes_infos,
)
from toda_tpu.utils.nuscenes_eval_native import nuscenes_eval as j_nuscenes_eval
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.datasets import build_dataloader, build_dataset
from toda_tpu_torch.datasets.nuscenes.nuscenes_utils import create_nuscenes_infos
from toda_tpu_torch.tools import create_infos
from toda_tpu_torch.utils.nuscenes_eval_native import nuscenes_eval

torch.set_num_threads(1)
CLASSES = ["car", "truck", "pedestrian", "barrier"]
SWEEPS = 2


def assert_tree_equal(got, want, path="."):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def nus(tmp_path_factory):
    """The fabricated tree with the port's infos and gt database
    (``create_infos nuscenes --with_gt_db``)."""
    root = tmp_path_factory.mktemp("nuscenes")
    chip_smoke.fabricate_nuscenes(root, scenes=4, samples_per_scene=3, sweeps=SWEEPS,
                                  azimuths=96)
    create_infos.main(["nuscenes", "--data_path", str(root), "--version",
                       chip_smoke.NUS_VERSION, "--max_sweeps", str(SWEEPS), "--with_gt_db",
                       "--classes", ",".join(CLASSES)])
    return root


def nus_cfg(cls, loader, root, **extra):
    c = loader("tools/cfgs/dataset_configs/nuscenes_dataset.yaml", cls())
    c.DATA_PATH = str(root)
    c.MAX_SWEEPS = SWEEPS
    c.INFO_PATH = {"train": [f"nuscenes_infos_{SWEEPS}sweeps_train.pkl"],
                   "test": [f"nuscenes_infos_{SWEEPS}sweeps_val.pkl"]}
    c.DATA_PROCESSOR[2].NUM_POINTS = {"train": 4096, "test": 4096}
    sampler = c.DATA_AUGMENTOR.AUG_CONFIG_LIST[0]
    sampler.DB_INFO_PATH = [f"nuscenes_dbinfos_{SWEEPS}sweeps.pkl"]
    sampler.SAMPLE_GROUPS = ["car:8", "pedestrian:3"]
    c.update(extra)
    return c


def both(root, training, **extra):
    """(JAX's, the port's) NuScenesDataset of the config, each built after
    the same numpy seed (CBGS draws from it)."""
    out = []
    for cls, loader, build in ((JEDict, j_cfg_from_yaml_file, j_build_dataset),
                               (EDict, cfg_from_yaml_file, build_dataset)):
        np.random.seed(5)
        out.append(build(nus_cfg(cls, loader, root, **extra), CLASSES, training=training))
    return out


def test_infos_from_raw_tables_equal_jax(nus, tmp_path):
    """``create_nuscenes_infos`` on the raw tables: the same train and val
    infos (boxes in the lidar frame, velocities, attributes, sweeps with
    their transforms and time lags) and the same pickles."""
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = create_nuscenes_infos(chip_smoke.NUS_VERSION, nus, tmp_path / "p", max_sweeps=SWEEPS)
    want = j_create_nuscenes_infos(chip_smoke.NUS_VERSION, nus, tmp_path / "j",
                                   max_sweeps=SWEEPS)
    assert_tree_equal(got, want)
    train, val = got
    assert len(train) == 9 and len(val) == 3
    assert all(len(i["sweeps"]) == SWEEPS - 1 for i in train + val)
    assert {n for i in train for n in i["gt_names"]} == set(CLASSES)
    assert any(np.abs(i["gt_boxes"][:, 7:9]).max() > 1 for i in train)
    for split in ("train", "val"):
        name = f"nuscenes_infos_{SWEEPS}sweeps_{split}.pkl"
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("case", [
    dict(training=True), dict(training=True, LABELED_PERCENTAGE=50.0),
    dict(training=True, BALANCED_RESAMPLING=False, SHIFT_COOR=None), dict(training=False)])
def test_raw_scenes_with_sweeps_cbgs_and_labeled_percentage_equal_jax(nus, case):
    """The frames a split holds (CBGS from the global numpy state, the
    seeded labelled subset) and every frame's raw scene: key frame and
    sweeps in its frame with the time-lag channel, SHIFT_COOR,
    FILTER_MIN_POINTS_IN_GT. The port's reader takes the info dict too."""
    j, p = both(nus, **case)
    assert [i["token"] for i in p.infos] == [i["token"] for i in j.infos]
    assert len(p) > 0
    for i in range(len(p)):
        got = p.get_raw_scene(i)
        for g, w in zip(got, j.get_raw_scene(i)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        for g, w in zip(p.get_raw_scene(p.infos[i]), got):
            np.testing.assert_array_equal(g, w)
        lags = np.unique(got[0][:, 4])
        assert len(lags) == SWEEPS and lags[0] == 0 and abs(lags[1] - 0.05) < 1e-6


def test_batches_equal_jax(nus):
    """Test-mode and training batches from both packages' loaders: the
    padded points and masks, boxes with velocity and class, the frame
    tokens; training adds gt_sampling over the port-built database (its
    draws and collision checks), flips, rotation, scaling, shuffling."""
    for training in (False, True):
        batches = []
        for cls, loader, build in ((JEDict, j_cfg_from_yaml_file, j_build_dataloader),
                                   (EDict, cfg_from_yaml_file, build_dataloader)):
            np.random.seed(9)
            _, it, _ = build(nus_cfg(cls, loader, nus), CLASSES, batch_size=2,
                              training=training)
            batches.append(list(it))
        want, got = batches
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert_tree_equal(g, w)
        assert got[0]["gt_boxes"].shape[-1] == 10
    assert sum(int((b["gt_boxes"][..., -1] > 0).sum()) for b in got) > 10


def random_annos(rng, n_frames, velocity=True, attributes=True):
    names = np.asarray(["car", "pedestrian", "barrier", "traffic_cone", "truck"])
    attrs = {"car": ["vehicle.moving", "vehicle.parked"],
             "truck": ["vehicle.moving", "vehicle.parked"],
             "pedestrian": ["pedestrian.moving", "pedestrian.standing"],
             "barrier": [""], "traffic_cone": [""]}
    out = []
    for _ in range(n_frames):
        m = rng.randint(3, 9)
        box = np.concatenate([rng.uniform(-40, 40, (m, 2)), rng.uniform(-1, 1, (m, 1)),
                              rng.uniform(0.5, 5, (m, 3)), rng.uniform(-np.pi, np.pi, (m, 1)),
                              rng.normal(0, 3, (m, 2))], 1)
        name = names[rng.randint(len(names), size=m)]
        anno = {"boxes_lidar": box if velocity else box[:, :7], "name": name}
        if attributes:
            anno["attribute"] = np.asarray([attrs[n][rng.randint(len(attrs[n]))] for n in name])
        out.append(anno)
    return out


def detections(rng, gts, shift, vel_noise, attr_flip, drop=0.2, extra=2):
    dets = []
    for gt in gts:
        keep = rng.rand(len(gt["name"])) > drop
        box = gt["boxes_lidar"][keep].copy()
        box[:, :2] += rng.normal(0, shift, (len(box), 2))
        box[:, 3:6] *= rng.uniform(0.9, 1.1, (len(box), 3))
        box[:, 6] += rng.normal(0, 0.2, len(box))
        if box.shape[1] > 7:
            box[:, 7:9] += rng.normal(0, vel_noise, (len(box), 2))
        names = gt["name"][keep]
        ghost = gt["boxes_lidar"][:extra].copy()
        ghost[:, :2] += 30.0
        det = {"boxes_lidar": np.concatenate([box, ghost]),
               "name": np.concatenate([names, gt["name"][:extra]]),
               "score": rng.uniform(0.05, 1.0, len(box) + len(ghost))}
        if "attribute" in gt:
            a = gt["attribute"][keep].copy()
            flip = rng.rand(len(a)) < attr_flip
            a[flip] = np.where(a[flip] == "vehicle.moving", "vehicle.parked", "vehicle.moving")
            det["attribute"] = np.concatenate([a, gt["attribute"][:extra]])
        dets.append(det)
    return dets


EVAL_CASES = {
    "perfect": dict(shift=0.0, vel_noise=0.0, attr_flip=0.0, drop=0.0, extra=0),
    "shifted": dict(shift=0.8, vel_noise=0.0, attr_flip=0.0),
    "velocity": dict(shift=0.3, vel_noise=1.5, attr_flip=0.0),
    "attributes": dict(shift=0.3, vel_noise=0.2, attr_flip=0.4),
    "lidar_only": dict(shift=0.5, vel_noise=0.0, attr_flip=0.0, velocity=False,
                       attributes=False),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_nuscenes_eval_equals_jax(case):
    """The metric's dict (per-class AP at four distances, mAP, the five TP
    errors, NDS) on hand-made frames of five classes, barrier and
    traffic_cone among them for the devkit's exclusions; with and without
    velocity columns and attributes (the lower-bound rule)."""
    kw = dict(EVAL_CASES[case])
    rng = np.random.RandomState(len(case))
    gts = random_annos(rng, 6, velocity=kw.pop("velocity", True),
                       attributes=kw.pop("attributes", True))
    dets = detections(rng, gts, **kw)
    classes = ["car", "pedestrian", "barrier", "traffic_cone", "truck", "bus"]
    got_s, got = nuscenes_eval(dets, gts, classes)
    want_s, want = j_nuscenes_eval(dets, gts, classes)
    assert got_s == want_s and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
    if case == "perfect":
        assert got["AP_car"] == pytest.approx(1.0) and got["mTRANS_ERR"] == 0.0
        assert got["mATTR_ERR"] == 0.0


def test_dataset_evaluation_equals_jax(nus):
    """``evaluation`` of the val split: the GT from the infos (shifted,
    with velocities and attributes), detections without attributes get
    the velocity heuristic's."""
    j, p = both(nus, training=False)
    rng = np.random.RandomState(1)
    dets = []
    for info in p.infos:
        box = info["gt_boxes"].copy()
        box[:, :3] += [0.2, -0.1, 1.8]
        box[:, 7:9] += rng.normal(0, 0.5, (len(box), 2))
        dets.append({"boxes_lidar": box, "name": info["gt_names"],
                     "score": rng.uniform(0.1, 1, len(box))})
    got_s, got = p.evaluation(dets, CLASSES)
    want_s, want = j.evaluation(dets, CLASSES)
    assert got_s == want_s
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
    assert 0.5 < got["NDS"] < 1.0
    anno = {"boxes_lidar": dets[0]["boxes_lidar"], "name": dets[0]["name"]}
    np.testing.assert_array_equal(p.assign_det_attributes(anno), j.assign_det_attributes(anno))


def test_sub_database_selection_equal_jax(nus, tmp_path):
    """``create_sub_groundtruth_database``: the same seeded frame subset;
    each object's box, name and point count, and its points (the port's
    ``.bin``, JAX's inline), equal."""
    j, p = both(nus, training=True, BALANCED_RESAMPLING=False)
    got_db, got_sel = p.create_sub_groundtruth_database(0.5, seed=3,
                                                        out_path=tmp_path / "sub.pkl")
    want_db, want_sel = j.create_sub_groundtruth_database(0.5, seed=3)
    assert got_sel == want_sel and len(got_sel) == 4
    with open(tmp_path / "sub.pkl", "rb") as f:
        assert_tree_equal(pickle.load(f), got_db)
    for name in CLASSES:
        assert len(got_db[name]) == len(want_db[name])
        for g, w in zip(got_db[name], want_db[name]):
            np.testing.assert_array_equal(g["box3d_lidar"], w["box3d_lidar"])
            assert g["name"] == w["name"] and g["num_points_in_gt"] == w["num_points_in_gt"]
            pts = np.fromfile(str(tmp_path / g["path"]), np.float32).reshape(-1, 5)
            np.testing.assert_array_equal(pts, w["points"])
