"""The KITTI data path and metric, and TODA's nuScenes -> KITTI stage 1: the
port against the JAX package on tiny fabricated files.

``chip_smoke.fabricate_kitti`` writes a raw KITTI tree (HDL-64E scans
thinned to 128 azimuths, the published calibration text, camera-frame
labels of every difficulty with a DontCare row, ImageSets) and
``fabricate_nuscenes`` a tiny nuScenes tree; the port's ``create_infos``
builds the infos and gt databases of both. Checked against JAX's:
calibration and label parsing, the camera <-> lidar box conversions,
``get_infos`` from the raw tree, ``__getitem__`` (test, FOV_POINTS_ONLY,
and training with gt_sampling under one seed), ``generate_prediction_dicts``
and its label files, ``kitti_eval`` on shared det / gt annos (the
difficulty, DontCare, neighbour-class and AOS cases of
``tests/test_kitti_adapter.py`` and the fabricated val split), and one
nuScenes -> KITTI polarmix CutMix run. The F5 repair for KITTI: JAX's
inline gt database pastes its objects at the sensor, the port's in their
boxes. A pin, not a repair: ``kitti_dataset.yaml``'s ``SAMPLE_GROUPS:
['Car:15']`` under the stage config's ``CLASS_NAMES: ['car']`` samples
nothing in either package. Last, the stage-1 CLI on the stage config's
domains with a tiny SECOND-IoU and ``test`` on KITTI val, whose result is
the dataset's ``evaluation`` of the detections it saved.
"""

import pickle

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from toda_tpu.config import EDict as JEDict
from toda_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from toda_tpu.datasets import build_dataset as j_build_dataset
from toda_tpu.datasets.augmentor.database_sampler import DataBaseSampler as JSampler
from toda_tpu.datasets.dataset import DatasetTemplate as JTemplate
from toda_tpu.datasets.kitti import calibration_kitti as j_calib
from toda_tpu.datasets.kitti import object3d_kitti as j_obj
from toda_tpu.datasets.kitti.kitti_dataset import KittiDataset as JKitti
from toda_tpu.utils import box_utils as j_box_utils
from toda_tpu.utils.kitti_eval_native import kitti_eval as j_kitti_eval
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.config import cfg as port_cfg
from toda_tpu_torch.datasets import build_dataset
from toda_tpu_torch.datasets.augmentor.database_sampler import DataBaseSampler
from toda_tpu_torch.datasets.kitti import calibration_kitti, object3d_kitti
from toda_tpu_torch.tools import create_infos, stage1_cutmix_train
from toda_tpu_torch.tools import test as test_cli
from toda_tpu_torch.utils import box_utils
from toda_tpu_torch.utils.kitti_eval_native import kitti_eval

torch.set_num_threads(1)
RANGE = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
KITTI_CFG = "tools/cfgs/dataset_configs/kitti_dataset.yaml"
STAGE1 = "tools/cfgs/stage1_targetmix/second_iou_nus_kitti_targetmix.yaml"
SECOND_IOU = "tools/cfgs/synthetic_models/second_iou_synthetic.yaml"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A tiny KITTI tree (4 train, 4 val frames) with the port's infos and
    gt database of Car, Pedestrian and Cyclist, JAX's inline database of
    the same frames, and a tiny nuScenes tree with 10-sweep infos and its
    gt database."""
    root = tmp_path_factory.mktemp("kitti")
    kitti, nus = root / "kitti", root / "nuscenes"
    stats = chip_smoke.fabricate_kitti(kitti, train=4, val=4, azimuths=128)
    assert stats["frames"] == 8 and stats["labels"] > 30
    create_infos.main(["kitti", "--data_path", str(kitti), "--with_gt_db", "--classes",
                       "Car,Pedestrian,Cyclist"])
    jds = j_raw_dataset(kitti, "train")
    with open(kitti / "kitti_infos_train.pkl", "rb") as f:
        jds.infos = pickle.load(f)
    jds.create_groundtruth_database(used_classes=["Car"], out_path=kitti / "jax_dbinfos.pkl")
    chip_smoke.fabricate_nuscenes(nus, scenes=2, samples_per_scene=4, sweeps=2, azimuths=96)
    create_infos.main(["nuscenes", "--data_path", str(nus), "--version",
                       chip_smoke.NUS_VERSION, "--with_gt_db", "--classes", "car"])
    return root


def raw_cfg(cls, root, split):
    return cls({
        "DATASET": "KittiDataset", "DATA_PATH": str(root),
        "DATA_SPLIT": {"train": split, "test": split}, "INFO_PATH": {"train": [], "test": []},
        "POINT_CLOUD_RANGE": [0, -40.0, -3.0, 70.4, 40.0, 1.0],
        "POINT_FEATURE_ENCODING": {"encoding_type": "absolute_coordinates_encoding",
                                   "used_feature_list": ["x", "y", "z", "intensity"],
                                   "src_feature_list": ["x", "y", "z", "intensity"]},
        "DATA_PROCESSOR": [], "DATA_AUGMENTOR": {"AUG_CONFIG_LIST": []}})


def j_raw_dataset(root, split):
    """JAX's KittiDataset over a raw tree, as its create_infos builds it."""
    ds = JKitti.__new__(JKitti)
    JTemplate.__init__(ds, dataset_cfg=raw_cfg(JEDict, root, split), class_names=None,
                       training=split == "train")
    ds.infos = []
    return ds


def cut(d):
    """A dataset config at the tiny scale: range +-16 m, 1024 points, 0.5 m
    voxels."""
    d.POINT_CLOUD_RANGE = list(RANGE)
    for proc in d.get("DATA_PROCESSOR", []):
        if proc.NAME == "sample_points":
            proc.NUM_POINTS = {"train": 1024, "test": 1024}
        elif proc.NAME == "transform_points_to_voxels":
            proc.VOXEL_SIZE = [0.5, 0.5, 0.5]
    return d


def kitti_cfg(cls, loader, root):
    c = cut(loader(KITTI_CFG, cls()))
    c.DATA_PATH = str(root / "kitti")
    return c


def assert_equal(got, want, path="", rtol=0.0):
    """Nested dicts / lists / arrays equal (floats within ``rtol``)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_equal(got[k], want[k], f"{path}.{k}", rtol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal(g, w, f"{path}[{i}]", rtol)
    elif isinstance(want, np.ndarray) and want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=path)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=rtol, abs=0), path
    else:
        assert got == want, path


def test_calibration_and_labels_equal_jax(data):
    """The calib text and a label file parse to JAX's values: matrices,
    the lidar <-> rectified <-> image transforms, every label field and the
    official difficulty (all three levels and -1 occur in the tree)."""
    root = data / "kitti" / "training"
    calib = calibration_kitti.Calibration(str(root / "calib" / "000001.txt"))
    jc = j_calib.Calibration(str(root / "calib" / "000001.txt"))
    for k in ("P2", "R0", "V2C", "cu", "cv", "fu", "fv", "tx", "ty"):
        np.testing.assert_array_equal(getattr(calib, k), getattr(jc, k), err_msg=k)
    pts = np.random.RandomState(0).uniform(-20, 20, (50, 3)).astype(np.float32)
    pts[:, 0] = np.abs(pts[:, 0]) + 2
    for fn in ("lidar_to_rect", "rect_to_lidar", "lidar_to_img"):
        assert_equal(getattr(calib, fn)(pts), getattr(jc, fn)(pts), fn)
    levels = set()
    for i in range(8):
        got = object3d_kitti.get_objects_from_label(str(root / "label_2" / f"{i:06d}.txt"))
        want = j_obj.get_objects_from_label(str(root / "label_2" / f"{i:06d}.txt"))
        assert [vars(o).keys() for o in got] == [vars(o).keys() for o in want]
        for g, w in zip(got, want):
            assert_equal(vars(g), vars(w))
            levels.add(g.level)
    assert levels == {-1, 0, 1, 2}


def test_box_conversions_equal_jax(data):
    """Lidar <-> KITTI camera boxes, the camera corners and the clipped
    image boxes equal JAX's."""
    calib = calibration_kitti.Calibration(str(data / "kitti" / "training" / "calib" /
                                              "000000.txt"))
    jc = j_calib.Calibration(str(data / "kitti" / "training" / "calib" / "000000.txt"))
    rng = np.random.RandomState(1)
    boxes = np.concatenate([rng.uniform(3, 40, (20, 1)), rng.uniform(-15, 15, (20, 1)),
                            rng.uniform(-1.5, 0, (20, 1)), rng.uniform(0.5, 5, (20, 3)),
                            rng.uniform(-np.pi, np.pi, (20, 1))], 1).astype(np.float32)
    cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
    np.testing.assert_array_equal(cam, j_box_utils.boxes3d_lidar_to_kitti_camera(boxes, jc))
    np.testing.assert_array_equal(box_utils.boxes3d_kitti_camera_to_lidar(cam, calib),
                                  j_box_utils.boxes3d_kitti_camera_to_lidar(cam, jc))
    np.testing.assert_array_equal(box_utils.boxes3d_to_corners3d_kitti_camera(cam),
                                  j_box_utils.boxes3d_to_corners3d_kitti_camera(cam))
    for shape in (None, (375, 1242)):
        np.testing.assert_array_equal(
            box_utils.boxes3d_kitti_camera_to_imageboxes(cam, calib, shape),
            j_box_utils.boxes3d_kitti_camera_to_imageboxes(cam, jc, shape))


@pytest.mark.parametrize("split", ["train", "val"])
def test_create_infos_equal_jax(data, split):
    """``create_infos kitti``'s infos equal JAX's ``get_infos`` of the same
    raw tree: calibration blocks, image shape, every anno field, the lidar
    boxes and the points counted in each (-1 for DontCare)."""
    with open(data / "kitti" / f"kitti_infos_{split}.pkl", "rb") as f:
        got = pickle.load(f)
    want = j_raw_dataset(data / "kitti", split).get_infos()
    assert len(got) == 4 and [i["point_cloud"]["lidar_idx"] for i in got] == \
        [f"{i + (4 if split == 'val' else 0):06d}" for i in range(4)]
    assert_equal(got, want)
    ann = got[0]["annos"]
    assert ann["name"][-1] == "DontCare" and ann["num_points_in_gt"][-1] == -1
    assert (ann["num_points_in_gt"][:-1] >= 0).all()


@pytest.mark.parametrize("mode", ["test", "fov", "train"])
def test_samples_equal_jax(data, mode):
    """``__getitem__`` under one numpy seed equals JAX's: test mode, test
    mode with FOV_POINTS_ONLY (fewer points), and training with
    kitti_dataset.yaml's augmentor (gt_sampling from the port's database,
    flip, rotation, scaling) under ``CLASS_NAMES: ['Car']``."""
    out = []
    for cls, loader, build in ((JEDict, j_cfg_from_yaml_file, j_build_dataset),
                               (EDict, cfg_from_yaml_file, build_dataset)):
        c = kitti_cfg(cls, loader, data)
        c.FOV_POINTS_ONLY = mode == "fov"
        np.random.seed(3)
        ds = build(c, ["Car"], training=mode == "train")
        out.append([ds[i] for i in range(len(ds))])
        raw = ds.get_raw_scene(0)[0]
    full = np.fromfile(str(data / "kitti" / "training" / "velodyne" /
                           ("000000.bin" if mode == "train" else "000004.bin")), np.float32)
    assert (len(raw) < len(full) // 4) == (mode == "fov")
    assert_equal(out[1], out[0])


def det_annos_of(infos, seed):
    """Noisy detections of each frame's labelled boxes, some dropped, with
    false positives: {'pred_boxes', 'pred_scores', 'pred_labels',
    'pred_mask'} per frame."""
    rng = np.random.RandomState(seed)
    preds = []
    for info in infos:
        boxes = info["annos"]["gt_boxes_lidar"]
        keep = rng.rand(len(boxes)) < 0.8
        b = boxes[keep] + rng.normal(0, 0.1, (int(keep.sum()), 7)).astype(np.float32)
        fp = np.concatenate([rng.uniform(0, 30, (3, 2)), np.full((3, 1), -0.9),
                             np.tile([[3.9, 1.6, 1.5]], (3, 1)),
                             rng.uniform(-3, 3, (3, 1))], 1).astype(np.float32)
        b = np.concatenate([b, fp])
        mask = np.ones(len(b) + 2, bool)
        mask[-2:] = False
        preds.append({"pred_boxes": np.concatenate([b, np.zeros((2, 7), np.float32)]),
                      "pred_scores": rng.rand(len(mask)).astype(np.float32),
                      "pred_labels": np.ones(len(mask), np.int64), "pred_mask": mask})
    return preds


def test_prediction_dicts_equal_jax(data, tmp_path):
    """``generate_prediction_dicts`` on the val split: names, scores, lidar
    boxes, camera boxes, projected 2D boxes and alpha equal JAX's, and the
    label-format files are byte-equal."""
    infos = pickle.load(open(data / "kitti" / "kitti_infos_val.pkl", "rb"))
    preds = det_annos_of(infos, 4)
    batch = {"frame_id": [i["point_cloud"]["lidar_idx"] for i in infos]}
    out = []
    for cls, loader, build, sub in ((JEDict, j_cfg_from_yaml_file, j_build_dataset, "jax"),
                                    (EDict, cfg_from_yaml_file, build_dataset, "port")):
        ds = build(kitti_cfg(cls, loader, data), ["Car"], training=False)
        out.append(ds.generate_prediction_dicts(batch, preds, ["Car"],
                                                output_path=tmp_path / sub))
    assert_equal(out[1], out[0])
    assert {"bbox", "alpha", "location"} <= set(out[1][0])
    for fid in batch["frame_id"]:
        assert (tmp_path / "port" / f"{fid}.txt").read_bytes() == \
            (tmp_path / "jax" / f"{fid}.txt").read_bytes()


def adapter_case(name):
    """(det_annos, gt_annos) of one case of tests/test_kitti_adapter.py."""
    rng = np.random.RandomState(0)
    gt, det = [], []
    k = 0
    for _ in range(10):
        boxes = np.zeros((6, 7), np.float32)
        boxes[:, :2] = rng.uniform(-30, 30, (6, 2))
        boxes[:, 2], boxes[:, 3:6] = -1.0, [4.0, 2.0, 1.6]
        names = np.asarray(["car"] * 6)
        gt.append({"boxes_lidar": boxes, "name": names, "difficulty": np.zeros(6, np.int32)})
        det.append({"boxes_lidar": boxes.copy(), "name": names.copy(),
                    "score": (1.0 - 0.001 * (k + np.arange(6))).astype(np.float32)})
        k += 6
    if name == "half_recall":
        det = [{key: d[key][:3] for key in d} for d in det]
    elif name == "misses":
        det = [{"boxes_lidar": np.zeros((0, 7)), "name": np.asarray([]),
                "score": np.asarray([])} for _ in gt]
    elif name == "neighbour_class":
        van = np.asarray([[15.0, 15.0, -1.0, 5.0, 2.2, 2.0, 0.0]], np.float32)
        gt.append({"boxes_lidar": van, "name": np.asarray(["van"]),
                   "difficulty": np.zeros(1, np.int32)})
        det.append({"boxes_lidar": van.copy(), "name": np.asarray(["car"]),
                    "score": np.asarray([0.99], np.float32)})
    elif name == "bbox_aos":
        for g, d in zip(gt, det):
            x1, y1 = rng.uniform(0, 1000, 6), rng.uniform(0, 200, 6)
            g["bbox"] = np.stack([x1, y1, x1 + rng.uniform(20, 60, 6),
                                  y1 + rng.uniform(20, 60, 6)], 1).astype(np.float32)
            g["alpha"] = rng.uniform(-np.pi, np.pi, 6).astype(np.float32)
            g["occluded"], g["truncated"] = rng.randint(0, 3, 6), rng.uniform(0, 0.4, 6)
            d["bbox"] = g["bbox"] + rng.normal(0, 3, (6, 4)).astype(np.float32)
            d["alpha"] = g["alpha"] + rng.normal(0, 0.3, 6).astype(np.float32)
        gt[0]["name"] = np.asarray(["car"] * 5 + ["dontcare"])
    return det, gt


@pytest.mark.parametrize("case", ["perfect", "half_recall", "misses", "neighbour_class",
                                  "bbox_aos"])
def test_kitti_eval_equals_jax(case):
    """``kitti_eval`` on shared annos, every AP_R40 (and AOS) key equal to
    JAX's; the adapter's expected values hold."""
    det, gt = adapter_case(case)
    _, got = kitti_eval(det, gt, ["car"])
    _, want = j_kitti_eval(det, gt, ["car"])
    assert_equal(got, want)
    if case == "perfect":
        assert got["car_3d_moderate_R40"] > 0.97
    elif case == "half_recall":
        assert 0.4 < got["car_3d_moderate_R40"] < 0.6
    elif case == "misses":
        assert got["mAP_3d_moderate"] == 0.0
    elif case == "bbox_aos":
        assert {f"car_{m}_{d}_R40" for m in ("bbox", "aos", "bev", "3d")
                for d in ("easy", "moderate", "hard")} <= set(got)


def test_evaluation_on_val_split_equals_jax(data):
    """``KittiDataset.evaluation`` of noisy detections (through
    ``generate_prediction_dicts``: bbox, alpha) on the fabricated val
    split, whose DontCare rows and difficulties come from its labels:
    every key equal to JAX's, the car APs finite and above 0."""
    infos = pickle.load(open(data / "kitti" / "kitti_infos_val.pkl", "rb"))
    preds = det_annos_of(infos, 5)
    batch = {"frame_id": [i["point_cloud"]["lidar_idx"] for i in infos]}
    results = []
    for cls, loader, build in ((JEDict, j_cfg_from_yaml_file, j_build_dataset),
                               (EDict, cfg_from_yaml_file, build_dataset)):
        ds = build(kitti_cfg(cls, loader, data), ["car"], training=False)
        annos = ds.generate_prediction_dicts(batch, preds, ["car"])
        results.append(ds.evaluation(annos, ["car"])[1])
    assert_equal(results[1], results[0])
    for m in ("bbox", "aos", "bev", "3d"):
        for d in ("easy", "moderate", "hard"):
            assert 0 < results[1][f"car_{m}_{d}_R40"] <= 1, (m, d)


def kitti_sampler(cls, loader, root, db, classes):
    c = loader(KITTI_CFG, cls()).DATA_AUGMENTOR.AUG_CONFIG_LIST[0]
    c.DB_INFO_PATH = [db]
    return (JSampler if cls is JEDict else DataBaseSampler)(root, c, classes)


def val_scene(data):
    ds = build_dataset(kitti_cfg(EDict, cfg_from_yaml_file, data), ["Car"], training=False)
    points, boxes, names = ds.get_raw_scene(0)
    return {"points": points, "gt_boxes": boxes, "gt_names": names}


def test_gt_database_pasted_in_boxes_repair(data):
    """The F5 repair for KITTI: kitti_dataset.yaml's sampler (Car:15,
    LIMIT_WHOLE_SCENE) under ``['Car']``. JAX's inline database through
    JAX's sampler pastes cars whose points sit around the sensor, none in
    its box; the port's ``.bin`` database through either sampler pastes
    every point in its box, with equal outputs."""
    root, scene = data / "kitti", val_scene(data)
    outs = {}
    for name, cls, loader, db in (
            ("jax_inline", JEDict, j_cfg_from_yaml_file, "jax_dbinfos.pkl"),
            ("jax_path", JEDict, j_cfg_from_yaml_file, "kitti_dbinfos_train.pkl"),
            ("port_path", EDict, cfg_from_yaml_file, "kitti_dbinfos_train.pkl")):
        np.random.seed(7)
        sampler = kitti_sampler(cls, loader, root, db, ["Car"])
        outs[name] = sampler({k: v.copy() for k, v in scene.items()})
    for name, out in outs.items():
        new = out["gt_boxes"][len(scene["gt_boxes"]):]
        kept = box_utils.remove_points_in_boxes3d(scene["points"], new)
        obj = out["points"][:len(out["points"]) - len(kept)]
        inside = int(box_utils.points_in_boxes_numpy(obj, new).any(0).sum())
        assert len(new) >= 2 and len(obj) > 20, name
        if name == "jax_inline":
            assert inside == 0 and np.abs(obj[:, :2]).mean() < 3.0
        else:
            assert inside == len(obj), name
    assert_equal(outs["port_path"], outs["jax_path"])


def test_car_groups_sample_nothing_under_lowercase_car(data):
    """A pin of the reference, not a repair: kitti_dataset.yaml's
    ``SAMPLE_GROUPS: ['Car:15']`` keys its pool by KITTI's class name, and
    the nuScenes -> KITTI stage config trains ``CLASS_NAMES: ['car']``
    (CLASS_MAPPING renames Car after the draw), so neither package's
    sampler draws a car; with ``Car`` in the class list both do."""
    scene = val_scene(data)
    for cls, loader in ((JEDict, j_cfg_from_yaml_file), (EDict, cfg_from_yaml_file)):
        for classes, drawn in ((["car"], False), (["Car"], True)):
            np.random.seed(0)
            s = kitti_sampler(cls, loader, data / "kitti", "kitti_dbinfos_train.pkl", classes)
            out = s({k: v.copy() for k, v in scene.items()})
            assert (len(out["gt_boxes"]) > len(scene["gt_boxes"])) == drawn, (cls, classes)
            assert bool(s.sample_groups) == drawn


def stage1_cfg(cls, loader, data):
    """The nuScenes -> KITTI stage-1 config over the fabricated files, cut."""
    c = loader(STAGE1, cls())
    for d, path in ((c.DATA_CONFIG.SOURCE_CFG, "nuscenes"), (c.DATA_CONFIG.TARGET_CFG, "kitti"),
                    (c.DATA_CONFIG_TEST, "kitti")):
        d.DATA_PATH = str(data / path)
        cut(d)
    cut(c.DATA_CONFIG)
    return c


def j_four_columns(dataset):
    """A JAX domain dataset whose scenes carry x, y, z, intensity: the
    columns the mixing dataset's encoding names, which the port picks
    after each domain's augmentation."""
    raw = dataset.get_raw_scene

    def get_raw_scene(i):
        points, boxes, names = raw(i)
        return points[:, :4], boxes, names

    dataset.get_raw_scene = get_raw_scene
    return dataset


def test_cutmix_nus_kitti_samples_equal_jax_and_point_width_repair(data):
    """The stage config's CutMixDataset (polarmix with the ASC width
    curriculum at CUTMIX_PROB 0.5, nuScenes source with 10 sweeps and
    gt_sampling, KITTI target under CLASS_MAPPING Car -> car). JAX's raises
    on the first mixed sample (nuScenes' 9 box and 5 point columns beside
    KITTI's 7 and 4); given JAX's domains the 7 box columns and the 4
    point columns the port's mixer takes, mixed and plain samples equal
    the port's."""
    from test_torch_toda_real import assert_sample_equal, j_trimmed

    jc = stage1_cfg(JEDict, j_cfg_from_yaml_file, data)
    np.random.seed(0)
    j = j_build_dataset(jc.DATA_CONFIG, jc.CLASS_NAMES, training=True)
    j_trimmed(j.source), j_trimmed(j.target)
    np.random.seed(2)
    with pytest.raises(ValueError, match="dimension"):
        for i in range(len(j)):
            j[i]
    out = []
    for cls, loader, build in ((JEDict, j_cfg_from_yaml_file, j_build_dataset),
                               (EDict, cfg_from_yaml_file, build_dataset)):
        c = stage1_cfg(cls, loader, data)
        np.random.seed(0)
        ds = build(c.DATA_CONFIG, c.CLASS_NAMES, training=True)
        if cls is JEDict:
            j_four_columns(j_trimmed(ds.source)), j_trimmed(ds.target)
        ds.train_percent = 0.5
        np.random.seed(2)
        out.append([ds[i % len(ds)] for i in range(8)])
    assert len(ds.target) == 4 and len(ds) == len(ds.source) + 4
    for g, w in zip(out[1], out[0]):
        assert_sample_equal(g, w)
        assert g["gt_boxes"].shape == (128, 8)
        assert set(np.unique(g["gt_boxes"][:, -1])) <= {0.0, 1.0}


def test_stage1_cli_and_test_on_kitti(data, tmp_path, monkeypatch):
    """The stage-1 CLI on the stage config's domains with a tiny
    SECOND-IoU (``chip_smoke.second_tiny``'s widths, one class), its
    target-domain eval on KITTI val, then ``test`` with ``--save_to_file``
    on its checkpoint, through the mains on the CPU: both results carry
    the car AP_R40 of bbox, bev, 3d and AOS at the three difficulties,
    finite; the label files are written; the test result is the port's
    ``KittiDataset.evaluation`` of the detections it saved (whose
    agreement with JAX's is ``test_evaluation_on_val_split_equals_jax``)."""
    monkeypatch.setattr(port_cfg, "ROOT_DIR", tmp_path)
    c = stage1_cfg(EDict, cfg_from_yaml_file, data)
    tiny = chip_smoke.second_tiny(cfg_from_yaml_file(SECOND_IOU, EDict()), True)
    c.MODEL.BACKBONE_3D, c.MODEL.BACKBONE_2D = tiny.MODEL.BACKBONE_3D, tiny.MODEL.BACKBONE_2D
    c.MODEL.ROI_HEAD.SHARED_FC = [32, 32]
    out = {k: v for k, v in chip_smoke.plain_cfg(c).items()
           if k not in ("ROOT_DIR", "LOCAL_RANK", "TAG", "EXP_GROUP_PATH")}
    path = tmp_path / "cfgs" / "kitti" / "stage1.yaml"
    path.parent.mkdir(parents=True)
    path.write_text(yaml.safe_dump(out))
    dev, tag = ["--device", "cpu", "--batch_size", "2"], "kitti"
    np.random.seed(0)
    res1 = stage1_cutmix_train.main(["--cfg_file", str(path), "--extra_tag", tag,
                                     "--epochs", "1", *dev])
    run = tmp_path / "output" / "kitti" / "stage1" / tag
    result = test_cli.main(["--cfg_file", str(path), "--ckpt",
                            str(run / "ckpt" / "checkpoint_epoch_1.pth"), "--extra_tag", tag,
                            "--save_to_file", *dev])
    keys = {f"car_{m}_{d}_R40" for m in ("bbox", "aos", "bev", "3d")
            for d in ("easy", "moderate", "hard")} | {"mAP_3d_moderate"}
    for res in (res1, result):
        assert keys <= set(res) and all(np.isfinite(res[k]) for k in keys)
    labels = sorted(p.name for p in (run / "eval" / "epoch_1" / "final_result" / "data")
                    .iterdir())
    assert labels == [f"{i:06d}.txt" for i in range(4, 8)]
    with open(run / "eval" / "epoch_1" / "result.pkl", "rb") as f:
        det_annos = pickle.load(f)
    assert len(det_annos) == 4 and all("bbox" in a for a in det_annos if len(a["score"]))
    val = build_dataset(c.DATA_CONFIG_TEST, ["car"], training=False)
    _, want = val.evaluation(det_annos, ["car"])
    assert_equal({k: result[k] for k in want}, want)
