"""The port's ``gt_sampling`` (``toda_tpu_torch/datasets/augmentor/
database_sampler.py``) against the JAX package's, and the gt-database
repair.

Databases come from a tiny fabricated nuScenes tree
(``chip_smoke.fabricate_nuscenes``): JAX's builder (points inline, relative
to the box centre), the port's (``create_infos nuscenes --with_gt_db``: one
box-relative ``.bin`` per object and a ``path`` key) and the port's
consolidated into one ``.npy`` read through mmap. Both samplers, under the
same numpy seed, on the same scenes, give equal outputs on each database:
pools after PREPARE (filter_by_min_points, filter_by_difficulty),
LIMIT_WHOLE_SCENE, the collision rejection against the scene's and the
accepted boxes, the background carve-out. The repair: JAX's sampler adds
the box centre back only to ``path`` entries, so JAX's own database is
pasted at the sensor (no pasted point in its box), while the port's is
pasted in the boxes by either sampler. A pin, not a repair: the Waymo
dataset config's ``SAMPLE_GROUPS: ['Vehicle:15']`` under the stage configs'
``CLASS_NAMES: ['car']`` samples nothing in either package.
"""

import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from toda_tpu.config import EDict as JEDict
from toda_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from toda_tpu.datasets import build_dataset as j_build_dataset
from toda_tpu.datasets.augmentor.database_sampler import DataBaseSampler as JSampler
from toda_tpu.datasets.augmentor.database_sampler import (
    consolidate_gt_database as j_consolidate,
)
from toda_tpu.utils import common_utils as j_common
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.datasets.augmentor.database_sampler import (
    DataBaseSampler,
    consolidate_gt_database,
)
from toda_tpu_torch.tools import create_infos
from toda_tpu_torch.utils import box_utils, common_utils

torch.set_num_threads(1)
CLASSES = ["car", "truck", "pedestrian", "barrier"]


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """{kind: (root, dbinfos name, extra sampler keys)} for the JAX-built,
    port-built and consolidated databases of one fabricated tree."""
    root = tmp_path_factory.mktemp("gt_db")
    chip_smoke.fabricate_nuscenes(root, scenes=3, samples_per_scene=3, sweeps=2, azimuths=128)
    create_infos.main(["nuscenes", "--data_path", str(root), "--version",
                       chip_smoke.NUS_VERSION, "--max_sweeps", "2", "--with_gt_db",
                       "--classes", ",".join(CLASSES)])
    cfg = j_cfg_from_yaml_file("tools/cfgs/dataset_configs/nuscenes_dataset.yaml", JEDict())
    cfg.update(DATA_PATH=str(root), MAX_SWEEPS=2, SHIFT_COOR=None, FILTER_MIN_POINTS_IN_GT=0,
               BALANCED_RESAMPLING=False, DATA_AUGMENTOR=None,
               INFO_PATH={"train": [], "test": ["nuscenes_infos_2sweeps_train.pkl"]})
    j_build_dataset(cfg, CLASSES, training=False).create_groundtruth_database(
        out_path=root / "jax_dbinfos.pkl")
    # the consolidate CLI with its default flags, on the database the port built
    create_infos.main(["consolidate", "--data_path", str(root), "--dbinfos",
                       str(root / "nuscenes_dbinfos_2sweeps.pkl")])
    return {
        "inline": (root, "jax_dbinfos.pkl", {}),
        "path": (root, "nuscenes_dbinfos_2sweeps.pkl", {}),
        "consolidated": (root, "nuscenes_dbinfos_2sweeps_shared.pkl",
                         {"USE_SHARED_MEMORY": True,
                          "DB_DATA_PATH": ["nuscenes_dbinfos_2sweeps.npy"]}),
    }


def sampler_cfg(cls, db, groups, limit=False, prepare=None, **extra):
    return cls({"NAME": "gt_sampling", "DB_INFO_PATH": [db], "SAMPLE_GROUPS": groups,
                "PREPARE": prepare or {"filter_by_min_points": ["car:5", "pedestrian:3"],
                                       "filter_by_difficulty": [-1]},
                "NUM_POINT_FEATURES": 5, "LIMIT_WHOLE_SCENE": limit, **extra})


def scene(seed, boxes=None, names=None):
    """Ground points around the sensor (x, y, z, intensity, time) and the
    given boxes (9 columns, velocity zero)."""
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-40, 40, (3000, 2)), rng.normal(-1.8, 0.02, (3000, 1)),
                          rng.uniform(0, 50, (3000, 1)), np.zeros((3000, 1))],
                         1).astype(np.float32)
    boxes = np.zeros((0, 9), np.float32) if boxes is None else boxes
    return {"points": pts, "gt_boxes": boxes.astype(np.float32),
            "gt_names": np.asarray([] if names is None else names)}


def run_both(root, db, groups, data, limit=False, extra=None, seed=7, calls=3):
    """The same scene through both samplers ``calls`` times (the pools'
    pointers move on) after one numpy seed: (JAX's outputs, the port's),
    and the port's sampler."""
    outs = []
    for cls, sampler_cls in ((JEDict, JSampler), (EDict, DataBaseSampler)):
        sampler = sampler_cls(root, sampler_cfg(cls, db, groups, limit, **(extra or {})),
                              CLASSES)
        np.random.seed(seed)
        outs.append([sampler({k: v.copy() for k, v in data.items()}) for _ in range(calls)])
    return outs, sampler


def assert_outputs_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def pasted(out, data):
    """(the pasted objects' points, how many lie in a pasted box) of a
    sampler output: they come first, before the scene's points left after
    the carve-out."""
    new = out["gt_boxes"][len(data["gt_boxes"]):, :7]
    kept = box_utils.remove_points_in_boxes3d(data["points"], new)
    obj = out["points"][:len(out["points"]) - len(kept)]
    np.testing.assert_array_equal(out["points"][len(obj):], kept)
    return obj, int(box_utils.points_in_boxes_numpy(obj, new).any(0).sum())


@pytest.mark.parametrize("kind", ["inline", "path", "consolidated"])
def test_sampler_outputs_equal_jax(dbs, kind):
    """Each database through both samplers: pools after PREPARE equal, and
    three calls (points, boxes, names) equal."""
    root, db, extra = dbs[kind]
    (want, got), sampler = run_both(root, db, ["car:6", "pedestrian:2", "truck:1"], scene(1),
                                    extra=extra)
    j = JSampler(root, sampler_cfg(JEDict, db, ["car:6"]), CLASSES)
    for name in CLASSES:
        assert [i["box3d_lidar"].tolist() for i in sampler.db_infos[name]] \
            == [i["box3d_lidar"].tolist() for i in j.db_infos[name]]
    assert all(i["num_points_in_gt"] >= 5 for i in sampler.db_infos["car"])
    for g, w in zip(got, want):
        assert_outputs_equal(g, w)
    assert sum(len(o["gt_boxes"]) for o in got) > 6


def test_consolidated_equals_path_database(dbs):
    """The mmap read of the consolidated ``.npy`` gives the ``.bin`` files'
    points: the same sampler outputs from both forms. The CLI's default
    flags keep all five columns the port's builder writes, objects of any
    point count included; an explicit width keeps that many."""
    root, db, _ = dbs["path"]
    _, cdb, extra = dbs["consolidated"]
    with open(root / db, "rb") as f:
        counts = [i["num_points_in_gt"] for v in pickle.load(f).values() for i in v]
    assert any(n % 4 for n in counts) and np.load(root / extra["DB_DATA_PATH"][0]).shape == (
        sum(counts), 5)
    npy4, _ = consolidate_gt_database(root / db, root, out_npy=root / "p4.npy",
                                      out_pkl=root / "p4.pkl", num_point_features=4)
    np.testing.assert_array_equal(np.load(npy4), np.load(root / extra["DB_DATA_PATH"][0])[:, :4])
    outs = []
    for d, ex in ((db, {}), (cdb, extra)):
        s = DataBaseSampler(root, sampler_cfg(EDict, d, ["car:6"], **ex), CLASSES)
        np.random.seed(3)
        outs.append(s(scene(3)))
    assert_outputs_equal(outs[1], outs[0])
    assert len(outs[0]["gt_boxes"]) > 0
    j_npy, _ = j_consolidate(root / db, root, out_npy=root / "j.npy", out_pkl=root / "j.pkl",
                             num_point_features=5)
    np.testing.assert_array_equal(np.load(j_npy), np.load(root / extra["DB_DATA_PATH"][0]))


def test_limit_whole_scene_and_collisions_equal_jax(dbs):
    """LIMIT_WHOLE_SCENE tops the scene's cars up to the group's count; a
    scene whose boxes sit where database boxes lie rejects those samples
    (and the carve-out removes no scene point inside them)."""
    root, db, _ = dbs["path"]
    with open(root / db, "rb") as f:
        cars = pickle.load(f)["car"]
    taken = np.stack([c["box3d_lidar"] for c in cars[:4]])
    data = scene(4, taken, ["car"] * 4)
    for limit in (False, True):
        (want, got), _ = run_both(root, db, ["car:6"], data, limit=limit, calls=4)
        for g, w in zip(got, want):
            assert_outputs_equal(g, w)
        added = [int((o["gt_names"] == "car").sum()) - 4 for o in got]
        if limit:
            assert all(0 <= a <= 2 for a in added) and max(added) > 0
        for o in got:
            new = o["gt_boxes"][4:, :7]
            if len(new):
                iou = box_utils.boxes3d_nearest_bev_iou(new, taken[:, :7])
                assert iou.max() < 1e-3


def test_gt_database_pasted_in_boxes_repair(dbs):
    """The repair: JAX's database through JAX's sampler pastes no point in
    its box (the box-relative points land at the sensor); the port's
    database through JAX's sampler and through the port's pastes every
    object's points in its box, with equal outputs."""
    root, jdb, _ = dbs["inline"]
    _, pdb, _ = dbs["path"]
    data = scene(5)
    (jax_inline, _), _ = run_both(root, jdb, ["car:6"], data, calls=1)
    obj, inside = pasted(jax_inline[0], data)
    assert len(jax_inline[0]["gt_boxes"]) >= 3 and len(obj) > 50 and inside == 0
    assert np.abs(obj[:, :2]).mean() < 3.0
    (jax_path, port_path), _ = run_both(root, pdb, ["car:6"], data, calls=1)
    assert_outputs_equal(port_path[0], jax_path[0])
    obj, inside = pasted(port_path[0], data)
    assert len(port_path[0]["gt_boxes"]) >= 3 and len(obj) > 50 and inside == len(obj)


def test_waymo_vehicle_groups_sample_nothing_under_car(tmp_path):
    """A pin of the reference, not a repair: the Waymo config's
    ``SAMPLE_GROUPS: ['Vehicle:15']`` keys its pool by class name, and the
    stage configs train ``CLASS_NAMES: ['car']`` (CLASS_MAPPING renames
    Vehicle after the draw), so neither package's sampler draws an
    object; with ``Vehicle`` in the class list both do."""
    chip_smoke.fabricate_waymo(tmp_path / "raw", sequences=1, frames=2, rows=16, cols=256)
    create_infos.main(["waymo", "--data_path", str(tmp_path / "raw"), "--save_path",
                       str(tmp_path), "--with_gt_db", "--classes", "Vehicle,Pedestrian,Cyclist"])
    data = scene(6)
    for cls, loader, sampler_cls in ((JEDict, j_cfg_from_yaml_file, JSampler),
                                     (EDict, cfg_from_yaml_file, DataBaseSampler)):
        c = loader("tools/cfgs/dataset_configs/waymo_dataset.yaml", cls())
        sc = c.DATA_AUGMENTOR.AUG_CONFIG_LIST[0]
        for classes, drawn in ((["car"], False), (["Vehicle"], True)):
            np.random.seed(0)
            s = sampler_cls(tmp_path, sc, classes)
            out = s({k: v.copy() for k, v in data.items()})
            assert (len(out["gt_boxes"]) > 0) == drawn, classes
            assert bool(s.sample_groups) == drawn


def test_shm_cache_file_equals_jax(tmp_path):
    """The /dev/shm staging of a consolidated database (here in a temporary
    directory): the leader copies and publishes, a second call returns
    the published copy, which holds the bytes JAX's copy holds, and
    ``shm_cache_clear`` removes it. The port names its copy by the source's
    path and modification time: a rewritten source, or a file of the same
    name elsewhere, is staged anew, where JAX's serves the stale copy."""
    src = tmp_path / "db.npy"
    np.save(src, np.arange(12, dtype=np.float32).reshape(4, 3))
    staged = {}
    for mod, d in ((common_utils, tmp_path / "p"), (j_common, tmp_path / "j")):
        dst = mod.shm_cache_file(src, shm_dir=d)
        assert dst.parent == d and mod.shm_cache_file(src, shm_dir=d) == dst
        np.testing.assert_array_equal(np.load(dst), np.load(src))
        staged[mod] = dst
    assert staged[common_utils].read_bytes() == staged[j_common].read_bytes()

    other = tmp_path / "other" / "db.npy"
    other.parent.mkdir()
    np.save(other, np.ones((2, 3), np.float32))
    np.save(src, np.full((5, 3), 7, np.float32))
    for path in (other, src):
        dst = common_utils.shm_cache_file(path, shm_dir=tmp_path / "p")
        np.testing.assert_array_equal(np.load(dst), np.load(path))
    assert len(list((tmp_path / "p").glob("db-*.npy"))) == 3
    assert np.load(j_common.shm_cache_file(src, shm_dir=tmp_path / "j")).shape == (4, 3)
    for mod, d in ((common_utils, tmp_path / "p"), (j_common, tmp_path / "j")):
        mod.shm_cache_clear(d)
        assert not d.exists()
