"""The port's Waymo path (``toda_tpu_torch/datasets/waymo``) against the JAX
package's on the same files.

Tiny ``.tfrecord`` sequences from ``chip_smoke.fabricate_waymo`` (a 16 x 256
range image a frame, ray-cast, with a per-pixel pose) go through both
packages: the TFRecord framing and its CRC, ``range_image_to_points`` with
and without the per-pixel pose, ``create_waymo_infos`` (infos and ``.npy``
files) and ``WaymoDataset`` test and training batches of
``tools/cfgs/dataset_configs/waymo_dataset.yaml`` (SAMPLED_INTERVAL,
gt_sampling over the port-built database), all exactly equal. The port's
``crc32c`` takes long buffers through numpy lanes: held to the byte loop.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from toda_tpu.config import EDict as JEDict
from toda_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from toda_tpu.datasets import build_dataloader as j_build_dataloader
from toda_tpu.datasets.waymo import tfrecord_io as j_tio
from toda_tpu.datasets.waymo.waymo_dataset import create_waymo_infos as j_create_waymo_infos
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.datasets import build_dataloader, build_dataset
from toda_tpu_torch.datasets.waymo import tfrecord_io as tio
from toda_tpu_torch.datasets.waymo.waymo_dataset import create_waymo_infos
from toda_tpu_torch.tools import create_infos

torch.set_num_threads(1)
CLASSES = ["Vehicle", "Pedestrian", "Cyclist"]


def assert_tree_equal(got, want, path="."):
    assert type(got) is type(want), path
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
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo")
    stats = chip_smoke.fabricate_waymo(root / "raw", sequences=2, frames=5, rows=16, cols=256)
    assert stats["frames"] == 10 and stats["points"] > 10 * 1000
    return root


def test_tfrecord_round_trip_and_crc(tmp_path):
    """Records written by the port read back in both packages with their
    CRCs checked; the lane CRC equals the byte loop (and the standard
    crc32c check value) on buffers around its threshold."""
    recs = [b"", b"frame", os.urandom(70_001), os.urandom(200_000)]
    tio.write_tfrecords(tmp_path / "a.tfrecord", recs)
    assert list(tio.read_tfrecords(tmp_path / "a.tfrecord", check_crc=True)) == recs
    assert list(j_tio.read_tfrecords(tmp_path / "a.tfrecord", check_crc=True)) == recs
    assert tio.crc32c(b"123456789") == 0xE3069283
    for n in (tio._LANE_MIN_BYTES - 1, tio._LANE_MIN_BYTES, tio._LANE_MIN_BYTES + 1023,
              3 * tio._LANES * 61 + 17):
        buf = os.urandom(n)
        assert tio.crc32c(buf) == j_tio.crc32c(buf) == tio._crc_update(0xFFFFFFFF, buf) \
            ^ 0xFFFFFFFF, n
        assert tio.masked_crc(buf) == j_tio.masked_crc(buf)


@pytest.mark.parametrize("pixel_pose", [False, True])
def test_range_image_to_points_equals_jax(pixel_pose):
    """A random range image (30% empty pixels), a rotated extrinsic, the
    beam list and the uniform fill; with a per-pixel pose of varying
    roll, pitch, yaw and translation."""
    rng = np.random.RandomState(3)
    ri = rng.uniform(0.5, 60, (8, 32, 4)).astype(np.float32)
    ri[..., 0] *= rng.rand(8, 32) > 0.3
    c, s = np.cos(0.3), np.sin(0.3)
    ext = np.array([[c, -s, 0, 1.4], [s, c, 0, 0.1], [0, 0, 1, 2.2], [0, 0, 0, 1]])
    kw = {}
    if pixel_pose:
        pose = rng.normal(0, 0.05, (8, 32, 6)).astype(np.float32)
        pose[..., 3:] += [100.0, -50.0, 1.0]
        kw = dict(pixel_pose=pose, frame_pose=chip_smoke._pose((100.0, -50.0, 1.0), 0.02))
    for incl in (dict(beam_inclinations=np.sort(rng.uniform(-0.3, 0.05, 8))),
                 dict(inclination_range=(-0.3, 0.05))):
        got = tio.range_image_to_points(ri, ext, **incl, **kw)
        want = j_tio.range_image_to_points(ri, ext, **incl, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert len(got[0]) == int((ri[..., 0] > 0).sum())


def test_create_waymo_infos_equals_jax(raw, tmp_path):
    """Both packages extract the fabricated sequences (every frame, then
    every second): equal infos and equal ``.npy`` point files."""
    for interval in (1, 2):
        got = create_waymo_infos(raw / "raw", tmp_path / f"p{interval}",
                                 sampled_interval=interval)
        want = j_create_waymo_infos(raw / "raw", tmp_path / f"j{interval}",
                                    sampled_interval=interval)
        assert len(got) == 2 * -(-5 // interval)
        assert_tree_equal(got, want)
        for info in got:
            seq, idx = info["point_cloud"]["lidar_sequence"], info["point_cloud"]["sample_idx"]
            a = np.load(tmp_path / f"p{interval}" / seq / f"{idx:04d}.npy")
            b = np.load(tmp_path / f"j{interval}" / seq / f"{idx:04d}.npy")
            assert a.shape[1] == 6 and len(a) > 1000
            np.testing.assert_array_equal(a, b)
    labels = got[0]["annos"]
    assert set(labels["name"]) <= set(CLASSES) and len(labels["name"]) > 5


def waymo_cfg(cls, loader, root):
    c = loader("tools/cfgs/dataset_configs/waymo_dataset.yaml", cls())
    c.DATA_PATH = str(root)
    c.SAMPLED_INTERVAL = {"train": 2, "test": 1}
    c.INFO_PATH = {"train": ["waymo_infos_train.pkl"], "test": ["waymo_infos_train.pkl"]}
    c.DATA_PROCESSOR[2].NUM_POINTS = {"train": 4096, "test": 4096}
    return c


def test_waymo_dataset_batches_equal_jax(raw):
    """``create_infos waymo --with_gt_db`` (the port's CLI), then the
    dataset config's test batches and its training batches
    (gt_sampling of the port-built database, flips, rotation, scaling,
    shuffled points) from both packages' loaders under one numpy seed;
    ``evaluation`` is not ported and says so."""
    create_infos.main(["waymo", "--data_path", str(raw / "raw"), "--save_path", str(raw),
                       "--with_gt_db", "--classes", ",".join(CLASSES)])
    with open(raw / "waymo_dbinfos_train.pkl", "rb") as f:
        db = pickle.load(f)
    assert len(db["Vehicle"]) > 10 and all("path" in i for i in db["Vehicle"])
    for training in (False, True):
        batches = []
        for cls, loader, build in ((JEDict, j_cfg_from_yaml_file, j_build_dataloader),
                                   (EDict, cfg_from_yaml_file, build_dataloader)):
            np.random.seed(11)
            ds, it, _ = build(waymo_cfg(cls, loader, raw), CLASSES, batch_size=2,
                              training=training)
            assert len(ds) == (5 if training else 10)
            batches.append(list(it))
        want, got = batches
        assert len(got) == len(want) == (2 if training else 5)
        for g, w in zip(got, want):
            assert_tree_equal(g, w)
        assert all(b["gt_boxes"].shape[-1] == 8 for b in got)
    ds = build_dataset(waymo_cfg(EDict, cfg_from_yaml_file, raw), CLASSES)
    with pytest.raises(NotImplementedError, match="not ported"):
        ds.evaluation([], CLASSES)
