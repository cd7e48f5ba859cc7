"""The TODA stages' host data path: the PyTorch port against the JAX package
on the same seeds, exactly.

Each inter-domain mixer (CutMix, PolarMix with its width schedules, LaserMix
in its region forms, PseudoMix) and the intra-domain MixUp with and without
collision detection, from the same scenes and the same RandomState; the
stage-1 ``CutMixDataset`` and stage-2 ``MixUpDataset`` samples (pseudo
infos with per-point and voxel-keyed perturbations), the ``CLPairDataset``
dual batches with their ``aug_vector``s, under one global numpy seed; and
the pseudo-label helpers ``voxelize_perturb``, ``lookup_voxel_perturb`` and
``filter_min_points_boxes``.
"""

import numpy as np
import pytest
import torch
import yaml

from toda_tpu.config import EDict as JEDict
from toda_tpu.datasets import build_dataset as j_build_dataset
from toda_tpu.datasets.dataset_cl import CLPairDataset as JCLPairDataset
from toda_tpu.datasets.processor import inter_domain_mix as j_mix
from toda_tpu.datasets.processor import intra_domain_mixup as j_mixup
from toda_tpu.datasets.synthetic.synthetic_dataset import make_scene
from toda_tpu.runtime import pseudo_label as j_pl
from toda_tpu_torch.config import EDict
from toda_tpu_torch.datasets import build_dataset
from toda_tpu_torch.datasets.dataset_cl import CLPairDataset
from toda_tpu_torch.datasets.processor import inter_domain_mix, intra_domain_mixup
from toda_tpu_torch.runtime import pseudo_label

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)

CLASS_NAMES = ["car", "pedestrian"]
PC_RANGE = [-20.0, -20.0, -3.0, 20.0, 20.0, 1.0]


def scenes(seed):
    """A source and a target scene (the synthetic generator of the JAX
    package; the port's draws the same)."""
    rng = np.random.RandomState(seed)
    out = []
    for n_bg in (1500, 1200):
        p, b, n = make_scene(rng, CLASS_NAMES, PC_RANGE, num_objects=(3, 6),
                             num_background=n_bg)
        out.append({"points": p, "gt_boxes": b, "gt_names": n})
    return out


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


MIXES = {
    "cutmix": ("cutmix", dict(pc_range=np.asarray(PC_RANGE), min_points=300)),
    "cutmix_no_range": ("cutmix", dict(min_points=10**6, max_tries=5)),
    "polarmix_fix": ("polarmix", dict()),
    "polarmix_asc_three_sectors": ("polarmix", dict(
        train_percent=0.6, width_method=["ASC", "ASC_SIG", "DESC"], rot_copy_num=3)),
    "polarmix_rand_dis_corner_pitch": ("polarmix", dict(
        width_method="RAND", polar_dis="RAND", range_max=20.0, inc_method="corner_del",
        use_pitch=True, rot_copy_num=2)),
    "polarmix_corner": ("polarmix", dict(width_method="FIX", inc_method="corner")),
    "lasermix_spherical": ("lasermix", dict()),
    "lasermix_cylindrical": ("lasermix", dict(mode="cylindrical", range_max=20.0)),
    "lasermix_angles_corner_del": ("lasermix", dict(
        num_areas=[3, 4, 5], num_angles=6, range_max=20.0, inc_method="corner_del")),
    "lasermix_pitch_degrees": ("lasermix", dict(num_areas=4, pitch_angles_deg=[-30, 10])),
    "pseudobbox": ("pseudomix", dict(method="pseudobbox")),
    "pseudobackground": ("pseudomix", dict(method="pseudobackground")),
}


@pytest.mark.parametrize("case", sorted(MIXES))
def test_inter_domain_mixers_equal_jax(case):
    """Each stage-1 mixer on the same (source, target) pair with the same
    RandomState: the same points, boxes and names, in the same order."""
    fn, kw = MIXES[case]
    src, tgt = scenes(1)
    want = getattr(j_mix, fn)(src, tgt, rng=np.random.RandomState(2), **kw)
    got = getattr(inter_domain_mix, fn)(src, tgt, rng=np.random.RandomState(2), **kw)
    assert len(got["points"]) > 0
    assert_same(got, want)


@pytest.mark.parametrize("fn", ["intra_domain_point_mixup", "intra_domain_point_mixup_cd"])
def test_intra_domain_mixup_equals_jax(fn):
    """Stage-2 MixUp of two scenes, with and without collision detection
    (a box of B placed on one of A's so that the collision path drops it
    and its points)."""
    a, b = scenes(3)
    b = dict(b, gt_boxes=np.concatenate([b["gt_boxes"], a["gt_boxes"][:1]]),
             gt_names=np.concatenate([b["gt_names"], a["gt_names"][:1]]))
    want = getattr(j_mixup, fn)(a, b, alpha=1.0, rng=np.random.RandomState(4))
    got = getattr(intra_domain_mixup, fn)(a, b, alpha=1.0, rng=np.random.RandomState(4))
    assert_same(got, want)


def ds_cfg(cls, seed, **extra):
    with open("tools/cfgs/dataset_configs/synthetic_dataset.yaml") as f:
        raw = yaml.safe_load(f)
    raw.update(POINT_CLOUD_RANGE=PC_RANGE, NUM_SCENES=3, NUM_OBJECTS=[2, 4], SEED=seed,
               TEST_SEED_OFFSET=0, NUM_BACKGROUND_POINTS=1500, MAX_GT_BOXES=16, **extra)
    raw["DATA_PROCESSOR"][2]["NUM_POINTS"] = {"train": 2048, "test": 2048}
    return cls(raw)


def cutmix_cfg(cls):
    cfg = ds_cfg(cls, 0, DATASET="CutMixDataset", MIX_TYPE="cutmix", CUTMIX_PROB=0.5,
                 CUTMIX_MIN_POINTS=300, CLASS_MAPPING={"pedestrian": "car", "car": "car"})
    cfg.SOURCE_CFG = ds_cfg(cls, 0)
    cfg.TARGET_CFG = ds_cfg(cls, 100)
    return cfg


def assert_same_sample(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def samples(dataset, seed, n):
    np.random.seed(seed)
    return [dataset[i % len(dataset)] for i in range(n)]


def test_cutmix_dataset_samples_equal_jax():
    """``CutMixDataset`` in training mode, mixed and plain samples (the
    seed gives both), the domain augmentors, the class mapping onto 'car'
    and the template's processing: equal arrays and keys."""
    j = j_build_dataset(cutmix_cfg(JEDict), ["car"], training=True)
    p = build_dataset(cutmix_cfg(EDict), ["car"], training=True)
    assert len(p) == len(j) == 6
    jb, pb = samples(j, 5, 6), samples(p, 5, 6)
    assert not any("aug_vector" in s for s in jb)
    for g, w in zip(pb, jb):
        assert_same_sample(g, w)


def pseudo_infos(dataset, rng):
    """Pseudo infos over the dataset's frames: scores around the 0.2
    threshold, a per-point perturbation (frame 0), the voxel-keyed form
    (frame 1) and none (frame 2)."""
    infos = []
    for i in range(len(dataset)):
        pts, boxes, names = dataset.get_raw_scene(i)
        info = {"index": i, "gt_boxes": boxes[:, :7], "gt_names": names,
                "score": rng.uniform(0.0, 0.5, len(boxes)).astype(np.float32)}
        per = np.sign(rng.randn(len(pts), 3)).astype(np.float32)
        if i == 0:
            info["point_perturb"] = per
        elif i == 1:
            info["point_perturb"] = per
            vc, vp = j_pl.voxelize_perturb(pts, per, boxes, voxel_size=(0.25, 0.25, 0.25),
                                           pc_range=PC_RANGE)
            info.update(p_voxel_coords=vc, p_voxel_perturb=vp,
                        p_voxel_size=np.full(3, 0.25, np.float32),
                        p_pc_range=np.asarray(PC_RANGE, np.float32))
        infos.append(info)
    return infos


def mixup_cfg(cls):
    cfg = ds_cfg(cls, 100, DATASET="MixUpDataset", MIXUP_PROB=0.7, GT_PROB=0.3,
                 MIXUP_TYPE="gt+ps_gt+ps", ADV_ALPHA=0.5, PSEUDO_SCORE_THRESH=0.2)
    cfg.BASE_CFG = ds_cfg(cls, 100)
    return cfg


@pytest.fixture(scope="module")
def mixup_pair():
    jbase = j_build_dataset(ds_cfg(JEDict, 100), CLASS_NAMES, training=True)
    infos = pseudo_infos(jbase, np.random.RandomState(6))
    j = j_build_dataset(mixup_cfg(JEDict), CLASS_NAMES, training=True, pseudo_infos=infos)
    p = build_dataset(mixup_cfg(EDict), CLASS_NAMES, training=True, pseudo_infos=infos)
    return j, p


def test_mixup_dataset_samples_equal_jax(mixup_pair):
    """``MixUpDataset`` (the stage-2 config's knobs): plain and mixed
    samples of ground-truth and pseudo frames, pseudo boxes under the
    score threshold dropped, the three perturbation modes with per-point
    and voxel-keyed perturbations; 12 samples cover every branch."""
    j, p = mixup_pair
    jb, pb = samples(j, 7, 12), samples(p, 7, 12)
    for g, w in zip(pb, jb):
        assert_same_sample(g, w)


def test_cl_pair_batches_and_aug_vectors_equal_jax(mixup_pair):
    """``CLPairDataset`` over the MixUp dataset: the collated (adv, org)
    batches, their recorded augmentations and (B, 7) ``aug_vector``s, and
    the org view's replayed parameters with the extra rotation and scaling
    composed in."""
    j, p = mixup_pair
    jcl, pcl = JCLPairDataset(j), CLPairDataset(p)
    np.random.seed(8)
    jb = jcl.collate_batch([jcl[i] for i in range(3)])
    np.random.seed(8)
    pb = pcl.collate_batch([pcl[i] for i in range(3)])
    assert pb["batch_size"] == jb["batch_size"] == 3
    for view in ("adv", "org"):
        assert set(pb[view]) == set(jb[view])
        for k, v in jb[view].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(pb[view][k], v, err_msg=f"{view} {k}")
            else:
                assert pb[view][k] == v, (view, k)
    vec = pb["org"]["aug_vector"]
    assert vec.shape == (3, 7) and (vec[:, 3] != 1.0).all()
    assert not np.array_equal(vec, pb["adv"]["aug_vector"])


def test_aug_vector_equals_jax():
    """Every recorded world augmentation lands in its slot; the rest keep
    the identity (scale 1)."""
    jds = j_build_dataset(ds_cfg(JEDict, 0), CLASS_NAMES, training=True)
    params = [("random_world_flip_x", True), ("random_world_flip_y", False),
              ("random_world_rotation", 0.3), ("random_world_scaling", 1.02),
              ("random_world_translation", [0.1, -0.2, 0.3])]
    from toda_tpu_torch.datasets.dataset import DatasetTemplate

    for sub in (params, params[2:3], []):
        got = DatasetTemplate.aug_vector(sub)
        np.testing.assert_array_equal(got, jds.aug_vector(sub))
        assert got.dtype == np.float32


def test_voxel_perturb_and_min_points_filter_equal_jax():
    """``voxelize_perturb`` (the per-cell means of the perturbations inside
    the pseudo boxes), ``lookup_voxel_perturb`` on resampled and jittered
    points, and ``filter_min_points_boxes`` at several thresholds."""
    rng = np.random.RandomState(9)
    pts = rng.uniform(-10, 10, (800, 4)).astype(np.float32)
    boxes = np.asarray([[0, 0, 0, 6, 6, 20, 0.3], [5, -5, 0, 3, 2, 20, -0.4],
                        [-9, 9, 0, 1, 1, 1, 0]], np.float32)
    per = np.sign(rng.randn(800, 3)).astype(np.float32)
    kw = dict(voxel_size=(0.5, 0.5, 0.5), pc_range=(-12, -12, -12, 12, 12, 12))
    want = j_pl.voxelize_perturb(pts, per, boxes, **kw)
    got = pseudo_label.voxelize_perturb(pts, per, boxes, **kw)
    assert len(got[0]) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    info = {"p_voxel_coords": got[0], "p_voxel_perturb": got[1],
            "p_voxel_size": np.full(3, 0.5, np.float32),
            "p_pc_range": np.full(6, -12, np.float32)}
    query = pts[::2] + rng.uniform(-0.2, 0.2, (400, 4)).astype(np.float32)
    np.testing.assert_array_equal(pseudo_label.lookup_voxel_perturb(query, info),
                                  j_pl.lookup_voxel_perturb(query, info))
    for k in (0, 1, 5, 50):
        np.testing.assert_array_equal(pseudo_label.filter_min_points_boxes(boxes, pts, k),
                                      j_pl.filter_min_points_boxes(boxes, pts, k))
    empty = np.zeros((0, 4), np.float32)
    assert not pseudo_label.filter_min_points_boxes(boxes, empty, 5).any()
