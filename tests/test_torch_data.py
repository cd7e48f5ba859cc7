"""The PyTorch port's host side against the JAX package's: config loading,
the synthetic test-mode batches, and the eval harness (recall, mAP,
eval_one_epoch's bookkeeping) on the same detections. Exact equality unless
stated."""

from types import SimpleNamespace

import numpy as np
import torch

from toda_tpu.config import EDict as JEDict
from toda_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from toda_tpu.datasets import build_dataloader as j_build_dataloader
from toda_tpu.runtime import eval_utils as j_eval
from toda_tpu.utils.eval_utils import eval_map as j_eval_map
from toda_tpu_torch.config import EDict, cfg_from_yaml_file
from toda_tpu_torch.datasets import build_dataloader
from toda_tpu_torch.runtime import eval_utils
from toda_tpu_torch.utils.eval_utils import eval_map

# One torch thread per process: pytest-xdist's workers already share every
# core, and OpenMP threads waiting on a busy core waste it.
torch.set_num_threads(1)

CFG = "tools/cfgs/synthetic_models/centerpoint_synthetic.yaml"


def plain(d):
    if isinstance(d, dict):
        return {k: plain(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [plain(v) for v in d]
    return d


def small(cfg):
    d = cfg.DATA_CONFIG
    d.POINT_CLOUD_RANGE = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
    d.DATA_PROCESSOR[2].NUM_POINTS = {"train": 1024, "test": 1024}
    d.DATA_PROCESSOR[3].VOXEL_SIZE = [0.5, 0.5, 0.5]
    d.NUM_SCENES = 6
    d.NUM_OBJECTS = [2, 4]
    return cfg


def both_cfgs():
    return (small(j_cfg_from_yaml_file(CFG, JEDict())),
            small(cfg_from_yaml_file(CFG, EDict())))


def test_config_loader_matches_jax():
    jcfg = j_cfg_from_yaml_file(CFG, JEDict())
    pcfg = cfg_from_yaml_file(CFG, EDict())
    assert plain(pcfg) == plain(jcfg)
    assert pcfg.DATA_CONFIG.DATASET == "SyntheticDataset"  # via _BASE_CONFIG_


def test_test_mode_batches_equal_jax():
    """Same scenes, same sampling draws (the global numpy RNG, seeded alike),
    same padding and collation."""
    jcfg, pcfg = both_cfgs()
    np.random.seed(0)
    _, jloader, _ = j_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size=2,
                                       training=False)
    jbatches = list(jloader)
    np.random.seed(0)
    ds, loader, _ = build_dataloader(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES, batch_size=2)
    pbatches = list(loader)
    assert len(pbatches) == len(jbatches) == 3
    for jb, pb in zip(jbatches, pbatches):
        assert set(jb) == set(pb)
        for k in jb:
            if isinstance(jb[k], np.ndarray):
                assert jb[k].dtype == pb[k].dtype, k
                np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
            else:
                assert pb[k] == jb[k], k
    assert pbatches[0]["points"].shape == (2, 1024, 4)
    assert tuple(ds.grid_size) == (64, 64, 8)


def test_training_batches_equal_jax():
    """Training mode: the same shuffled frames, augmentation draws
    (flip, rotation, scaling from the global numpy RNG, seeded alike) and
    their (B, 7) ``aug_vector``, outside-box removal, point sampling and
    padding; the training loader drops the last partial batch."""
    jcfg, pcfg = both_cfgs()
    np.random.seed(0)
    _, jloader, _ = j_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size=4,
                                       training=True)
    jbatches = list(jloader)
    np.random.seed(0)
    _, loader, _ = build_dataloader(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES, batch_size=4,
                                    training=True)
    pbatches = list(loader)
    assert len(pbatches) == len(jbatches) == 1
    for jb, pb in zip(jbatches, pbatches):
        assert set(pb) == set(jb)
        for k in ("points", "points_mask", "gt_boxes", "aug_vector"):
            assert jb[k].dtype == pb[k].dtype, k
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        assert pb["frame_id"] == jb["frame_id"]
        assert pb["augmentation_params"] == jb["augmentation_params"]
        assert (pb["gt_boxes"][..., -1] > 0).any()


def _fake_dets(rng, scenes, names, k=12):
    """Detections near each scene's gt boxes plus clutter: (B, k, 7) boxes,
    scores, labels, mask."""
    b = len(scenes)
    boxes = np.zeros((b, k, 7), np.float32)
    labels = np.zeros((b, k), np.int64)
    for i, (_, g, gnames) in enumerate(scenes):
        n = min(len(g), k // 2)
        boxes[i, :n] = g[:n, :7] + rng.normal(0, 0.2, (n, 7)).astype(np.float32)
        labels[i, :n] = [names.index(c) + 1 for c in gnames[:n]]
        boxes[i, n:, :2] = rng.uniform(-15, 15, (k - n, 2))
        boxes[i, n:, 3:6] = rng.uniform(0.5, 4, (k - n, 3))
        labels[i, n:] = rng.randint(1, 3, k - n)
    scores = rng.uniform(0.1, 1, (b, k)).astype(np.float32)
    mask = rng.uniform(size=(b, k)) > 0.2
    return {"pred_boxes": boxes, "pred_scores": scores * mask, "pred_labels": labels * mask,
            "pred_mask": mask}


def test_eval_one_epoch_matches_jax_on_the_same_detections():
    """Recall counters, the synthetic mAP and the annotation dicts equal
    JAX's eval_one_epoch fed the same detections (made from each batch's
    scenes, which both loaders visit in order)."""
    jcfg, pcfg = both_cfgs()
    bundle = SimpleNamespace(post_cfg={"RECALL_THRESH_LIST": [0.3, 0.5, 0.7]})

    def fake_step(ds, names):
        rng, calls = np.random.RandomState(7), iter(range(len(ds)))

        def step():
            b = next(calls)
            return _fake_dets(rng, [ds.get_raw_scene(2 * b + i) for i in range(2)], names)

        return step

    np.random.seed(0)
    jds, jloader, _ = j_build_dataloader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size=2,
                                         training=False)
    jstep = fake_step(jds, jcfg.CLASS_NAMES)
    jres, jannos = j_eval.eval_one_epoch(bundle, None, jloader, jds, jcfg.CLASS_NAMES,
                                         predict_step=lambda variables, arrays: jstep())
    np.random.seed(0)
    ds, loader, _ = build_dataloader(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES, batch_size=2)
    pstep = fake_step(ds, pcfg.CLASS_NAMES)
    pres, pannos = eval_utils.eval_one_epoch(
        bundle, loader, ds, pcfg.CLASS_NAMES,
        predict_step=lambda batch: {k: torch.from_numpy(v) for k, v in pstep().items()})
    for k, v in jres.items():
        if k not in ("sec_per_example", "compile_sec"):
            assert pres[k] == v, k
    assert pres["mAP"] > 0 and pres["recall/0.3"] > 0
    assert len(pannos) == len(jannos) == 6
    for pa, ja in zip(pannos, jannos):
        assert set(pa) == set(ja)
        for k in ja:
            np.testing.assert_array_equal(np.asarray(pa[k]), np.asarray(ja[k]), err_msg=k)


def test_eval_map_and_recall_match_jax():
    rng = np.random.RandomState(3)
    names = ["car", "pedestrian"]
    dets, gts = [], []
    for _ in range(4):
        g = np.concatenate([rng.uniform(-10, 10, (5, 2)), rng.uniform(-1, 1, (5, 1)),
                            rng.uniform(1, 4, (5, 3)), rng.uniform(-3, 3, (5, 1))], 1)
        gts.append({"boxes_lidar": g.astype(np.float32),
                    "name": np.array(names)[rng.randint(0, 2, 5)]})
        d = g + rng.normal(0, 0.3, g.shape)
        dets.append({"boxes_lidar": d.astype(np.float32), "name": gts[-1]["name"],
                     "score": rng.uniform(0, 1, 5).astype(np.float32)})
    assert eval_map(dets, gts, names) == j_eval_map(dets, gts, names)
    gt_boxes = np.concatenate([gts[0]["boxes_lidar"], np.ones((5, 1), np.float32)], 1)
    mask = np.array([1, 1, 0, 1, 1], bool)
    assert eval_utils.compute_recall(dets[0]["boxes_lidar"], mask, gt_boxes, [0.3, 0.5, 0.7]) \
        == j_eval.compute_recall(dets[0]["boxes_lidar"], mask, gt_boxes, [0.3, 0.5, 0.7])
