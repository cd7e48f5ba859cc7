"""nuScenes dataset adapter (info-pkl driven), the TODA target domain.

The port's own copy of ``toda_tpu/datasets/nuscenes/nuscenes_dataset.py``.
Info schema (the keys OpenPCDet's tooling writes, so its infos load
directly): each info dict carries
    'lidar_path', 'token', 'sweeps' [{lidar_path, transform_matrix, time_lag}],
    'gt_boxes' (N, 7 or 9 with velocity), 'gt_names', 'num_lidar_pts',
    'gt_attributes'.

Covered: multi-sweep loading with the time-lag channel, SHIFT_COOR,
FILTER_MIN_POINTS_IN_GT, class-balanced resampling (CBGS, from the global
``np.random`` as JAX's), the seeded LABELED_PERCENTAGE subset, the native
nuScenes metric (``utils/nuscenes_eval_native.py``) with velocity-heuristic
detection attributes, and the gt databases for ``gt_sampling``
(``create_groundtruth_database``, ``create_sub_groundtruth_database``).

Two departures from JAX's, both repairs: the gt databases are written as
box-relative ``.bin`` files with a ``path`` key
(``augmentor.database_sampler.write_gt_database``), so the sampler pastes
each object in its box; and ``get_raw_scene`` / ``get_lidar_with_sweeps``
also take an info dict, so a pseudo-labelled frame of another split can be
loaded through this dataset (``MixUpDataset``).
"""

import pickle
from pathlib import Path

import numpy as np

from ..augmentor.database_sampler import write_gt_database
from ..dataset import DatasetTemplate


class NuScenesDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names, training=training,
                         root_path=root_path, logger=logger)
        self.infos = []
        self.max_sweeps = int(dataset_cfg.get("MAX_SWEEPS", 1))
        self.shift_coor = dataset_cfg.get("SHIFT_COOR", None)
        self.include_nuscenes_data(self.mode)
        pct = float(dataset_cfg.get("LABELED_PERCENTAGE", 100.0))
        if self.training and pct < 100.0 and len(self.infos):
            # the labelled fraction: a seeded percentage subset of the frames
            n = max(int(round(len(self.infos) * pct / 100.0)), 1)
            sel = np.random.RandomState(3407).permutation(len(self.infos))[:n]
            self.infos = [self.infos[i] for i in sorted(sel)]
            if self.logger:
                self.logger.info("labeled subset: %d frames (%.1f%%)", n, pct)
        if self.training and dataset_cfg.get("BALANCED_RESAMPLING", False):
            self.infos = self.balanced_infos_resampling(self.infos)

    def include_nuscenes_data(self, mode):
        for info_path in self.dataset_cfg.INFO_PATH[mode]:
            path = Path(info_path)
            if not path.is_absolute() and self.root_path is not None:
                path = Path(self.root_path) / info_path
            if not path.exists():
                if self.logger:
                    self.logger.warning("info path missing: %s", path)
                continue
            with open(path, "rb") as f:
                self.infos.extend(pickle.load(f))
        if self.logger:
            self.logger.info("loaded %d nuScenes infos (%s)", len(self.infos), mode)

    def balanced_infos_resampling(self, infos):
        """Class-balanced resampling (CBGS): frames drawn with replacement
        per class so every class appears with equal frequency."""
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(info["gt_names"]):
                if name in cls_infos:
                    cls_infos[name].append(info)
        duplicated = sum(len(v) for v in cls_infos.values())
        if duplicated == 0:
            return infos
        frac = 1.0 / max(len(self.class_names), 1)
        sampled = []
        for v in cls_infos.values():
            if not v:
                continue
            ratio = frac * duplicated / len(v)
            sampled += np.random.choice(v, int(len(v) * ratio)).tolist()
        return sampled or infos

    def _load_bin(self, lidar_path):
        path = Path(lidar_path)
        if not path.is_absolute() and self.root_path is not None:
            path = Path(self.root_path) / lidar_path
        num_feats = int(self.dataset_cfg.get("NUM_RAW_FEATURES", 5))
        points = np.fromfile(str(path), dtype=np.float32).reshape(-1, num_feats)
        return points[:, :4]  # x, y, z, intensity (the ring index dropped)

    def get_sweep(self, sweep_info):
        points = self._load_bin(sweep_info["lidar_path"])
        tm = np.asarray(sweep_info.get("transform_matrix", np.eye(4)), dtype=np.float32)
        pts_h = np.concatenate([points[:, :3], np.ones((len(points), 1), np.float32)], axis=1)
        points[:, :3] = (pts_h @ tm.T)[:, :3]
        times = np.full((len(points), 1), float(sweep_info.get("time_lag", 0.0)),
                        dtype=np.float32)
        return points, times

    def _info(self, index):
        return index if isinstance(index, dict) else self.infos[index]

    def get_lidar_with_sweeps(self, index, max_sweeps=1):
        """The key frame and up to ``max_sweeps`` - 1 earlier sweeps in its
        frame, a fifth channel the time lag; ``index`` an index of
        ``infos`` or an info dict."""
        info = self._info(index)
        points = self._load_bin(info["lidar_path"])
        all_pts, all_times = [points], [np.zeros((len(points), 1), dtype=np.float32)]
        for sweep_info in info.get("sweeps", [])[: max_sweeps - 1]:
            p, t = self.get_sweep(sweep_info)
            all_pts.append(p)
            all_times.append(t)
        points = np.concatenate([np.concatenate(all_pts), np.concatenate(all_times)], axis=1)
        if self.shift_coor:
            points[:, :3] += np.asarray(self.shift_coor, dtype=np.float32)
        return points

    def get_raw_scene(self, index):
        """(points, gt_boxes, gt_names) of a frame, an index of ``infos`` or
        an info dict (the mixing datasets' protocol)."""
        info = self._info(index)
        points = self.get_lidar_with_sweeps(info, self.max_sweeps)
        gt_boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))), dtype=np.float32)
        gt_names = np.asarray(info.get("gt_names", []))
        if self.shift_coor and len(gt_boxes):
            gt_boxes = gt_boxes.copy()
            gt_boxes[:, :3] += np.asarray(self.shift_coor, dtype=np.float32)
        if self.dataset_cfg.get("FILTER_MIN_POINTS_IN_GT", 0) and "num_lidar_pts" in info:
            keep = np.asarray(info["num_lidar_pts"]) >= self.dataset_cfg.FILTER_MIN_POINTS_IN_GT
            gt_boxes, gt_names = gt_boxes[keep], gt_names[keep]
        return points, gt_boxes, gt_names

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        points, gt_boxes, gt_names = self.get_raw_scene(index)
        return self.prepare_data({"points": points, "gt_boxes": gt_boxes, "gt_names": gt_names,
                                  "frame_id": self.infos[index].get("token", index)})

    # the most frequent attribute per class on the nuScenes train split: the
    # fallback where the velocity heuristic names none
    DEFAULT_ATTRIBUTE = {
        "car": "vehicle.parked", "truck": "vehicle.parked",
        "construction_vehicle": "vehicle.parked", "trailer": "vehicle.parked",
        "bus": "vehicle.moving", "bicycle": "cycle.without_rider",
        "motorcycle": "cycle.without_rider", "pedestrian": "pedestrian.moving",
        "barrier": "", "traffic_cone": "",
    }

    @classmethod
    def assign_det_attributes(cls, anno):
        """Velocity-heuristic attribute of each detection, for the AAE metric."""
        boxes = np.asarray(anno["boxes_lidar"])
        attrs = []
        for i, name in enumerate(np.asarray(anno["name"])):
            speed = float(np.linalg.norm(boxes[i, 7:9])) if boxes.shape[-1] >= 9 else 0.0
            if speed > 0.2:
                if name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
                    attr = "vehicle.moving"
                elif name in ("bicycle", "motorcycle"):
                    attr = "cycle.with_rider"
                else:
                    attr = None
            else:
                if name == "pedestrian":
                    attr = "pedestrian.standing"
                elif name == "bus":
                    attr = "vehicle.stopped"
                else:
                    attr = None
            attrs.append(attr if attr is not None else cls.DEFAULT_ATTRIBUTE.get(name, ""))
        return np.asarray(attrs)

    def evaluation(self, det_annos, class_names, **kwargs):
        """The nuScenes metric (mAP, the five TP errors, NDS) of ``det_annos``
        against this split's infos, frame by frame in order."""
        from ...utils.nuscenes_eval_native import nuscenes_eval

        det_annos = [dict(a) for a in det_annos]
        for anno in det_annos:
            if "attribute" not in anno and "attribute_name" not in anno:
                anno["attribute"] = self.assign_det_attributes(anno)
        gt_annos = []
        for info in self.infos:
            boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))), dtype=np.float32)
            if self.shift_coor and len(boxes):
                boxes = boxes.copy()
                boxes[:, :3] += np.asarray(self.shift_coor, dtype=np.float32)
            gt = {"boxes_lidar": boxes, "name": np.asarray(info.get("gt_names", []))}
            if "gt_attributes" in info:
                gt["attribute"] = np.asarray(info["gt_attributes"])
            gt_annos.append(gt)
        return nuscenes_eval(det_annos, gt_annos, class_names)

    # ---- gt databases ------------------------------------------------------
    def create_groundtruth_database(self, used_classes=None, out_path=None):
        """The gt database of this dataset's frames for ``gt_sampling``,
        written to ``out_path`` with one box-relative ``.bin`` per object
        (``write_gt_database``). Returns {class: [info]}."""
        if out_path is None:
            raise ValueError("the gt database is written as files: give out_path")
        scenes = ((info.get("token", i), *self.get_raw_scene(i))
                  for i, info in enumerate(self.infos))
        return write_gt_database(scenes, used_classes or self.class_names, out_path)

    def create_sub_groundtruth_database(self, percentage, seed=0, out_path=None):
        """The gt database of a seeded ``percentage`` (a fraction) subset of
        the frames. Returns (db, the subset's sorted indices)."""
        rng = np.random.RandomState(seed)
        n = max(1, int(round(len(self.infos) * percentage)))
        subset = rng.permutation(len(self.infos))[:n]
        saved_infos = self.infos
        try:
            self.infos = [saved_infos[i] for i in subset]
            db = self.create_groundtruth_database(out_path=out_path)
        finally:
            self.infos = saved_infos
        return db, sorted(subset.tolist())
