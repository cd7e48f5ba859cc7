"""The two-domain mixing dataset (TODA stage 1) and the intra-domain MixUp
dataset (TODA stage 2).

The port's own copy of ``toda_tpu/datasets/mix_dataset.py``:

  * ``CutMixDataset`` (:36): with probability CUTMIX_PROB one frame from
    each domain, each augmented by its own domain's augmentor, classes
    remapped by CLASS_MAPPING, then the configured mixer; else a plain
    sample of the domain the index addresses. len = len(source) +
    len(target).
  * ``MixUpDataset`` (:157): with probability 1 - MIXUP_PROB a plain sample
    (ground truth with probability GT_PROB, else pseudo-labelled), else the
    MixUp of a pair chosen by MIXUP_TYPE. Pseudo samples keep the boxes that
    reach PSEUDO_SCORE_THRESH and, with ADV_ALPHA > 0, get the stored
    adversarial perturbation applied inside them.

Any child dataset with ``get_raw_scene(i) -> (points, gt_boxes, gt_names)``
plugs in. Random draws come from the global ``np.random`` in JAX's order.
"""

import numpy as np

from ..utils import box_utils
from .dataset import DatasetTemplate
from .processor import inter_domain_mix
from .processor.intra_domain_mixup import intra_domain_point_mixup, intra_domain_point_mixup_cd

MIXERS = {
    "cutmix": inter_domain_mix.cutmix,
    "polarmix": inter_domain_mix.polarmix,
    "lasermix": inter_domain_mix.lasermix,
    "pseudobbox": lambda s, t, **kw: inter_domain_mix.pseudomix(s, t, "pseudobbox"),
    "pseudobackground": lambda s, t, **kw: inter_domain_mix.pseudomix(s, t, "pseudobackground"),
}


class CutMixDataset(DatasetTemplate):
    """Stage-1 inter-domain mixing over (source, target) child datasets."""

    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None,
                 source_dataset=None, target_dataset=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names, training=training,
                         root_path=root_path, logger=logger)
        from . import build_dataset

        self.source = source_dataset or build_dataset(dataset_cfg.SOURCE_CFG, class_names,
                                                      training=training, logger=logger)
        self.target = target_dataset or build_dataset(dataset_cfg.TARGET_CFG, class_names,
                                                      training=training, logger=logger)
        self.mix_type = dataset_cfg.get("MIX_TYPE", "cutmix")
        # CUTMIX_PROB and POLARMIX_PROB name the same knob
        self.mix_prob = float(dataset_cfg.get(
            "CUTMIX_PROB", dataset_cfg.get("POLARMIX_PROB", 0.5)))
        self.class_mapping = dataset_cfg.get("CLASS_MAPPING", None)
        self.polarmix_width = dataset_cfg.get(
            "POLARMIX_UPDATE_METHOD", dataset_cfg.get("POLARMIX_WIDTH_METHOD", "FIX"))
        self.polarmix_degree = dataset_cfg.get("POLARMIX_DEGREE", [np.pi / 6, np.pi])
        self.polarmix_rc_num = int(dataset_cfg.get("POLARMIX_RC_NUM", 1))
        self.polarmix_dis = dataset_cfg.get("POLARMIX_DIS", "FULL")
        self.inc_method = dataset_cfg.get("MIX_INC_METHOD", "center")
        self.use_pitch = bool(dataset_cfg.get("POLARMIX_USE_PITCH", False))
        self.lasermix_mode = dataset_cfg.get("LASERMIX_MODE", "spherical")
        self.lasermix_num_areas = dataset_cfg.get("LASERMIX_NUM_AREAS", None)
        self.lasermix_num_angles = dataset_cfg.get("LASERMIX_NUM_ANGLES", None)
        self.lasermix_pitch = dataset_cfg.get("LASERMIX_PITCH_ANGLE", None)
        pc_range = dataset_cfg.get("POINT_CLOUD_RANGE", None)
        self.range_max = float(pc_range[3]) if pc_range is not None else 60.0
        self.pc_range = np.asarray(pc_range, np.float64) if pc_range is not None else None
        # the window must hold more target points than this (10000 for real
        # scans; smaller scenes set it lower)
        self.cutmix_min_points = int(dataset_cfg.get("CUTMIX_MIN_POINTS", 10000))

    def __len__(self):
        return len(self.source) + len(self.target)

    def _raw(self, dataset, idx):
        points, gt_boxes, gt_names = dataset.get_raw_scene(idx)
        if self.class_mapping:
            gt_names = np.asarray([self.class_mapping.get(n, n) for n in gt_names])
        return {"points": points, "gt_boxes": gt_boxes, "gt_names": gt_names}

    @staticmethod
    def _augment_domain(dataset, d):
        if dataset.data_augmentor is None:
            return d
        d = dataset.data_augmentor.forward(dict(d))
        d.pop("augmentation_params", None)
        return d

    def _mixer_kwargs(self, mix_type):
        if mix_type == "cutmix":
            return dict(pc_range=self.pc_range, min_points=self.cutmix_min_points)
        if mix_type == "polarmix":
            return dict(train_percent=self.train_percent, width_method=self.polarmix_width,
                        degree=self.polarmix_degree, rot_copy_num=self.polarmix_rc_num,
                        polar_dis=self.polarmix_dis, range_max=self.range_max,
                        inc_method=self.inc_method, use_pitch=self.use_pitch)
        if mix_type == "lasermix":
            return dict(mode=self.lasermix_mode, inc_method=self.inc_method,
                        num_areas=self.lasermix_num_areas, num_angles=self.lasermix_num_angles,
                        pitch_angles_deg=self.lasermix_pitch, range_max=self.range_max)
        return {}

    def __getitem__(self, index):
        if self.training and np.random.rand() < self.mix_prob:
            src = self._raw(self.source, np.random.randint(len(self.source)))
            tgt = self._raw(self.target, np.random.randint(len(self.target)))
            src = self._augment_domain(self.source, src)
            tgt = self._augment_domain(self.target, tgt)
            mix_type = self.mix_type
            if mix_type == "cutpolarmix":  # a fair coin per mixed sample
                mix_type = "cutmix" if np.random.rand() < 0.5 else "polarmix"
            mixed = MIXERS[mix_type](src, tgt, **self._mixer_kwargs(mix_type))
            # the domain augmentors already ran: skip the template's
            aug, self.data_augmentor = self.data_augmentor, None
            try:
                return self.prepare_data({**mixed, "frame_id": index})
            finally:
                self.data_augmentor = aug
        if index < len(self.source):
            d = self._raw(self.source, index)
        else:
            d = self._raw(self.target, index - len(self.source))
        out = self.prepare_data({**d, "frame_id": index})
        # mixed samples carry no replay record: plain ones drop theirs, so
        # every batch collates the same keys
        out.pop("augmentation_params", None)
        out.pop("aug_vector", None)
        return out

    def evaluation(self, det_annos, class_names, **kwargs):
        return self.target.evaluation(det_annos, class_names, **kwargs)


class MixUpDataset(DatasetTemplate):
    """Stage-2 intra-domain MixUp over ground-truth and pseudo-labelled frames.

    The pseudo pool is a list of dicts {'index', 'gt_boxes', 'gt_names',
    'score', optional 'point_perturb' and the voxel-keyed 'p_voxel_*'
    fields} of frames of ``base_dataset``, as ``generate_pseudo_labels``
    writes them."""

    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None,
                 base_dataset=None, pseudo_infos=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names, training=training,
                         root_path=root_path, logger=logger)
        from . import build_dataset

        self.base = base_dataset or build_dataset(dataset_cfg.BASE_CFG, class_names,
                                                  training=training, logger=logger)
        self.pseudo_infos = pseudo_infos or []
        self.labeled_indices = list(dataset_cfg.get("LABELED_INDICES", range(len(self.base))))
        self.mixup_prob = float(dataset_cfg.get("MIXUP_PROB", 0.5))
        self.gt_prob = float(dataset_cfg.get("GT_PROB", 0.5))
        self.mixup_type = dataset_cfg.get("MIXUP_TYPE", "gt+ps_gt+ps")
        self.alpha = float(dataset_cfg.get("ALPHA", 1.0))
        self.collision_detection = bool(dataset_cfg.get("COLLISION_DETECTION", True))
        self.adv_alpha = float(dataset_cfg.get("ADV_ALPHA", 0.0))
        self.score_thresh = float(dataset_cfg.get("PSEUDO_SCORE_THRESH", 0.0))
        # epoch-length multiplier of the labelled pool (0: no repeat)
        self.repeat = int(dataset_cfg.get("REPEAT", 0))

    def __len__(self):
        if self.repeat:
            return len(self.labeled_indices) * self.repeat
        return len(self.labeled_indices) + len(self.pseudo_infos)

    def _gt_sample(self, rng):
        idx = self.labeled_indices[rng.randint(len(self.labeled_indices))]
        points, gt_boxes, gt_names = self.base.get_raw_scene(idx)
        return {"points": points, "gt_boxes": gt_boxes, "gt_names": gt_names}

    def _pseudo_sample(self, rng):
        info = self.pseudo_infos[rng.randint(len(self.pseudo_infos))]
        points, _, _ = self.base.get_raw_scene(info["index"])
        boxes = np.asarray(info["gt_boxes"], dtype=np.float32)
        names = np.asarray(info["gt_names"])
        scores = np.asarray(info.get("score", np.ones(len(boxes))))
        keep = scores >= self.score_thresh
        boxes, names = boxes[keep], names[keep]
        if self.adv_alpha > 0.0 and "point_perturb" in info:
            points = self._apply_perturb(points, boxes, info, rng)
        return {"points": points, "gt_boxes": boxes, "gt_names": names}

    def _apply_perturb(self, points, boxes, info, rng):
        """The stored adversarial perturbation, scaled by ADV_ALPHA, on the
        points inside the pseudo boxes, by one of three random modes:
        modify them in place, add perturbed copies, or drop ~30% of them.
        The perturbation is looked up by each point's voxel cell where the
        info has the voxel-keyed form, else taken per point (zero where the
        stored points no longer line up)."""
        from ..runtime.pseudo_label import lookup_voxel_perturb

        points = points.copy()
        member = box_utils.points_in_boxes_numpy(points, boxes[:, :7]).any(axis=0)
        mode = rng.randint(3)
        if "p_voxel_coords" in info:
            delta = lookup_voxel_perturb(points, info)
        else:
            perturb = np.asarray(info["point_perturb"], dtype=np.float32)
            if perturb.ndim == 1:
                delta = np.broadcast_to(perturb[:3], (len(points), 3))
            elif len(perturb) == len(points):
                delta = perturb[:, :3]
            else:
                delta = np.zeros((len(points), 3), dtype=np.float32)
        if mode == 0:
            points[member, :3] += self.adv_alpha * delta[member, :3]
        elif mode == 1:
            extra = points[member].copy()
            extra[:, :3] += self.adv_alpha * delta[member, :3]
            points = np.concatenate([points, extra])
        else:
            drop = member & (rng.rand(len(member)) < 0.3)
            points = points[~drop]
        return points

    def _sample_pair_kinds(self, rng):
        """MIXUP_TYPE in {only_gt, ps_gt, gt_gt+ps, gt+ps_gt+ps}."""
        t = self.mixup_type
        if t == "only_gt":
            return "gt", "gt"
        if t == "ps_gt":
            return "ps", "gt"
        if t == "gt_gt+ps":
            return "gt", ("gt" if rng.rand() < 0.5 else "ps")
        first = "gt" if rng.rand() < self.gt_prob else "ps"
        return first, ("gt" if rng.rand() < self.gt_prob else "ps")

    def _get(self, kind, rng):
        if kind == "ps" and self.pseudo_infos:
            return self._pseudo_sample(rng)
        return self._gt_sample(rng)

    def get_raw_item(self, index):
        """A sampled, possibly mixed scene before augmentation and encoding:
        the unit ``CLPairDataset`` prepares twice."""
        rng = np.random
        if self.training and self.mixup_type != "no_mixup" and rng.rand() < self.mixup_prob:
            ka, kb = self._sample_pair_kinds(rng)
            a, b = self._get(ka, rng), self._get(kb, rng)
            fn = intra_domain_point_mixup_cd if self.collision_detection \
                else intra_domain_point_mixup
            mixed = fn(a, b, alpha=self.alpha, rng=rng)
            mixed.pop("mixup_lambda", None)
            return mixed
        kind = "gt" if (rng.rand() < self.gt_prob or not self.pseudo_infos) else "ps"
        return self._get(kind, rng)

    def __getitem__(self, index):
        return self.prepare_data({**self.get_raw_item(index), "frame_id": index})

    def evaluation(self, det_annos, class_names, **kwargs):
        return self.base.evaluation(det_annos, class_names, **kwargs)
