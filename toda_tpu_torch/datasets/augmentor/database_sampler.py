"""GT-database copy-paste augmentation (``gt_sampling``, host numpy).

The port's own copy of ``toda_tpu/datasets/augmentor/database_sampler.py``
(``DataBaseSampler``, ``consolidate_gt_database``): the same pools, the same
global ``np.random`` draws in the same order, collision rejection against
the scene's and the already accepted boxes, and the background carve-out.
A db info carries its points inline, a ``path`` of a box-relative ``.bin``
file, or an offset into a consolidated ``.npy`` read through mmap
(``USE_SHARED_MEMORY``, optionally staged in /dev/shm with ``SHM_CACHE``).

``write_gt_database`` is the port's builder for the datasets'
``create_groundtruth_database``: one ``.bin`` of box-relative points per
object and a ``path`` key, the format the sampler's shift rule (the box
centre is added back to ``path`` entries only) is written for. JAX's
builders store the box-relative points inline, which the sampler pastes at
the sensor.
"""

import pickle
from pathlib import Path

import numpy as np

from ...utils import box_utils


def write_gt_database(scenes, used_classes, out_path):
    """The gt database of ``scenes``, an iterable of (frame name, points,
    gt_boxes, gt_names), written to ``out_path`` (a dbinfos pickle) with
    each object's points, less its box centre, in
    ``gt_database/<pickle stem>/<frame>_<class>_<j>.bin`` beside it
    (float32, all point columns). Returns {class: [info]}, each info
    {'name', 'path' (relative to the pickle's directory), 'image_idx',
    'gt_idx', 'box3d_lidar', 'num_points_in_gt', 'difficulty'}."""
    out_path = Path(out_path)
    rel_dir = Path("gt_database") / out_path.stem
    (out_path.parent / rel_dir).mkdir(parents=True, exist_ok=True)
    db = {c: [] for c in used_classes}
    for frame, points, gt_boxes, gt_names in scenes:
        if not len(gt_boxes):
            continue
        member = box_utils.points_in_boxes_numpy(points, gt_boxes[:, :7])
        for j, name in enumerate(gt_names):
            if name not in db:
                continue
            obj = points[member[j]].astype(np.float32)
            obj[:, :3] -= gt_boxes[j, :3]
            rel = rel_dir / f"{frame}_{name}_{j}.bin"
            obj.tofile(str(out_path.parent / rel))
            db[name].append({
                "name": name, "path": str(rel), "image_idx": frame, "gt_idx": j,
                "box3d_lidar": gt_boxes[j], "num_points_in_gt": len(obj), "difficulty": 0,
            })
    with open(out_path, "wb") as f:
        pickle.dump(db, f)
    return db


def _object_points(info, root):
    """An object's points: inline, or its ``.bin`` of ``num_points_in_gt``
    rows, whose column count is read from the file's size (the port's
    builders write every point column). None for an object with no
    points."""
    if "points" in info:
        pts = np.asarray(info["points"], dtype=np.float32)
        return pts if len(pts) else None
    p = Path(info["path"])
    if not p.is_absolute() and root is not None:
        p = root / p
    flat = np.fromfile(str(p), dtype=np.float32)
    n = int(info["num_points_in_gt"])
    if n == 0 and len(flat) == 0:
        return None
    if n == 0 or len(flat) % n:
        raise ValueError(f"{p}: {len(flat)} values do not make {n} points")
    return flat.reshape(n, -1)


def consolidate_gt_database(dbinfos_path, root_path, out_npy=None, out_pkl=None,
                            num_point_features=None, logger=None):
    """Pack a per-object-file GT database into ONE .npy + offset-carrying infos.

    The shared-memory form of the database: the consolidated array is opened
    with mmap_mode='r' by every sampler (one page-cache copy per host), and can
    additionally be staged into /dev/shm via common_utils.shm_cache_file —
    together these replace the reference's SharedArray lifecycle
    (database_sampler.py:59-86, common_utils.py:245-249).

    Each object's column count comes from its own points (a ``.bin`` file's
    size over ``num_points_in_gt``); ``num_point_features`` keeps the first
    that many columns, None all of them. Every object must give the same
    width.

    Returns (npy_path, pkl_path).
    """
    dbinfos_path = Path(dbinfos_path)
    root = Path(root_path) if root_path is not None else None
    with open(dbinfos_path, "rb") as f:
        infos = pickle.load(f)

    chunks, new_infos, offset = [], {}, 0
    for cls, items in infos.items():
        new_items = []
        for info in items:
            pts = _object_points(info, root)
            info = {k: v for k, v in info.items() if k != "points"}
            if pts is not None:
                chunks.append(pts[:, :num_point_features])
            info["db_offset"] = offset
            info["num_points_in_gt"] = 0 if pts is None else len(pts)
            offset += info["num_points_in_gt"]
            new_items.append(info)
        new_infos[cls] = new_items

    widths = {c.shape[1] for c in chunks}
    if len(widths) > 1:
        raise ValueError(f"{dbinfos_path}: objects of {sorted(widths)} point columns")
    width = widths.pop() if widths else (num_point_features or 0)
    all_pts = np.concatenate(chunks, axis=0) if chunks else np.zeros((0, width), np.float32)
    npy_path = Path(out_npy or dbinfos_path.with_suffix("")).with_suffix(".npy")
    pkl_path = Path(out_pkl or str(dbinfos_path).replace(".pkl", "_shared.pkl"))
    np.save(str(npy_path), all_pts)
    with open(pkl_path, "wb") as f:
        pickle.dump(new_infos, f)
    if logger is not None:
        logger.info(
            "consolidated %d objects / %d points of %d columns -> %s + %s",
            sum(len(v) for v in new_infos.values()), len(all_pts), width, npy_path, pkl_path,
        )
    return npy_path, pkl_path


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        self.root_path = Path(root_path) if root_path is not None else None
        self.class_names = class_names
        self.sampler_cfg = sampler_cfg
        self.logger = logger
        self.db_infos = {}
        for class_name in class_names:
            self.db_infos[class_name] = []

        for db_info_path in sampler_cfg.DB_INFO_PATH:
            path = Path(db_info_path)
            if not path.is_absolute() and self.root_path is not None:
                path = self.root_path / db_info_path
            with open(path, "rb") as f:
                infos = pickle.load(f)
                for cur_class in class_names:
                    if cur_class in infos:
                        self.db_infos[cur_class].extend(infos[cur_class])

        for func_name, val in sampler_cfg.get("PREPARE", {}).items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.sample_groups = {}
        self.sample_class_num = {}
        self.limit_whole_scene = sampler_cfg.get("LIMIT_WHOLE_SCENE", False)
        for x in sampler_cfg.SAMPLE_GROUPS:
            class_name, sample_num = x.split(":")
            if class_name not in class_names:
                continue
            self.sample_class_num[class_name] = int(sample_num)
            self.sample_groups[class_name] = {
                "sample_num": int(sample_num),
                "pointer": len(self.db_infos[class_name]),
                "indices": np.arange(len(self.db_infos[class_name])),
            }

    def filter_by_difficulty(self, db_infos, removed_difficulty):
        new_db_infos = {}
        for key, dinfos in db_infos.items():
            new_db_infos[key] = [
                info for info in dinfos if info.get("difficulty", 0) not in removed_difficulty
            ]
        return new_db_infos

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for name_num in min_gt_points_list:
            name, min_num = name_num.split(":")
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                db_infos[name] = [
                    info for info in db_infos[name] if info["num_points_in_gt"] >= min_num
                ]
        return db_infos

    def sample_with_fixed_number(self, class_name, sample_group):
        sample_num = sample_group["sample_num"]
        pointer = sample_group["pointer"]
        indices = sample_group["indices"]
        total = len(self.db_infos[class_name])
        if total == 0:
            return []
        if pointer >= total:
            indices = np.random.permutation(total)
            pointer = 0
        sampled = [
            self.db_infos[class_name][idx]
            for idx in indices[pointer : min(pointer + sample_num, total)]
        ]
        sample_group["pointer"] = pointer + sample_num
        sample_group["indices"] = indices
        return sampled

    def _load_points(self, info):
        if "points" in info:
            return np.asarray(info["points"], dtype=np.float32)
        num_feat = self.sampler_cfg.get("NUM_POINT_FEATURES", 4)
        # USE_SHARED_MEMORY analog (reference database_sampler.py:59-86 loads
        # the whole GT DB into /dev/shm via SharedArray): a consolidated .npy
        # opened with mmap_mode='r' shares one page-cache copy across every
        # process on the host and avoids per-sample open() syscalls.
        if "db_offset" in info and self.sampler_cfg.get("USE_SHARED_MEMORY", False):
            if not hasattr(self, "_db_mmap"):
                db_path = Path(self.sampler_cfg["DB_DATA_PATH"][0])
                if not db_path.is_absolute() and self.root_path is not None:
                    db_path = self.root_path / db_path
                if self.sampler_cfg.get("SHM_CACHE", False):
                    # stage into /dev/shm once per host (leader-elected copy,
                    # other processes wait) — the reference's SharedArray
                    # lifecycle (database_sampler.py:59-86)
                    from ...utils.common_utils import shm_cache_file

                    db_path = shm_cache_file(db_path)
                self._db_mmap = np.load(str(db_path), mmap_mode="r")
            lo, n = int(info["db_offset"]), int(info["num_points_in_gt"])
            return np.array(self._db_mmap[lo : lo + n, :num_feat], dtype=np.float32)
        file_path = Path(info["path"])
        if not file_path.is_absolute() and self.root_path is not None:
            file_path = self.root_path / info["path"]
        pts = np.fromfile(str(file_path), dtype=np.float32).reshape(-1, num_feat)
        return pts

    def __call__(self, data_dict):
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"]
        points = data_dict["points"]
        existed_boxes = gt_boxes
        sampled_boxes_list, sampled_names_list, sampled_points_list = [], [], []

        for class_name, sample_group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = int(np.sum(gt_names == class_name))
                sample_group["sample_num"] = self.sample_class_num[class_name] - num_gt
            if sample_group["sample_num"] <= 0:
                continue
            sampled = self.sample_with_fixed_number(class_name, sample_group)
            if not sampled:
                continue
            sampled_boxes = np.stack(
                [np.asarray(x["box3d_lidar"], dtype=np.float32) for x in sampled]
            )
            # reject samples colliding with existing or already-accepted boxes
            all_prev = (
                np.concatenate([existed_boxes[:, :7]] + [b[:, :7] for b in sampled_boxes_list])
                if sampled_boxes_list
                else existed_boxes[:, :7]
            )
            if len(all_prev):
                iou_prev = box_utils.boxes3d_nearest_bev_iou(sampled_boxes[:, :7], all_prev)
            else:
                iou_prev = np.zeros((len(sampled_boxes), 1))
            iou_self = box_utils.boxes3d_nearest_bev_iou(
                sampled_boxes[:, :7], sampled_boxes[:, :7]
            )
            iou_self[np.arange(len(sampled_boxes)), np.arange(len(sampled_boxes))] = 0
            valid = (iou_prev.max(axis=1) < 1e-3) & (iou_self.max(axis=1) < 1e-3)
            for i in np.where(valid)[0]:
                info = sampled[i]
                obj_pts = self._load_points(info).copy()
                box = sampled_boxes[i]
                if "path" in info:
                    obj_pts[:, :3] += box[None, :3]
                sampled_boxes_list.append(box[None])
                sampled_names_list.append(info["name"])
                sampled_points_list.append(obj_pts)

        if sampled_boxes_list:
            sampled_gt_boxes = np.concatenate(sampled_boxes_list)
            # carry extra dims (e.g. velocity) as zeros if the scene boxes have them
            if gt_boxes.shape[1] > sampled_gt_boxes.shape[1]:
                pad = np.zeros(
                    (len(sampled_gt_boxes), gt_boxes.shape[1] - sampled_gt_boxes.shape[1]),
                    dtype=sampled_gt_boxes.dtype,
                )
                sampled_gt_boxes = np.concatenate([sampled_gt_boxes, pad], axis=1)
            elif sampled_gt_boxes.shape[1] > gt_boxes.shape[1]:
                sampled_gt_boxes = sampled_gt_boxes[:, : gt_boxes.shape[1]]
            obj_points = np.concatenate(sampled_points_list)[:, : points.shape[1]]
            # carve out background points where objects are pasted
            points = box_utils.remove_points_in_boxes3d(points, sampled_gt_boxes[:, :7])
            data_dict["points"] = np.concatenate([obj_points, points], axis=0)
            data_dict["gt_boxes"] = np.concatenate([gt_boxes, sampled_gt_boxes], axis=0)
            data_dict["gt_names"] = np.concatenate(
                [gt_names, np.asarray(sampled_names_list)], axis=0
            )
        return data_dict
