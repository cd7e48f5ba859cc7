"""Devkit-free nuScenes info generation from the raw JSON tables.

The port's own copy of ``toda_tpu/datasets/nuscenes/nuscenes_utils.py``
(``NuScenesTables``, ``fill_infos``, ``create_nuscenes_infos``). The devkit
is only a JSON loader + quaternion helpers, so the traversal runs directly on
the tables (sample/sample_data/ego_pose/calibrated_sensor/sample_annotation/
...): boxes are brought global -> ego -> lidar frame, velocities come from
neighboring annotations of the same instance, attributes from the
annotation's first attribute token, and sweeps follow the sample_data prev
chain with composed rigid transforms.
"""

import json
import pickle
from pathlib import Path

import numpy as np

# official detection-class mapping (devkit eval config / reference
# map_name_from_general_to_detection)
NAME_MAP = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

MINI_TRAIN = [
    "scene-0061", "scene-0553", "scene-0655", "scene-0757",
    "scene-0796", "scene-1077", "scene-1094", "scene-1100",
]
MINI_VAL = ["scene-0103", "scene-0916"]


def quat_to_rot(q):
    """(w, x, y, z) -> (3, 3) rotation matrix."""
    w, x, y, z = (float(v) for v in q)
    return np.asarray(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )


def rot_yaw(rot):
    """Yaw of the rotated x-axis (devkit quaternion_yaw semantics)."""
    v = rot @ np.asarray([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def transform_matrix(translation, rotation_q, inverse=False):
    """4x4 rigid transform from a nuScenes pose record."""
    r = quat_to_rot(rotation_q)
    t = np.asarray(translation, dtype=np.float64)
    m = np.eye(4)
    if inverse:
        m[:3, :3] = r.T
        m[:3, 3] = -(r.T @ t)
    else:
        m[:3, :3] = r
        m[:3, 3] = t
    return m


class NuScenesTables:
    """Token-indexed raw tables of one nuScenes version directory."""

    TABLES = (
        "scene", "sample", "sample_data", "ego_pose", "calibrated_sensor",
        "sensor", "sample_annotation", "instance", "category",
    )
    OPTIONAL_TABLES = ("attribute",)  # needed only for the AAE metric

    def __init__(self, data_path, version):
        base = Path(data_path) / version
        self.by_token = {}
        self.rows = {}
        for name in self.TABLES + self.OPTIONAL_TABLES:
            try:
                with open(base / f"{name}.json") as f:
                    rows = json.load(f)
            except FileNotFoundError:
                if name not in self.OPTIONAL_TABLES:
                    raise
                rows = []
            self.rows[name] = rows
            self.by_token[name] = {r["token"]: r for r in rows}
        # reverse index: sample token -> keyframe LIDAR_TOP sample_data
        self.lidar_top = {}
        for sd in self.rows["sample_data"]:
            cs = self.by_token["calibrated_sensor"][sd["calibrated_sensor_token"]]
            sensor = self.by_token["sensor"][cs["sensor_token"]]
            if sensor["channel"] == "LIDAR_TOP" and sd["is_key_frame"]:
                self.lidar_top[sd["sample_token"]] = sd
        # annotations per sample
        self.anns_of = {}
        for ann in self.rows["sample_annotation"]:
            self.anns_of.setdefault(ann["sample_token"], []).append(ann)

    def sd_global_from_sensor(self, sd):
        cs = self.by_token["calibrated_sensor"][sd["calibrated_sensor_token"]]
        ep = self.by_token["ego_pose"][sd["ego_pose_token"]]
        return transform_matrix(ep["translation"], ep["rotation"]) @ transform_matrix(
            cs["translation"], cs["rotation"]
        )

    def box_velocity(self, ann, max_time_diff=1.5):
        """Finite-difference global-frame velocity from neighbor annotations
        (devkit NuScenes.box_velocity)."""
        first = self.by_token["sample_annotation"].get(ann["prev"]) or ann
        last = self.by_token["sample_annotation"].get(ann["next"]) or ann
        if first is last:
            return np.zeros(3)
        t0 = self.by_token["sample"][first["sample_token"]]["timestamp"] * 1e-6
        t1 = self.by_token["sample"][last["sample_token"]]["timestamp"] * 1e-6
        if t1 - t0 <= 0 or t1 - t0 > 2 * max_time_diff:
            return np.full(3, np.nan)
        return (
            np.asarray(last["translation"]) - np.asarray(first["translation"])
        ) / (t1 - t0)


def fill_infos(t, split_scenes, max_sweeps=10, name_map=NAME_MAP,
               with_velocity=True, with_attributes=True):
    """The nuScenes-schema traversal (Lyft's raw data ships the same tables,
    so its adapter reuses it in the JAX package).

    name_map=None keeps raw category names (Lyft categories are already
    detection names); with_velocity=False emits (N, 7) boxes.
    """
    train_infos, val_infos = [], []
    for sample in t.rows["sample"]:
        sd = t.lidar_top.get(sample["token"])
        if sd is None:
            continue
        scene_name = t.by_token["scene"][sample["scene_token"]]["name"]
        ref_from_global = np.linalg.inv(t.sd_global_from_sensor(sd))
        ref_rot = ref_from_global[:3, :3]
        ref_time = sd["timestamp"] * 1e-6

        # sweeps: previous non-key lidar frames transformed into the ref frame
        sweeps = []
        cur = sd
        while len(sweeps) < max_sweeps - 1 and cur["prev"]:
            cur = t.by_token["sample_data"][cur["prev"]]
            tm = ref_from_global @ t.sd_global_from_sensor(cur)
            sweeps.append(
                {
                    "lidar_path": cur["filename"],
                    "transform_matrix": tm.astype(np.float32),
                    "time_lag": ref_time - cur["timestamp"] * 1e-6,
                }
            )

        boxes, names, velocities, num_pts, attrs = [], [], [], [], []
        attr_table = t.by_token.get("attribute", {})
        for ann in t.anns_of.get(sample["token"], []):
            # Raw sample_annotation rows carry only instance_token; category
            # comes via instance -> category (the devkit denormalizes this into
            # category_name at load time). Accept the denormalized forms too.
            inst = t.by_token["instance"].get(ann.get("instance_token", ""), {})
            cat_token = ann.get("category_token") or inst.get("category_token", "")
            general = t.by_token["category"].get(cat_token, {}).get(
                "name"
            ) or ann.get("category_name", "")
            det_name = name_map.get(general) if name_map is not None else (general or None)
            if det_name is None:
                continue
            center = ref_from_global @ np.asarray([*ann["translation"], 1.0])
            rot = ref_rot @ quat_to_rot(ann["rotation"])
            w, l, h = ann["size"]  # noqa: E741  (nuScenes size order is w, l, h)
            boxes.append([*center[:3], l, w, h, rot_yaw(rot)])
            names.append(det_name)
            num_pts.append(ann.get("num_lidar_pts", -1))
            # attribute name for the official AAE metric (devkit: one attribute
            # token per annotation, or none)
            toks = ann.get("attribute_tokens", [])
            attrs.append(attr_table.get(toks[0], {}).get("name", "") if toks else "")
            if with_velocity:
                v = t.box_velocity(ann)
                v = ref_rot @ np.nan_to_num(v)
                velocities.append(v[:2])

        gt_boxes = np.asarray(boxes, dtype=np.float32).reshape(-1, 7)
        if with_velocity:
            vel = np.asarray(velocities, dtype=np.float32).reshape(-1, 2)
            gt_boxes = np.concatenate([gt_boxes, vel], axis=1)
        info = {
            "lidar_path": sd["filename"],
            "token": sample["token"],
            "timestamp": ref_time,
            "sweeps": sweeps,
            "gt_boxes": gt_boxes,
            "gt_names": np.asarray(names),
            "num_lidar_pts": np.asarray(num_pts, dtype=np.int32),
        }
        if with_attributes:
            info["gt_attributes"] = np.asarray(attrs)
        if scene_name in split_scenes["train"]:
            train_infos.append(info)
        elif scene_name in split_scenes["val"]:
            val_infos.append(info)
    return train_infos, val_infos


def create_nuscenes_infos(version, data_path, save_path=None, max_sweeps=10,
                          split_scenes=None, with_velocity=True, logger=None):
    """Build train/val info lists from raw nuScenes (devkit-free).

    split_scenes: optional {'train': [...names], 'val': [...]} — defaults to
    the official mini splits for v1.0-mini; other versions must pass theirs
    (the official 700/150 split list ships with the devkit, not the data).
    Returns (train_infos, val_infos); writes pkls when save_path given.
    """
    t = NuScenesTables(data_path, version)
    if split_scenes is None:
        if "mini" in version:
            split_scenes = {"train": MINI_TRAIN, "val": MINI_VAL}
        else:
            names = sorted(s["name"] for s in t.rows["scene"])
            cut = int(len(names) * 0.82)
            split_scenes = {"train": names[:cut], "val": names[cut:]}
            if logger:
                logger.warning(
                    "no split list given; using a name-ordered 82/18 scene split"
                )

    train_infos, val_infos = fill_infos(
        t, split_scenes, max_sweeps=max_sweeps, with_velocity=with_velocity
    )
    if logger:
        logger.info(
            "nuscenes infos: %d train, %d val", len(train_infos), len(val_infos)
        )
    if save_path is not None:
        save_path = Path(save_path)
        tag = f"{max_sweeps}sweeps"
        with open(save_path / f"nuscenes_infos_{tag}_train.pkl", "wb") as f:
            pickle.dump(train_infos, f)
        with open(save_path / f"nuscenes_infos_{tag}_val.pkl", "wb") as f:
            pickle.dump(val_infos, f)
    return train_infos, val_infos
