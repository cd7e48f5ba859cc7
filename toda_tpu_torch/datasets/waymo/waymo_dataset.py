"""Waymo dataset adapter (per-sequence info pkls + npy point files), the
TODA source domain.

The port's own copy of ``toda_tpu/datasets/waymo/waymo_dataset.py``: it
loads the OpenPCDet artifact layout

    <root>/waymo_processed_data/<sequence_name>/{0000.npy, 0001.npy, ...}
    infos: {'point_cloud': {'lidar_sequence', 'sample_idx'},
            'annos': {'name', 'gt_boxes_lidar', 'num_points_in_gt', ...}}

(every SAMPLED_INTERVAL-th info, FILTER_MIN_POINTS_IN_GT), and writes it from
raw ``.tfrecord`` sequences without tensorflow (``create_waymo_infos``,
through ``tfrecord_io``). The gt database is written as box-relative ``.bin``
files with a ``path`` key (``augmentor.database_sampler.write_gt_database``),
so the sampler pastes each object in its box; JAX's stores the points
inline, which the sampler pastes at the sensor. ``get_raw_scene`` also takes
an info dict. ``evaluation`` is not ported: its metrics (KITTI-style AP and
Waymo's AP/APH) use a 3D IoU the port does not have yet, and no TODA stage
evaluates on Waymo.
"""

import pickle
from pathlib import Path

import numpy as np

from ..augmentor.database_sampler import write_gt_database
from ..dataset import DatasetTemplate


class WaymoDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names, training=training,
                         root_path=root_path, logger=logger)
        self.infos = []
        self.data_path = Path(self.root_path or ".") / dataset_cfg.get(
            "PROCESSED_DATA_TAG", "waymo_processed_data")
        self.include_waymo_data(self.mode)

    def include_waymo_data(self, mode):
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
        interval = int(self.dataset_cfg.get("SAMPLED_INTERVAL", {}).get(mode, 1) or 1)
        if interval > 1:
            self.infos = self.infos[::interval]
        if self.logger:
            self.logger.info("loaded %d Waymo infos (%s)", len(self.infos), mode)

    def get_lidar(self, sequence_name, sample_idx):
        """(N, 5) x, y, z, intensity, elongation of a frame (the NLZ flag,
        the sixth column on disk, dropped)."""
        points = np.load(str(self.data_path / sequence_name / f"{sample_idx:04d}.npy"))
        return points[:, :5].astype(np.float32)

    def get_raw_scene(self, index):
        """(points, gt_boxes (M, 7), gt_names) of a frame, an index of
        ``infos`` or an info dict."""
        info = index if isinstance(index, dict) else self.infos[index]
        pc = info["point_cloud"]
        points = self.get_lidar(pc["lidar_sequence"], pc["sample_idx"])
        annos = info.get("annos", {})
        gt_boxes = np.asarray(annos.get("gt_boxes_lidar", np.zeros((0, 7))), dtype=np.float32)
        gt_names = np.asarray(annos.get("name", []))
        if self.dataset_cfg.get("FILTER_MIN_POINTS_IN_GT", 0) and "num_points_in_gt" in annos:
            keep = (np.asarray(annos["num_points_in_gt"])
                    >= self.dataset_cfg.FILTER_MIN_POINTS_IN_GT)
            gt_boxes, gt_names = gt_boxes[keep], gt_names[keep]
        return points, gt_boxes[:, :7], gt_names

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        points, gt_boxes, gt_names = self.get_raw_scene(index)
        return self.prepare_data({"points": points, "gt_boxes": gt_boxes, "gt_names": gt_names,
                                  "frame_id": index})

    def evaluation(self, det_annos, class_names, **kwargs):
        raise NotImplementedError(
            "Waymo evaluation is not ported to the PyTorch package yet: JAX's "
            "kitti_eval_native / waymo_eval_native use its 3D IoU")

    def create_groundtruth_database(self, used_classes=None, out_path=None):
        """The gt database of this dataset's frames for ``gt_sampling``,
        written to ``out_path`` with one box-relative ``.bin`` per object
        (``write_gt_database``). Returns {class: [info]}."""
        if out_path is None:
            raise ValueError("the gt database is written as files: give out_path")

        def scenes():
            for i, info in enumerate(self.infos):
                pc = info["point_cloud"]
                yield (f"{pc['lidar_sequence']}_{pc['sample_idx']:04d}", *self.get_raw_scene(i))

        return write_gt_database(scenes(), used_classes or self.class_names, out_path)


def process_single_sequence(sequence_file, save_path, sampled_interval=1,
                            has_label=True, use_two_returns=True):
    """One .tfrecord sequence -> per-frame npy point clouds (x, y, z,
    intensity, elongation, NLZ) + info list, in the OpenPCDet artifact
    layout this adapter loads (``tfrecord_io``; a sequence already
    extracted is read back from its pickle)."""
    from . import tfrecord_io as tio

    sequence_file = Path(sequence_file)
    sequence_name = sequence_file.stem.replace(".tfrecord", "")
    cur_save_dir = Path(save_path) / sequence_name
    cur_save_dir.mkdir(parents=True, exist_ok=True)
    pkl_file = cur_save_dir / f"{sequence_name}.pkl"
    if pkl_file.exists():
        with open(pkl_file, "rb") as f:
            return pickle.load(f)

    sequence_infos = []
    for cnt, payload in enumerate(tio.read_tfrecords(sequence_file)):
        if cnt % sampled_interval != 0:
            continue
        frame = tio.parse_frame(payload)

        info = {
            "point_cloud": {
                "num_features": 5, "lidar_sequence": sequence_name, "sample_idx": cnt,
            },
            "frame_id": f"{sequence_name}_{cnt:03d}",
            "metadata": {
                "context_name": frame["context_name"],
                "timestamp_micros": frame["timestamp_micros"],
            },
            "image": {
                f"image_shape_{j}": (cam["height"], cam["width"])
                for j, cam in enumerate(frame["camera_calibrations"][:5])
            },
            "pose": frame["pose"].astype(np.float32),
        }

        if has_label:
            info["annos"] = _labels_to_annos(frame["laser_labels"])

        calib_of = {c["name"]: c for c in frame["laser_calibrations"]}
        all_points, num_per_lidar = [], []
        returns = ("ri_return1", "ri_return2") if use_two_returns else ("ri_return1",)
        for laser in sorted(frame["lasers"], key=lambda l: l["name"]):
            calib = calib_of.get(laser["name"])
            if calib is None:
                continue
            n_lidar = 0
            for ret in returns:
                ri = laser[ret].get("range_image")
                if ri is None or ri.ndim != 3:
                    continue
                pose_ri = laser["ri_return1"].get("pose")
                pixel_pose = frame_pose = None
                if laser["name"] == tio.LASER_TOP and pose_ri is not None:
                    pixel_pose, frame_pose = pose_ri, frame["pose"]
                pts, nlz = tio.range_image_to_points(
                    ri, calib["extrinsic"],
                    beam_inclinations=calib["beam_inclinations"],
                    inclination_range=(
                        calib["beam_inclination_min"], calib["beam_inclination_max"]
                    ),
                    pixel_pose=pixel_pose, frame_pose=frame_pose,
                )
                all_points.append(
                    np.concatenate([pts, nlz[:, None]], axis=-1).astype(np.float32)
                )
                n_lidar += len(pts)
            num_per_lidar.append(n_lidar)
        save_points = (
            np.concatenate(all_points, axis=0)
            if all_points else np.zeros((0, 6), np.float32)
        )
        np.save(cur_save_dir / f"{cnt:04d}.npy", save_points)
        info["num_points_of_each_lidar"] = num_per_lidar
        sequence_infos.append(info)

    with open(pkl_file, "wb") as f:
        pickle.dump(sequence_infos, f)
    return sequence_infos


def _labels_to_annos(laser_labels):
    """Frame labels -> the OpenPCDet annos dict; 'unknown' entries dropped,
    boxes as [x y z l w h heading]."""
    from .tfrecord_io import WAYMO_CLASSES

    names, difficulty, dims, locs, headings = [], [], [], [], []
    track_diff, obj_ids, num_pts = [], [], []
    for lab in laser_labels:
        cls = WAYMO_CLASSES[lab["type"]] if lab["type"] < len(WAYMO_CLASSES) else "unknown"
        if cls == "unknown":
            continue
        box = lab["box"]
        names.append(cls)
        difficulty.append(lab["detection_difficulty_level"])
        track_diff.append(lab["tracking_difficulty_level"])
        dims.append([box["length"], box["width"], box["height"]])
        locs.append([box["center_x"], box["center_y"], box["center_z"]])
        headings.append(box["heading"])
        obj_ids.append(lab["id"])
        num_pts.append(lab["num_lidar_points_in_box"])
    annos = {
        "name": np.asarray(names),
        "difficulty": np.asarray(difficulty),
        "dimensions": np.asarray(dims, np.float32).reshape(-1, 3),
        "location": np.asarray(locs, np.float32).reshape(-1, 3),
        "heading_angles": np.asarray(headings, np.float32),
        "obj_ids": np.asarray(obj_ids),
        "tracking_difficulty": np.asarray(track_diff),
        "num_points_in_gt": np.asarray(num_pts),
    }
    if len(names):
        annos["gt_boxes_lidar"] = np.concatenate(
            [annos["location"], annos["dimensions"], annos["heading_angles"][:, None]],
            axis=1,
        )
    else:
        annos["gt_boxes_lidar"] = np.zeros((0, 7), np.float32)
    return annos


def create_waymo_infos(raw_data_path, save_path, split_files=None,
                       sampled_interval=1, has_label=True, use_two_returns=True,
                       logger=None):
    """TFRecord -> npy + info extraction without tensorflow: every .tfrecord
    under raw_data_path (or the named split_files), written as the
    OpenPCDet artifact tree under ``save_path``; returns the flat info
    list."""
    raw = Path(raw_data_path)
    files = (
        [raw / f for f in split_files]
        if split_files
        else sorted(raw.glob("*.tfrecord"))
    )
    all_infos = []
    for seq in files:
        infos = process_single_sequence(
            seq, save_path, sampled_interval, has_label, use_two_returns
        )
        all_infos.extend(infos)
        if logger:
            logger.info("%s: %d frames", seq.name, len(infos))
    return all_infos
