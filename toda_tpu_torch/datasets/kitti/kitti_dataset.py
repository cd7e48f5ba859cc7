"""KITTI dataset adapter (info-pkl driven, lidar-frame boxes), the target
domain of TODA's nuScenes -> KITTI track.

The port's own copy of ``toda_tpu/datasets/kitti/kitti_dataset.py``. Info
schema (OpenPCDet's): 'point_cloud' {'num_features', 'lidar_idx'}, 'image'
{'image_idx', 'image_shape'}, 'calib' {'P2', 'R0_rect', 'Tr_velo_to_cam'}
(4 x 4 each) and 'annos' {'name', 'truncated', 'occluded', 'alpha', 'bbox',
'dimensions', 'location', 'rotation_y', 'score', 'difficulty', 'index',
'gt_boxes_lidar', 'num_points_in_gt'}; DontCare rows come last and have no
lidar box.

Covered: the raw-file IO (velodyne, calib, label_2, the image shape from
the png header or KITTI's 375 x 1242), ``get_infos`` from a raw tree,
``get_raw_scene`` with FOV_POINTS_ONLY, ``__getitem__``,
``generate_prediction_dicts`` (camera boxes, the projected 2D box and alpha,
optionally label-format text files) and ``evaluation`` (the native 40-point
AP, ``utils/kitti_eval_native.py``). The camera items of GET_ITEM_LIST and
road planes, which only CaDDN reads, are not ported.

One departure from JAX's, a repair: the gt database is written as
box-relative ``.bin`` files with a ``path`` key
(``augmentor.database_sampler.write_gt_database``), so the sampler pastes
each object in its box; JAX's stores the points inline and the sampler
pastes them at the sensor.
"""

import pickle
import struct
from pathlib import Path

import numpy as np

from ...utils import box_utils
from ..augmentor.database_sampler import write_gt_database
from ..dataset import DatasetTemplate
from .calibration_kitti import Calibration
from .object3d_kitti import get_objects_from_label

KITTI_IMAGE_SHAPE = (375, 1242)


def info_calibration(info):
    """The Calibration of an info's 'calib' block."""
    c = info["calib"]
    return Calibration({"P2": c["P2"][:3], "R0": c["R0_rect"][:3, :3],
                        "Tr_velo2cam": c["Tr_velo_to_cam"][:3]})


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None, logger=None):
        super().__init__(dataset_cfg=dataset_cfg, class_names=class_names, training=training,
                         root_path=root_path, logger=logger)
        self.infos = []
        self.include_kitti_data(self.mode)

    def include_kitti_data(self, mode):
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
            self.logger.info("loaded %d KITTI infos (%s)", len(self.infos), mode)

    # ---- raw files ---------------------------------------------------------
    def split_name(self):
        return self.dataset_cfg.get("DATA_SPLIT", {}).get(self.mode, "train")

    def root_split_path(self):
        """root/training (root/testing for the 'test' split), or the root
        itself where that directory does not exist."""
        cand = Path(self.root_path) / ("testing" if self.split_name() == "test" else "training")
        return cand if cand.exists() else Path(self.root_path)

    def get_lidar(self, lidar_idx):
        path = self.root_split_path() / "velodyne" / f"{lidar_idx}.bin"
        return np.fromfile(str(path), dtype=np.float32).reshape(-1, 4)

    def get_calib(self, idx):
        return Calibration(str(self.root_split_path() / "calib" / f"{idx}.txt"))

    def get_label(self, idx):
        return get_objects_from_label(str(self.root_split_path() / "label_2" / f"{idx}.txt"))

    def get_image_shape(self, idx):
        """(H, W) from image_2/<idx>.png's header, else KITTI's 375 x 1242."""
        p = self.root_split_path() / "image_2" / f"{idx}.png"
        if p.exists():
            with open(p, "rb") as f:
                head = f.read(24)
            w, h = struct.unpack(">II", head[16:24])
            return np.asarray([h, w], dtype=np.int32)
        return np.asarray(KITTI_IMAGE_SHAPE, dtype=np.int32)

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        """The points that project into the image, in front of the camera."""
        pts_img, depth = calib.rect_to_img(pts_rect)
        return ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
                & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0]) & (depth >= 0))

    def get_raw_scene(self, index):
        """(points, gt_boxes, gt_names) of a frame, DontCare rows dropped;
        with FOV_POINTS_ONLY the points the camera sees."""
        info = self.infos[index]
        points = self.get_lidar(info["point_cloud"]["lidar_idx"])
        if self.dataset_cfg.get("FOV_POINTS_ONLY", False) and "calib" in info:
            calib = info_calibration(info)
            points = points[self.get_fov_flag(calib.lidar_to_rect(points[:, :3]),
                                              info["image"]["image_shape"], calib)]
        annos = info.get("annos", {})
        gt_boxes = np.asarray(annos.get("gt_boxes_lidar", np.zeros((0, 7))), dtype=np.float32)
        gt_names = np.asarray(annos.get("name", []))
        keep = gt_names != "DontCare"
        return points, gt_boxes[keep[: len(gt_boxes)]], gt_names[keep]

    # ---- infos -------------------------------------------------------------
    def get_infos(self, has_label=True, count_inside_pts=True, sample_id_list=None):
        """Info dicts of a raw tree (calib, label_2, velodyne) for the frames
        of ImageSets/<split>.txt (else every velodyne file)."""
        if sample_id_list is None:
            ids_file = self.root_split_path().parent / "ImageSets" / f"{self.split_name()}.txt"
            if ids_file.exists():
                sample_id_list = [ln.strip() for ln in open(ids_file) if ln.strip()]
            else:
                sample_id_list = sorted(
                    p.stem for p in (self.root_split_path() / "velodyne").glob("*.bin"))
        return [self._frame_info(idx, has_label, count_inside_pts) for idx in sample_id_list]

    def _frame_info(self, idx, has_label, count_inside_pts):
        calib = self.get_calib(idx)
        r0 = np.eye(4, dtype=np.float32)
        r0[:3, :3] = calib.R0
        info = {
            "point_cloud": {"num_features": 4, "lidar_idx": idx},
            "image": {"image_idx": idx, "image_shape": self.get_image_shape(idx)},
            "calib": {"P2": np.vstack([calib.P2, [0.0, 0.0, 0.0, 1.0]]), "R0_rect": r0,
                      "Tr_velo_to_cam": np.vstack([calib.V2C, [0.0, 0.0, 0.0, 1.0]])},
        }
        if not has_label:
            return info
        objs = self.get_label(idx)
        ann = {
            "name": np.asarray([o.cls_type for o in objs]),
            "truncated": np.asarray([o.truncation for o in objs]),
            "occluded": np.asarray([o.occlusion for o in objs]),
            "alpha": np.asarray([o.alpha for o in objs]),
            "bbox": np.asarray([o.box2d for o in objs]).reshape(-1, 4),
            "dimensions": np.asarray([[o.l, o.h, o.w] for o in objs]).reshape(-1, 3),
            "location": np.asarray([o.loc for o in objs]).reshape(-1, 3),
            "rotation_y": np.asarray([o.ry for o in objs]),
            "score": np.asarray([o.score for o in objs]),
            "difficulty": np.asarray([o.level for o in objs], np.int32),
        }
        num_obj = sum(1 for o in objs if o.cls_type != "DontCare")
        ann["index"] = np.asarray(list(range(num_obj)) + [-1] * (len(objs) - num_obj), np.int32)
        loc, dims = ann["location"][:num_obj], ann["dimensions"][:num_obj]
        rots = ann["rotation_y"][:num_obj]
        loc_lidar = calib.rect_to_lidar(loc) if num_obj else loc
        l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
        if num_obj:
            loc_lidar[:, 2] += h[:, 0] / 2
        ann["gt_boxes_lidar"] = np.concatenate(
            [loc_lidar, l, w, h, -(np.pi / 2 + rots[:, None])], axis=1).astype(np.float32)
        if count_inside_pts and num_obj:
            member = box_utils.points_in_boxes_numpy(self.get_lidar(idx)[:, :3],
                                                     ann["gt_boxes_lidar"])
            cnt = member.sum(axis=1)
            ann["num_points_in_gt"] = np.concatenate(
                [cnt, -np.ones(len(objs) - num_obj, dtype=cnt.dtype)])
        info["annos"] = ann
        return info

    # ---- samples, predictions, metric ---------------------------------------
    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        points, gt_boxes, gt_names = self.get_raw_scene(index)
        return self.prepare_data({"points": points, "gt_boxes": gt_boxes, "gt_names": gt_names,
                                  "frame_id": self.infos[index]["point_cloud"]["lidar_idx"]})

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names, output_path=None):
        """Detections -> KITTI annos: lidar boxes, and for a frame with
        calibration the camera boxes, the projected 2D box and alpha; with
        ``output_path`` one label-format ``<frame>.txt`` per frame."""
        by_id = {inf["point_cloud"]["lidar_idx"]: inf for inf in self.infos}
        annos = []
        for i, pd in enumerate(pred_dicts):
            mask = np.asarray(pd["pred_mask"]).astype(bool)
            boxes = np.asarray(pd["pred_boxes"])[mask][:, :7]
            scores = np.asarray(pd["pred_scores"])[mask]
            labels = np.asarray(pd["pred_labels"])[mask].astype(int)
            names = np.asarray([class_names[max(lb - 1, 0)] for lb in labels])
            frame_id = batch_dict["frame_id"][i] if "frame_id" in batch_dict else i
            anno = {"name": names, "score": scores, "boxes_lidar": boxes, "frame_id": frame_id,
                    "pred_labels": labels}
            info = by_id.get(frame_id)
            if info is not None and "calib" in info and len(boxes):
                calib = info_calibration(info)
                cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
                img = box_utils.boxes3d_kitti_camera_to_imageboxes(
                    cam, calib, image_shape=info["image"]["image_shape"])
                anno.update(alpha=-np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6], bbox=img,
                            dimensions=cam[:, 3:6], location=cam[:, 0:3], rotation_y=cam[:, 6])
                if output_path is not None:
                    self._write_labels(Path(output_path) / f"{frame_id}.txt", anno)
            annos.append(anno)
        return annos

    @staticmethod
    def _write_labels(path, anno):
        path.parent.mkdir(parents=True, exist_ok=True)
        cam = np.concatenate([anno["dimensions"], anno["location"],
                              anno["rotation_y"][:, None]], axis=1)
        with open(path, "w") as f:
            for k in range(len(cam)):
                f.write("%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f "
                        "%.4f\n" % (anno["name"][k], anno["alpha"][k], *anno["bbox"][k],
                                    cam[k, 1], cam[k, 2], cam[k, 0], *cam[k, 3:6], cam[k, 6],
                                    anno["score"][k]))

    def evaluation(self, det_annos, class_names, **kwargs):
        """The KITTI metric of ``det_annos`` against this split's infos, frame
        by frame in order: the full annos (DontCare rows, occlusion,
        truncation, 2D boxes) go to ``kitti_eval``, which applies the
        difficulty and DontCare rules itself; names compare in lower case."""
        from ...utils.kitti_eval_native import kitti_eval

        gt_annos = []
        for info in self.infos:
            annos = info.get("annos", {})
            names = np.asarray(annos.get("name", []))
            is_dc = names == "DontCare"
            boxes = np.asarray(annos.get("gt_boxes_lidar", np.zeros((0, 7))))
            boxes_full = np.zeros((len(names), 7), np.float32)
            boxes_full[~is_dc] = boxes[: int((~is_dc).sum())]
            g = {"boxes_lidar": boxes_full,
                 "name": np.asarray([str(n) if str(n) == "DontCare" else str(n).lower()
                                     for n in names])}
            for k in ("bbox", "occluded", "truncated", "alpha", "difficulty"):
                if k in annos:
                    g[k] = np.asarray(annos[k])
            gt_annos.append(g)
        det_annos = [dict(d, name=np.asarray([str(n).lower() for n in d["name"]]))
                     for d in det_annos]
        return kitti_eval(det_annos, gt_annos, [c.lower() for c in class_names])

    def create_groundtruth_database(self, used_classes=None, out_path=None):
        """The gt database of this dataset's frames for ``gt_sampling``,
        written to ``out_path`` with one box-relative ``.bin`` per object
        (``write_gt_database``). Returns {class: [info]}."""
        if out_path is None:
            raise ValueError("the gt database is written as files: give out_path")
        scenes = ((info["point_cloud"]["lidar_idx"], *self.get_raw_scene(i))
                  for i, info in enumerate(self.infos))
        return write_gt_database(scenes, used_classes or self.class_names, out_path)
