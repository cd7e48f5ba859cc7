"""KITTI calibration: lidar <-> rectified camera <-> image.

The port's own copy of ``toda_tpu/datasets/kitti/calibration_kitti.py``. A
point goes lidar --Tr_velo_to_cam--> camera 0 --R0_rect--> rectified --P2-->
image; host numpy.
"""

import numpy as np


def get_calib_from_file(calib_file):
    """A KITTI calib text file, lines P0 P1 P2 P3 R0_rect Tr_velo_to_cam."""
    with open(calib_file) as f:
        lines = [ln.strip() for ln in f.readlines()]

    def vals(line):
        return np.array(line.split(" ")[1:], dtype=np.float32)

    return {"P2": vals(lines[2]).reshape(3, 4), "P3": vals(lines[3]).reshape(3, 4),
            "R0": vals(lines[4]).reshape(3, 3), "Tr_velo2cam": vals(lines[5]).reshape(3, 4)}


class Calibration:
    def __init__(self, calib):
        if not isinstance(calib, dict):
            calib = get_calib_from_file(calib)
        self.P2 = np.asarray(calib["P2"], dtype=np.float32)  # (3, 4)
        self.R0 = np.asarray(calib["R0"], dtype=np.float32)  # (3, 3)
        self.V2C = np.asarray(calib["Tr_velo2cam"], dtype=np.float32)  # (3, 4)
        self.cu, self.cv = self.P2[0, 2], self.P2[1, 2]
        self.fu, self.fv = self.P2[0, 0], self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def _hom(pts):
        return np.hstack([pts, np.ones((pts.shape[0], 1), dtype=pts.dtype)])

    def _rect_to_lidar_mat(self):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.R0
        v = np.eye(4, dtype=np.float32)
        v[:3, :4] = self.V2C
        return np.linalg.inv(m @ v)

    def lidar_to_rect(self, pts_lidar):
        """(N, 3) lidar -> (N, 3) rectified camera."""
        return self._hom(np.asarray(pts_lidar, np.float32)) @ self.V2C.T @ self.R0.T

    def rect_to_lidar(self, pts_rect):
        """(N, 3) rectified camera -> (N, 3) lidar."""
        hom = self._hom(np.asarray(pts_rect, np.float32))
        return (self._rect_to_lidar_mat() @ hom.T).T[:, :3]

    def rect_to_img(self, pts_rect):
        """(N, 3) rectified -> ((N, 2) pixels, (N,) depth). The pixels divide
        by the rectified z, not the projected w (the two differ by P2[2, 3])."""
        pts_rect = np.asarray(pts_rect, np.float32)
        hom = self._hom(pts_rect) @ self.P2.T
        return hom[:, :2] / pts_rect[:, 2:3], hom[:, 2] - self.P2[2, 3]

    def lidar_to_img(self, pts_lidar):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.stack([x, y, depth_rect], axis=1)

    def corners3d_to_img_boxes(self, corners3d):
        """(N, 8, 3) rectified corners -> ((N, 4) [x1, y1, x2, y2], (N, 8, 2))."""
        n = corners3d.shape[0]
        hom = np.concatenate([corners3d, np.ones((n, 8, 1), corners3d.dtype)], axis=2)
        img = hom @ self.P2.T
        xy = img[..., :2] / img[..., 2:3]
        return np.concatenate([xy.min(axis=1), xy.max(axis=1)], axis=1).astype(np.float32), xy
