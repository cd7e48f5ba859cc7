"""Inter-domain point-cloud mixing (TODA stage 1), host numpy.

The port's own copy of ``toda_tpu/datasets/processor/inter_domain_mix.py``:
``cutmix`` (:39), ``polarmix`` (:236) with its sector-width schedule over
``train_percent`` (:119-233), ``lasermix`` (:320) and ``pseudomix`` (:415).
Every random draw is made in the same order from the same generator, so the
two packages mix the same scenes identically under one ``np.random`` seed.

All functions take and return plain numpy (points, gt_boxes, gt_names)
dicts and never mutate their inputs; each takes an ``rng`` (default the
global ``np.random``).
"""

import numpy as np

from ...utils import box_utils


def _angles(points):
    return np.arctan2(points[:, 1], points[:, 0])


def _pitch(points):
    rho = np.linalg.norm(points[:, :2], axis=1)
    return np.arctan2(points[:, 2], rho)


def _split(points, boxes, names, point_mask, box_mask):
    return points[point_mask], boxes[box_mask], names[box_mask]


def cutmix(src, tgt, pc_range=None, min_points=10000, max_tries=100, rng=None):
    """Swap an XY window between source and target scenes.

    Reference semantics (inter_domain_point_cutmix.py:10-90):
      * per-axis crop fractions 0.5 + U(0, 0.5) of the full pc_range extent,
        redrawn until their aspect ratio >= 0.75 (check_aspect2D)
      * window centered on a randomly chosen SOURCE point
      * window accepted once it contains > ``min_points`` target points (the
        reference hard-codes 10000 and loops forever; we cap at ``max_tries``
        and fall back to the densest window seen — required for small scenes)
      * box membership: mask_boxes_outside_range_numpy over the 3D window
        [min_xy, pc_z_min, max_xy, pc_z_max] with min_num_corners=1
      * output = source points outside the window + target points inside

    src/tgt: dicts with points (N, C), gt_boxes (M, 7+), gt_names (M,).
    """
    rng = rng or np.random
    sp, sb, sn = src["points"], src["gt_boxes"], src["gt_names"]
    tp, tb, tn = tgt["points"], tgt["gt_boxes"], tgt["gt_names"]
    if pc_range is None:
        span = np.abs(np.concatenate([sp[:, :2], tp[:, :2]])).max(axis=0) if len(sp) else np.array([50.0, 50.0])
        pc_range = np.array([-span[0], -span[1], -5.0, span[0], span[1], 5.0], np.float64)
    pc_range = np.asarray(pc_range, np.float64)
    range_xy = pc_range[3:5] - pc_range[0:2]

    crop = 0.5 + rng.rand(2) * 0.5
    tries = 0
    while not (np.min(crop[:2]) / np.max(crop[:2]) >= 0.75):
        crop = 0.5 + rng.rand(2) * 0.5
        tries += 1
        if tries > 100:
            break

    best = None  # (count, lo, hi)
    for _ in range(max_tries):
        center = sp[rng.choice(len(sp)), 0:3] if len(sp) else np.zeros(3)
        half = range_xy * crop / 2.0
        lo, hi = center[:2] - half, center[:2] + half

        t_in_count = int(
            ((tp[:, 0] < hi[0]) & (tp[:, 1] < hi[1])
             & (tp[:, 0] > lo[0]) & (tp[:, 1] > lo[1])).sum()
        ) if len(tp) else 0
        if best is None or t_in_count > best[0]:
            best = (t_in_count, lo, hi)
        if t_in_count > min_points:
            break
    _, lo, hi = best

    def in_window(pts):
        if not len(pts):
            return np.zeros(0, bool)
        return (
            (pts[:, 0] < hi[0]) & (pts[:, 1] < hi[1])
            & (pts[:, 0] > lo[0]) & (pts[:, 1] > lo[1])
        )

    t_in = in_window(tp)
    s_in = in_window(sp)

    region = np.array([lo[0], lo[1], pc_range[2], hi[0], hi[1], pc_range[5]])

    def box_in_window(boxes):
        if not len(boxes):
            return np.zeros(0, bool)
        return box_utils.mask_boxes_outside_range_numpy(
            np.asarray(boxes), region, min_num_corners=1
        )

    sb_in = box_in_window(sb)
    tb_in = box_in_window(tb)

    mixed_points = np.concatenate([tp[t_in], sp[~s_in]])
    mixed_boxes = np.concatenate([sb[~sb_in], tb[tb_in]]) if len(sb) or len(tb) else sb
    mixed_names = np.concatenate([sn[~sb_in], tn[tb_in]])
    return {
        "points": mixed_points, "gt_boxes": mixed_boxes, "gt_names": mixed_names,
    }


def _sector_width_schedule(method, train_percent, degree=(np.pi / 6, np.pi),
                           rng=None):
    """Curriculum sector width over a (lo, hi) degree range (reference
    FIX|RAND|ASC|ASC_SIG|DESC, inter_domain_point_polarmix.py:19-21,258-268:
    FIX=lo, RAND=U(lo,hi), ASC=lo+(hi-lo)t, ASC_SIG with sig_polar alpha 6,
    DESC=hi-(hi-lo)t)."""
    rng = rng or np.random
    t = float(np.clip(train_percent, 0.0, 1.0))
    lo, hi = (degree, degree) if np.isscalar(degree) else (
        (degree[0], degree[0]) if len(degree) == 1 else (degree[0], degree[1]))
    if method == "RAND":
        return rng.uniform(lo, hi)
    if method == "ASC":
        return lo + t * (hi - lo)
    if method == "ASC_SIG":
        sig = 1.0 / (1.0 + np.exp(-6 * (2 * t - 1)))
        return lo + sig * (hi - lo)
    if method == "DESC":
        return hi - t * (hi - lo)
    return lo  # FIX / unknown


def _place_sectors(methods, train_percent, degree, rng):
    """Non-overlapping (start, width) sectors, one per schedule entry
    (reference inter_domain_point_polarmix.py:257-285: 100 placement
    retries, skip on persistent overlap). Angles are mod-2pi intervals."""
    sectors = []
    for m in methods:
        width = _sector_width_schedule(m, train_percent, degree, rng)
        for _ in range(100):
            start = rng.uniform(-np.pi, np.pi)
            ok = True
            for s0, w0 in sectors:
                rel = (start - s0) % (2 * np.pi)
                if rel < w0 or rel > 2 * np.pi - width:
                    ok = False
                    break
            if ok:
                sectors.append((start, width))
                break
    return sectors


def _sector_swap(sp, sb, sn, tp, tb, tn, start, width, inc_method, use_pitch,
                 dist_mask=None):
    """One azimuth-sector swap: sector points/boxes of the accumulated source
    scene are replaced by the target's (reference swap :44-94).

    inc_method:
      center     — a box belongs to the sector iff its CENTER yaw is inside;
      corner     — source boxes are removed if ANY corner is inside, target
                   boxes are adopted only if ALL corners are inside;
      corner_del — like corner, plus points of partially-included boxes are
                   deleted from both scenes (no half-objects survive).
    use_pitch (reference :80-94): additionally transfer target points OUTSIDE
    the sector whose pitch falls outside the source scan's pitch band — moves
    the target sensor's extra beams into the mixed scene.
    dist_mask: optional fn(xy_array) -> bool mask composed with sector
    membership (the POLARMIX_DIS='RAND' distance threshold, reference
    swap_with_range :97-160 — which uses center inclusion).
    """

    def in_sector(ang):
        rel = (ang - start) % (2 * np.pi)
        return rel <= width

    def member(arr2d, ang_mask):
        return ang_mask & dist_mask(arr2d) if dist_mask is not None else ang_mask

    def corners_in_sector(boxes):
        """(M, 8) per-corner sector membership on the BEV corners."""
        if not len(boxes):
            return np.zeros((0, 8), bool)
        corners = box_utils.boxes_to_corners_3d(boxes[:, :7])[:, :, :2]
        return in_sector(np.arctan2(corners[..., 1], corners[..., 0]))

    if inc_method == "center" or dist_mask is not None:
        sb_out = member(sb[:, :2], in_sector(np.arctan2(sb[:, 1], sb[:, 0]))) \
            if len(sb) else np.zeros(0, bool)
        tb_in = member(tb[:, :2], in_sector(np.arctan2(tb[:, 1], tb[:, 0]))) \
            if len(tb) else np.zeros(0, bool)
    elif inc_method in ("corner", "corner_del"):
        s_c = corners_in_sector(sb)
        t_c = corners_in_sector(tb)
        sb_out = s_c.any(axis=1) if len(sb) else np.zeros(0, bool)  # drop if ANY corner in
        tb_in = t_c.all(axis=1) if len(tb) else np.zeros(0, bool)  # adopt if ALL corners in
        if inc_method == "corner_del":
            s_partial = s_c.any(axis=1) & ~s_c.all(axis=1) if len(sb) else np.zeros(0, bool)
            t_partial = t_c.any(axis=1) & ~t_c.all(axis=1) if len(tb) else np.zeros(0, bool)
            if s_partial.any():
                sp = box_utils.remove_points_in_boxes3d(sp, sb[s_partial][:, :7])
            if t_partial.any():
                tp = box_utils.remove_points_in_boxes3d(tp, tb[t_partial][:, :7])
    else:
        raise NotImplementedError(inc_method)

    s_in = member(sp[:, :2], in_sector(_angles(sp)))
    t_take = member(tp[:, :2], in_sector(_angles(tp)))
    if use_pitch and len(sp):
        s_rho = np.linalg.norm(sp[:, :2], axis=1)
        t_rho = np.linalg.norm(tp[:, :2], axis=1)
        s_pitch = _pitch(sp)[s_rho > 1]
        if len(s_pitch):
            t_pitch = _pitch(tp)
            band_transfer = (
                ~t_take
                & (t_rho > 1)
                & ((t_pitch < s_pitch.min()) | (t_pitch > s_pitch.max()))
            )
            t_take = t_take | band_transfer

    points = np.concatenate([sp[~s_in], tp[t_take]])
    boxes = np.concatenate([sb[~sb_out], tb[tb_in]])
    names = np.concatenate([sn[~sb_out], tn[tb_in]])
    return points, boxes, names


def polarmix(src, tgt, train_percent=0.0, width_method="FIX",
             degree=(np.pi / 6, np.pi), rot_copy_num=1, polar_dis="FULL",
             range_max=60.0, instance_paste=True, inc_method="center",
             use_pitch=False, rng=None):
    """Azimuth-sector swap(s) + instance rotate-paste (reference
    inter_domain_point_polarmix.py:193-300).

    width_method: one schedule name or a list — ONE non-overlapping sector is
    placed per entry (reference POLARMIX_UPDATE_METHOD, e.g. [FIX, FIX, FIX]).
    degree: (lo, hi) sector-width range fed to the schedules (POLARMIX_DEGREE).
    rot_copy_num: 0-3 instance rotate-paste copies at Omega = [0, U(0, 2pi/3),
    2pi/3 + U(0, 2pi/3)] (POLARMIX_RC_NUM; reference :288-289 — the first
    copy is UNROTATED, deduplicated by BEV IoU against existing boxes).
    polar_dis: 'FULL' swaps the whole sector; 'RAND' draws a distance
    threshold dis_th = U(0, range_max) and swaps only the near side when
    dis_th/range_max > 0.4, else the far side (reference swap_with_range).
    """
    rng = rng or np.random
    sp, sb, sn = src["points"], src["gt_boxes"], src["gt_names"]
    tp, tb, tn = tgt["points"], tgt["gt_boxes"], tgt["gt_names"]

    methods = [width_method] if isinstance(width_method, str) else list(width_method)
    sectors = _place_sectors(methods, train_percent, degree, rng)

    points, boxes, names = sp, sb, sn
    for start, width in sectors:
        dist_mask = None
        if polar_dis == "RAND":
            # a FRESH distance threshold per sector (reference swap_with_range
            # draws dis_th at the top of every call, :102)
            dis_th = rng.random() * range_max

            def dist_mask(xy, _th=dis_th):  # noqa: F811
                rho = np.linalg.norm(np.asarray(xy)[:, :2], axis=1)
                return rho < _th if _th / range_max > 0.4 else rho > _th

        points, boxes, names = _sector_swap(
            points, boxes, names, tp, tb, tn, start, width, inc_method,
            use_pitch, dist_mask=dist_mask,
        )

    if instance_paste and rot_copy_num > 0 and len(tb):
        # reference rotate_copy (:153-190): per omega, rotate ALL target boxes,
        # drop copies with nonzero rotated-BEV overlap vs everything placed so
        # far (mixed boxes + earlier copies), extract the points of the KEPT
        # originals in one union mask, rotate them; after all omegas, carve
        # every copy footprint out of the mixed cloud once and append.
        omegas = [0.0, rng.uniform(0, 2 * np.pi / 3),
                  2 * np.pi / 3 + rng.uniform(0, 2 * np.pi / 3)][:rot_copy_num]
        labels_exist = [boxes] if len(boxes) else []
        pts_copy, boxes_copy, names_copy = [], [], []
        for rot in omegas:
            cos, sin = np.cos(rot), np.sin(rot)
            rot_xy = np.array([[cos, sin], [-sin, cos]])  # row-vector CCW
            new_b = tb.copy()
            new_b[:, :2] = tb[:, :2] @ rot_xy
            new_b[:, 6] += rot
            if new_b.shape[1] > 8:
                new_b[:, 7:9] = tb[:, 7:9] @ rot_xy
            if labels_exist:
                exist = np.concatenate(labels_exist)
                overlap = box_utils.boxes_bev_iou_cpu(exist[:, :7], new_b[:, :7])
                keep = overlap.sum(axis=0) == 0
            else:
                keep = np.ones(len(new_b), bool)
            new_b = new_b[keep]
            if not len(new_b):
                continue
            labels_exist.append(new_b)
            pmask = box_utils.points_in_boxes_numpy(tp, tb[keep][:, :7]).any(axis=0)
            obj = tp[pmask].copy()
            obj[:, :2] = obj[:, :2] @ rot_xy
            pts_copy.append(obj)
            boxes_copy.append(new_b)
            names_copy.append(tn[keep])
        if boxes_copy:
            nb = np.concatenate(boxes_copy)
            points = box_utils.remove_points_in_boxes3d(points, nb[:, :7])
            points = np.concatenate([points] + pts_copy)
            boxes = np.concatenate([boxes, nb])
            names = np.concatenate([names, np.concatenate(names_copy)])
    return {"points": points, "gt_boxes": boxes, "gt_names": names}


def lasermix(src, tgt, mode="spherical", num_regions=6, pitch_range=(-0.4, 0.2),
             range_max=60.0, inc_method="center", rng=None,
             num_areas=None, num_angles=None, pitch_angles_deg=None,
             sensor_height=1.8):
    """Interleaved region swap: alternate regions come from alternate domains.

    Reference knob forms (inter_domain_point_lasermix.py:1-195, stage1
    configs): LASERMIX_NUM_AREAS (`num_areas`, int or list — a list is
    sampled uniformly per call), LASERMIX_NUM_ANGLES (`num_angles` — when
    set, the cylindrical checkerboard over num_angles azimuth sectors with a
    random phase x num_areas radial rings, cell domain = (sector+ring)
    parity), LASERMIX_PITCH_ANGLE (`pitch_angles_deg`, DEGREES — spherical
    pitch bands measured about a sensor `sensor_height` above the origin,
    reference :24 `arctan2(z - 1.8, rho)`). Without these, the legacy
    (mode, num_regions, pitch_range-radians) form applies.

    inc_method (reference :100-125 corner_del branch): 'center' keeps a box
    iff its center region has the domain's parity; 'corner_del' keeps it
    only if ALL its corners agree, and deletes the points of
    partially-spanning boxes so no half-object survives.
    """
    rng = rng or np.random
    sp, sb, sn = src["points"], src["gt_boxes"], src["gt_names"]
    tp, tb, tn = tgt["points"], tgt["gt_boxes"], tgt["gt_names"]
    offset = rng.randint(2)

    na = num_areas if num_areas is not None else num_regions
    if isinstance(na, (list, tuple, np.ndarray)):
        na = int(rng.choice(list(na)))
    na = int(na)

    if num_angles is not None:  # reference cylindrical checkerboard
        phase = rng.uniform(-np.pi, np.pi)
        dis_edges = np.linspace(0.0, range_max, na + 1)

        def region_of(pts):
            a = (_angles(pts) + phase + np.pi) % (2 * np.pi)
            yi = np.floor(a / (2 * np.pi) * num_angles).astype(int)
            r = np.clip(np.linalg.norm(pts[:, :2], axis=1), 1e-5, range_max - 1e-5)
            ri = np.digitize(r, dis_edges) - 1
            return yi + ri
    elif pitch_angles_deg is not None:  # reference spherical (degrees)
        lo, hi = np.radians(pitch_angles_deg[0]), np.radians(pitch_angles_deg[1])
        edges = np.linspace(lo, hi, na + 1)

        def region_of(pts):
            rho = np.linalg.norm(pts[:, :2], axis=1)
            pr = np.arctan2(pts[:, 2] - sensor_height, rho)
            pr = np.clip(pr, lo + 1e-6, hi - 1e-6)
            return np.digitize(pr, edges) - 1
    elif mode == "spherical":
        edges = np.linspace(pitch_range[0], pitch_range[1], num_regions + 1)

        def region_of(pts):
            pr = np.clip(_pitch(pts), pitch_range[0], pitch_range[1] - 1e-6)
            return np.digitize(pr, edges) - 1
    else:  # legacy cylindrical: yaw x range grid
        def region_of(pts):
            a = (_angles(pts) + np.pi) / (2 * np.pi)
            r = np.clip(np.linalg.norm(pts[:, :2], axis=1) / range_max, 0, 1 - 1e-6)
            return (np.floor(a * num_regions).astype(int) + np.floor(r * 2).astype(int))

    def take(pts, parity):
        return region_of(pts) % 2 == parity

    def box_membership(boxes, parity):
        """(kept_mask, partial_mask) under the configured inclusion rule."""
        if not len(boxes):
            z = np.zeros(0, bool)
            return z, z
        if inc_method == "center":
            kept = region_of(boxes[:, :3]) % 2 == parity
            return kept, np.zeros(len(boxes), bool)
        corners = box_utils.boxes_to_corners_3d(boxes[:, :7])  # (M, 8, 3)
        par = region_of(corners.reshape(-1, 3)).reshape(len(boxes), 8) % 2 == parity
        kept = par.all(axis=1)
        partial = par.any(axis=1) & ~kept
        return kept, partial

    sm, s_partial = box_membership(sb, offset)
    tm, t_partial = box_membership(tb, 1 - offset)
    s_pts = sp[take(sp, offset)]
    t_pts = tp[take(tp, 1 - offset)]
    if inc_method == "corner_del":
        if s_partial.any():
            s_pts = box_utils.remove_points_in_boxes3d(s_pts, sb[s_partial][:, :7])
        if t_partial.any():
            t_pts = box_utils.remove_points_in_boxes3d(t_pts, tb[t_partial][:, :7])

    points = np.concatenate([s_pts, t_pts])
    boxes = np.concatenate([sb[sm], tb[tm]])
    names = np.concatenate([sn[sm], tn[tm]])
    return {"points": points, "gt_boxes": boxes, "gt_names": names}


def pseudomix(src, tgt, method="pseudobbox", rng=None):
    """pseudobbox: paste non-colliding target boxes+points into the source
    scene (reference inter_domain_point_pseudobbox, :19-47: keep target boxes
    with exactly ZERO rotated-BEV overlap vs every source box, carve their
    footprints out of the source cloud, append their points).
    pseudobackground: paste ALL source foreground objects onto the target
    background (reference :49-68 — no collision check; output boxes are the
    source boxes only)."""
    sp, sb, sn = src["points"], src["gt_boxes"], src["gt_names"]
    tp, tb, tn = tgt["points"], tgt["gt_boxes"], tgt["gt_names"]

    if method == "pseudobbox":
        if len(sb) and len(tb):
            overlap = box_utils.boxes_bev_iou_cpu(sb[:, :7], tb[:, :7])
            keep = overlap.sum(axis=0) == 0
        else:
            keep = np.ones(len(tb), bool)
        kept_b, kept_n = tb[keep], tn[keep]
        t_fg = box_utils.points_in_boxes_numpy(tp, kept_b).any(axis=0) if len(kept_b) \
            else np.zeros(len(tp), bool)
        s_keep = ~box_utils.points_in_boxes_numpy(sp, kept_b).any(axis=0) if len(kept_b) \
            else np.ones(len(sp), bool)
        points = np.concatenate([sp[s_keep], tp[t_fg]])
        boxes = np.concatenate([sb, kept_b])
        names = np.concatenate([sn, kept_n])
    else:  # pseudobackground
        t_bg = ~box_utils.points_in_boxes_numpy(tp, tb[:, :7]).any(axis=0) if len(tb) \
            else np.ones(len(tp), bool)
        s_fg = box_utils.points_in_boxes_numpy(sp, sb[:, :7]).any(axis=0) if len(sb) \
            else np.zeros(len(sp), bool)
        points = np.concatenate([sp[s_fg], tp[t_bg]])
        boxes = sb
        names = sn
    return {"points": points, "gt_boxes": boxes, "gt_names": names}
