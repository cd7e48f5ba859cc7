#!/usr/bin/env python3
"""Drive the PyTorch port (``toda_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py   # the phases below, on cuda:0

Phases (none catches its own failure; any failure exits non-zero):
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the slice from ``toda_tpu_torch/csrc`` (one
     nvcc per source, in parallel, into ``build/kernels``);
  3. tiny CenterPoint-Res in f32 on cuda and on cpu with the same weights and
     batch: the head outputs must agree;
  4. full-width CenterPoint-Res (the TODA flagship widths) at the scale of
     bench.py's ``centerpoint`` workload: one forward records the inputs each
     kernel gets on the main path; every kernel is held against its plain
     PyTorch version on those inputs and timed beside it; then K5 exactly
     against its plain version on calls no scene gives
     (``phase_stress_unpack``: a partial last block, sums not 16-byte
     aligned, c = 1 to 64, cpad 5, 6, 8 and 64, f32 and bf16, counts of 0
     and x.5);
  5. with every launch counter at 0, ``eval_one_epoch`` over several batches
     of 4 scans: outputs must be finite and each kernel must have launched
     (K1 11 times per forward); then the steady-state predict throughput and
     peak memory;
  6. a torch.profiler window over two predict steps: kernel time by name and
     the device's busy share of the steady step;
  7. tiny CenterPoint-Res in f32: three train steps on cuda and on cpu from
     the same weights and batch: losses and parameters must agree;
  8. full-width training (batch 4, augmentor on): one recorded train step
     feeds each backward kernel's inputs (K2's dx and dW on every layer, K3:
     dW of the four raw-input layers, K6) to it and to its plain version; a
     second dW run must be bit-equal to the first; every K1, dx and dW call
     logs its share of present (pillar, tap) pairs; then K1, dx and dW on
     stress tables no scene gives (``phase_stress_tables``: dense planes
     with every tap present, pillars with no taps, lone pillars, an odd M,
     the first conv's C = 8 raw, both strides) at stage-1 and stage-3
     widths, held to the same tolerances;
  9. with every launch counter at 0, 20 ``make_train_step`` steps: launches
     per step asserted, losses finite; then the steady train throughput
     (loss read back every step) and peak memory;
 10. a torch.profiler window over two train steps;
 11. tiny CenterPoint-Res in f32 (``phase_toda_tiny``): the points gradient
     of the eval-mode loss (the pseudo-label perturbation's) and one
     ``make_train_step_cl`` step, cuda vs cpu;
 12. the real-format data path (``phase_data``): nuScenes (raw tables,
     10-sweep HDL-32E scans) and Waymo (``.tfrecord`` range images)
     fabricated from the seed into a temporary directory under build/
     (removed at exit), infos and gt databases from the port's
     ``create_infos``, the labelled-percentage splits; every split the
     stage configs read holds two batches; the host loader's rate, points
     a scan before and after ``sample_points`` and occupied pillars against
     MAX_PILLARS logged; then the TODA stages at full width on the stage
     configs' own Waymo and nuScenes domain configs over those files
     (``phase_toda``, ``toda_cfgs``): stage 1 through ``train_model`` over
     one epoch of the CutMix loader, its checkpoint round trip, the fused
     convs' calls of one stage-1 forward and train step held against their
     plain versions (logged, not summed into the kernels line),
     ``generate_pseudo_labels`` with the perturbation over the unlabelled
     split (the first conv's act=False dx and K4's VJP, a K6 gather, held
     against their plain versions), stage-2 ``make_train_step_cl`` steps
     with the pseudo frames read through their 'frame_info'; launches per
     step asserted, scans/s, peak memory, profiles; then two stage-2 steps
     on the pseudo labels taken at score 0 (box-bearing frames, the
     consistency matched at score 0): both consistency terms nonzero; then
     the same recipe through the port's CLIs (``phase_cli``): the stage-1,
     pseudo-label, stage-2 CL and test ``main``s on the same configs written
     as YAML files, each stage's launches asserted, its checkpoint, the
     pseudo-info pickle's structure and the nuScenes metric's keys (finite)
     checked, each stage's wall time logged;
     Between the TODA stages and their CLIs, TODA's nuScenes -> KITTI track
     (``phase_kitti``, ``second_iou_cfg``): a KITTI tree fabricated beside
     the nuScenes files (HDL-64E scans, the published calibration text,
     labels of every difficulty), ``create_infos kitti --with_gt_db``; the
     polarmix CutMix loader's rate, points and occupied pillars, and the
     KITTI target's gt_sampling pasting nothing (Car:15 under
     CLASS_NAMES ['car']); the full-width SECOND-IoU's K1, K4, K5 calls of
     one forward and dx, dW, K6 calls of one train step held against their
     plain versions (logged, not in the kernels line), steady train and
     predict rates, peak memory, profiles; then the stage-1 CLI for one
     epoch with its KITTI val eval and ``test``, launches asserted, the
     car AP_R40 of 3D, BEV and bbox finite at the three difficulties;
 13. tiny PartA2 in f32 on cuda and on cpu with the same weights and batch:
     the point and dense head outputs must agree, and the RoI head on the
     cpu's RoIs; once in full f32 and once with cuDNN's TF32 on, the
     precision phases 14-15 run at;
 14. full-width PartA2 (``parta2_cfg``: the Waymo config on synthetic
     scenes): one forward records every K9 call (63) and every decoder K6
     call (27), and each is held against its plain version and timed;
 15. with every launch counter at 0, ``eval_one_epoch`` over 3 batches of
     4 scans: outputs finite, RoI recall reported, launches per forward
     asserted (K9 63, K6 27, K4 1, K5 1); then the steady predict
     throughput, peak memory and a torch.profiler window of two steps;
     Then PartA2's f32 convolutions under cuDNN TF32 at full width: one
     forward with TF32 off and one with it on, the dense head maps and the
     RoI head (on the same RoIs) compared, max relative differences logged
     beside the tiny check's 5e-3 (``phase_parta2_tf32``);
 15b. the ball query exactly against its plain version on calls no scene
     gives (``phase_stress_ball_query``: x_conv4's lattice at 4 x 40,960
     with radii that are multiples of its spacing and an all-invalid scan,
     points on the grid's cell boundaries with queries at exactly the radius
     and outside the cloud, a dense cluster with N not a multiple of 32 and
     nsample 16 to 128); then
     tiny PV-RCNN in f32 (``pvrcnn_synthetic.yaml``) on cuda and on cpu
     with the same weights and batch: FPS keypoints equal, keypoint and head
     outputs and the RoI head on the cpu's RoIs to 1e-3; then PV-RCNN at full
     width (``pvrcnn_cfg``: waymo_models/pv_rcnn.yaml on the synthetic
     scenes): one forward records the FPS call and the 8 ball-query calls,
     each held against its plain version (indices and counts equal) and
     timed; with every counter at 0, ``eval_one_epoch`` over 3 batches of 4
     scans (K1 11, K4 2, K5 1, FPS 1, BQ 8 launches per forward), the steady
     predict throughput, peak memory and a profile with kernel time by
     ``stage:`` range;
 16. tiny SECOND in f32 (``second_tiny``, ``FUSED_CONV: False``): three
     train steps on cuda and on cpu from the same weights and batch; on
     the card the fused contract (K1-K3) on the same weights and batch:
     forward outputs and step-1 gradients must agree; one
     ``pillar_conv3d_t`` with Cout 8 (K8's per-group backward) against its
     cpu run; then K7 and K10 on tables no scene gives
     (``phase_stress_column_gathers``: an odd M, all -1 indices, f32
     tables, every chunk order, M = 2N with no identity tap, N = 1, a
     table not 16-byte aligned, each Cout, C = 8, nz = 1, a tap absent
     from whole blocks, and a dense stage-3 plane at full width), K7
     exactly and K10 at its tolerance against their plain versions;
 17. full-width SECOND (``second_cfg``: the Waymo config on synthetic
     scenes, ``FUSED_CONV: False``): with every launch counter at 0,
     ``eval_one_epoch`` over 3 batches of 4 scans (K7 7, K8 12, K4 2, K5 1
     launches per forward), the steady predict throughput and a profile;
     one recorded train step feeds every K7 (18) and K8 (12) call to its
     kernel and its plain version (exactly equal) and both are timed; K10
     on the forward's seven stride-1 K7 calls (``phase_k10``), against its
     plain version and K7 + the z product; with every counter at 0, train
     steps with their launches asserted (K7 18, K8 12, K4 2, K5 1, K6 1 per
     step), the steady train throughput, peak memory and a profile;
 18. one {"kernels": [...]} line (every kernel's row sums its recorded
     calls over the paths that run it, and its launches over their counted
     runs), then the {"ok": true, "device": ...} line.
Exits non-zero with no result when there is no CUDA device or the port is
missing.
"""

import itertools
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH = 4
N_BATCHES = 5
PARTA2_BATCHES = 3
PVRCNN_BATCHES = 3
SECOND_BATCHES = 3
SECOND_TRAIN_STEPS = 5
SEED = 0
TRAIN_STEPS = 20
SCHEDULE_STEPS = 100  # OneCycle length: every step here stays in its warm-up
TODA_CL_STEPS = 3
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    return out[0]


def base_cfg():
    from toda_tpu_torch.config import EDict, cfg_from_yaml_file

    return cfg_from_yaml_file(
        str(REPO / "tools/cfgs/synthetic_models/centerpoint_synthetic.yaml"), EDict())


def full_cfg():
    """bench.py's ``centerpoint`` workload: range [-54, 54]^2 x [-5, 3],
    voxel (0.075, 0.075, 0.2) -> 1440 x 1440 x 40, 131072 points per scan,
    MAX_PILLARS 49152, 100k background points, 20-40 objects."""
    cfg = base_cfg()
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0]
    for proc in cfg.DATA_CONFIG.DATA_PROCESSOR:
        if proc.NAME == "sample_points":
            proc.NUM_POINTS = {"train": 131072, "test": 131072}
        if proc.NAME == "transform_points_to_voxels":
            proc.VOXEL_SIZE = [0.075, 0.075, 0.2]
            proc.MAX_POINTS_PER_VOXEL = 10
            proc.MAX_NUMBER_OF_VOXELS = {"train": 120000, "test": 120000}
    cfg.MODEL.BACKBONE_3D.MAX_PILLARS = 49152
    cfg.DATA_CONFIG.NUM_BACKGROUND_POINTS = 100000
    cfg.DATA_CONFIG.NUM_OBJECTS = [20, 40]
    cfg.DATA_CONFIG.MAX_GT_BOXES = 64
    cfg.DATA_CONFIG.NUM_SCENES = BATCH * N_BATCHES
    return cfg


def tiny_cfg():
    cfg = base_cfg()
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
    cfg.DATA_CONFIG.DATA_PROCESSOR[2].NUM_POINTS = {"train": 1024, "test": 1024}
    cfg.DATA_CONFIG.DATA_PROCESSOR[3].VOXEL_SIZE = [0.5, 0.5, 0.5]
    cfg.DATA_CONFIG.NUM_SCENES = 2
    cfg.DATA_CONFIG.NUM_OBJECTS = [2, 4]
    m = cfg.MODEL
    m.BACKBONE_3D.CHANNELS = [16, 16, 16, 16]
    m.BACKBONE_3D.MAX_PILLARS = 1024
    m.BACKBONE_3D.BF16 = False
    m.BACKBONE_2D.LAYER_NUMS = [1, 1]
    m.BACKBONE_2D.LAYER_STRIDES = [1, 2]
    m.BACKBONE_2D.NUM_FILTERS = [16, 32]
    m.BACKBONE_2D.UPSAMPLE_STRIDES = [1, 2]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [16, 16]
    return cfg


def parta2_cfg():
    """PartA2 at full width: ``MODEL`` and ``CLASS_NAMES`` of
    tools/cfgs/waymo_models/PartA2.yaml (over waymo_models/second.yaml:
    UNetV2 CHANNELS [16, 32, 64, 64], OUT_CHANNELS 128, BF16, MAX_PILLARS
    65536; BEV LAYER_NUMS [5, 5], NUM_FILTERS [128, 256], NUM_UPSAMPLE_FILTERS
    [256, 256]; 3 classes x 2 rotations of anchors; point head FCs [128];
    RoI pool 12, 128 features, SHARED_FC [256, 256, 256], 100 test RoIs) and
    the Waymo data settings (x, y, z, intensity, elongation; range [-75.2,
    75.2]^2 x [-2, 4]; voxel (0.1, 0.1, 0.15) -> 1504 x 1504 x 40; 196608
    points per scan), with 150k uniform background points, 20-40 objects
    and at most 64 gt boxes a scan. Cuts: synthetic scenes instead of Waymo
    scans (``SyntheticDataset``), no gt_sampling (test mode runs no
    augmentation). The background fills every one of the 65536 pillar
    slots."""
    from toda_tpu_torch.config import EDict, cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / "tools/cfgs/waymo_models/PartA2.yaml"), EDict())
    d = cfg.DATA_CONFIG
    d.DATASET = "SyntheticDataset"
    d.NUM_BACKGROUND_POINTS = 150000
    d.NUM_OBJECTS = [20, 40]
    d.MAX_GT_BOXES = 64
    d.NUM_SCENES = BATCH * PARTA2_BATCHES
    return cfg


def pvrcnn_cfg():
    """PV-RCNN at full width: ``MODEL`` and ``CLASS_NAMES`` of
    tools/cfgs/waymo_models/pv_rcnn.yaml (over waymo_models/second.yaml:
    PillarBackBone8x CHANNELS [16, 32, 64, 64], MAX_PILLARS 65536 (stage caps
    65536 / 32768 / 16384 / 8192), BF16, the fused contract; the BEV backbone
    and the anchor head of SECOND; VoxelSetAbstraction with 4096 FPS
    keypoints, 128 output features, sources bev, x_conv3, x_conv4 and
    raw_points with their MLPS, radii and NSAMPLE; PointHeadSimple CLS_FC
    [256, 256]; PVRCNNHead with a 6^3 grid, pool radii [0.8, 1.6], NSAMPLE
    [16, 16], SHARED_FC / CLS_FC / REG_FC [256, 256]; proposal NMS 1024 ->
    100 at 0.7) and the Waymo data settings of ``parta2_cfg``, on the same
    synthetic scenes (150k uniform background points, 20-40 objects, at most
    64 gt boxes a scan)."""
    from toda_tpu_torch.config import EDict, cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / "tools/cfgs/waymo_models/pv_rcnn.yaml"), EDict())
    d = cfg.DATA_CONFIG
    d.DATASET = "SyntheticDataset"
    d.NUM_BACKGROUND_POINTS = 150000
    d.NUM_OBJECTS = [20, 40]
    d.MAX_GT_BOXES = 64
    d.NUM_SCENES = BATCH * PVRCNN_BATCHES
    return cfg


def second_cfg():
    """SECOND at full width: ``MODEL`` and ``CLASS_NAMES`` of
    tools/cfgs/waymo_models/second.yaml with ``BACKBONE_3D.FUSED_CONV:
    False`` (PillarBackBone8x CHANNELS [16, 32, 64, 64], MAX_PILLARS 65536:
    stage caps 65536, 32768, 16384, 8192 a sample, BF16; HeightCompression;
    BEV LAYER_NUMS [5, 5], NUM_FILTERS [128, 256], NUM_UPSAMPLE_FILTERS
    [256, 256]; AnchorHeadSingle with 3 classes x 2 rotations, the direction
    classifier, AxisAlignedTargetAssigner, ResidualCoder, loss weights cls
    1.0 / loc 2.0 / dir 0.2; NMS 0.7, pre 4096 / post 500, score 0.1;
    adam_onecycle at LR 0.003, weight decay 0.01, clip 10) and the Waymo
    data settings of ``parta2_cfg``. Training augments with
    waymo_dataset.yaml's list without gt_sampling: world flip along x and
    y, rotation +-pi/4, scaling [0.95, 1.05]. Cuts: synthetic scenes (150k
    uniform background points, 20-40 objects, at most 64 gt boxes a scan)
    instead of Waymo scans; no gt_sampling, which pastes objects from
    waymo_dbinfos_train.pkl, a file the repo does not hold."""
    from toda_tpu_torch.config import EDict, cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / "tools/cfgs/waymo_models/second.yaml"), EDict())
    d = cfg.DATA_CONFIG
    d.DATASET = "SyntheticDataset"
    d.NUM_BACKGROUND_POINTS = 150000
    d.NUM_OBJECTS = [20, 40]
    d.MAX_GT_BOXES = 64
    d.NUM_SCENES = BATCH * SECOND_BATCHES
    d.DATA_AUGMENTOR.DISABLE_AUG_LIST = ["gt_sampling"]
    cfg.MODEL.BACKBONE_3D.FUSED_CONV = False
    return cfg


# ---------------------------------------------------------------------------
# real-format domains, fabricated: nuScenes and Waymo files from a seed
# ---------------------------------------------------------------------------

NUS_VERSION = "v1.0-trainval"
NUS_CLASSES = ("car", "truck", "pedestrian", "barrier")
# HDL-32E (nuScenes LIDAR_TOP): 32 beams over [-30.67, +10.67] deg, 1084
# azimuth steps, 70 m; the sensor 1.84 m above the ground, 0.94 m ahead of
# the ego origin, its x axis turned -90 deg (the dataset's calibration)
NUS_BEAMS_DEG = (-30.67, 10.67, 32)
NUS_AZIMUTHS = 1084
NUS_MAX_RANGE = 70.0
NUS_SENSOR = ((0.943713, 0.0, 1.84023), -math.pi / 2)
# Waymo TOP: a 64 x 2650 range image over [-17.6, +2.4] deg, 75 m, the
# sensor 2.184 m above the ground, 1.43 m ahead of the vehicle origin
WAYMO_ROWS, WAYMO_COLS = 64, 2650
WAYMO_INCL_DEG = (-17.6, 2.4)
WAYMO_MAX_RANGE = 75.0
WAYMO_SENSOR = (1.43, 0.0, 2.184)
# (length, width, height) of a fabricated object of each class
OBJECT_SIZES = {"car": (4.6, 1.95, 1.7), "truck": (7.5, 2.6, 3.2),
                "Car": (3.9, 1.6, 1.56), "Van": (5.0, 1.9, 2.1),
                "pedestrian": (0.75, 0.7, 1.75), "barrier": (0.5, 2.4, 1.0),
                "Vehicle": (4.7, 2.1, 1.8), "Pedestrian": (0.9, 0.85, 1.8),
                "Cyclist": (1.8, 0.8, 1.7)}


def ray_cast(origins, dirs, boxes, ground_z, max_range):
    """Range of each ray (R, 3 origins and unit directions) to the first of
    the ground plane z = ``ground_z`` and the (M, 7) boxes [x, y, z, l, w,
    h, yaw] (same frame), and the hit box's index (-1: the ground). Rays
    with nothing within ``max_range`` get range 0."""
    import numpy as np

    origins = np.broadcast_to(np.asarray(origins, np.float32), dirs.shape)
    # an object's surface lies 5 cm inside its labelled box, so the range
    # noise keeps its points in the box
    boxes = np.asarray(boxes, np.float32).copy()
    boxes[:, 3:6] -= 0.1
    dist = np.full(len(dirs), np.inf, np.float32)
    down = dirs[:, 2] < -1e-6
    dist[down] = (ground_z - origins[down, 2]) / dirs[down, 2]
    obj = np.full(len(dirs), -1, np.int64)
    safe = np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
    for m, box in enumerate(boxes):
        if np.hypot(*(box[:2] - origins[0, :2])) > max_range + box[3]:
            continue
        c, s = math.cos(box[6]), math.sin(box[6])
        o = origins - box[:3]
        o_local = (o[:, 0] * c + o[:, 1] * s, -o[:, 0] * s + o[:, 1] * c, o[:, 2])
        d_local = (safe[:, 0] * c + safe[:, 1] * s, -safe[:, 0] * s + safe[:, 1] * c,
                   safe[:, 2])
        near = np.full(len(dirs), -np.inf, np.float32)
        far = np.full(len(dirs), np.inf, np.float32)
        for ax in range(3):
            d_ax = np.where(np.abs(d_local[ax]) < 1e-9, 1e-9, d_local[ax])
            t1 = (-box[3 + ax] / 2 - o_local[ax]) / d_ax
            t2 = (box[3 + ax] / 2 - o_local[ax]) / d_ax
            near = np.maximum(near, np.minimum(t1, t2))
            far = np.minimum(far, np.maximum(t1, t2))
        hit = (far >= near) & (near > 0) & (near < dist)
        dist[hit] = near[hit]
        obj[hit] = m
    live = dist <= max_range
    return np.where(live, dist, 0.0).astype(np.float32), np.where(live, obj, -1)


def place_objects(rng, counts, path_len, reach, heading):
    """Objects beside a straight road along ``heading`` from the origin:
    (names, boxes (M, 7) in the road's frame, ground at z = 0), no two
    overlapping in BEV, none within 3.5 m of the road's centre line."""
    import numpy as np

    names, boxes = [], []
    for name, n in counts:
        length, width, height = OBJECT_SIZES[name]
        for _ in range(n):
            for _try in range(50):
                s = rng.uniform(-reach / 2, path_len + reach / 2)
                lat = rng.choice([-1, 1]) * rng.uniform(3.5 + width, reach)
                yaw = heading + (rng.normal(0, 0.15) if name not in ("pedestrian", "Pedestrian")
                                 else rng.uniform(-math.pi, math.pi))
                yaw += math.pi if rng.rand() < 0.5 else 0.0
                dims = np.asarray([length, width, height]) * rng.uniform(0.9, 1.1, 3)
                x = s * math.cos(heading) - lat * math.sin(heading)
                y = s * math.sin(heading) + lat * math.cos(heading)
                r = 0.5 * math.hypot(dims[0], dims[1])
                if all(math.hypot(x - b[0], y - b[1]) > r + 0.5 * math.hypot(b[3], b[4]) + 0.3
                       for b in boxes):
                    boxes.append([x, y, dims[2] / 2, *dims, yaw])
                    names.append(name)
                    break
    return names, np.asarray(boxes, np.float64).reshape(-1, 7)


def _token(*parts):
    import hashlib

    return hashlib.md5("/".join(str(p) for p in parts).encode()).hexdigest()


def _yaw_quat(yaw):
    return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]


def _pose(translation, yaw):
    import numpy as np

    m = np.eye(4)
    m[:2, :2] = [[math.cos(yaw), -math.sin(yaw)], [math.sin(yaw), math.cos(yaw)]]
    m[:3, 3] = translation
    return m


def fabricate_nuscenes(root, seed=SEED, scenes=6, samples_per_scene=4, sweeps=10,
                       azimuths=NUS_AZIMUTHS):
    """A nuScenes ``NUS_VERSION`` tree under ``root``: the raw JSON tables
    (scene, sample, sample_data, ego_pose, calibrated_sensor, sensor,
    sample_annotation, instance, category, attribute) and the LIDAR_TOP
    scans as (N, 5) float32 x, y, z, intensity, ring ``.bin`` files, key
    frames at 2 Hz under samples/, the ``sweeps`` - 1 scans 0.05 s apart
    before each under sweeps/. Each scan is ray-cast with the HDL-32E
    geometry (``NUS_BEAMS_DEG``, ``NUS_AZIMUTHS``, ``NUS_MAX_RANGE``) from
    the ego's pose at its time, the ego driving at 4-8 m/s, against the
    ground and the scene's boxes: cars (2-20 a scene, some moving; one in
    the odd-numbered scenes), trucks, pedestrians and barriers.
    ``azimuths`` < 1084 thins the scans (the tests' tiny files). Returns
    {'scans', 'points', 'samples'}."""
    import json

    import numpy as np

    rng = np.random.RandomState(seed)
    base = Path(root)
    (base / "samples" / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)
    (base / "sweeps" / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)
    t = {k: [] for k in ("scene", "sample", "sample_data", "ego_pose", "calibrated_sensor",
                         "sensor", "sample_annotation", "instance", "category", "attribute")}
    cats = {"car": "vehicle.car", "truck": "vehicle.truck",
            "pedestrian": "human.pedestrian.adult", "barrier": "movable_object.barrier"}
    for name, general in cats.items():
        t["category"].append({"token": _token("cat", general), "name": general,
                              "description": ""})
    for name in ("vehicle.moving", "vehicle.parked", "vehicle.stopped", "pedestrian.moving",
                 "pedestrian.standing", "cycle.with_rider", "cycle.without_rider"):
        t["attribute"].append({"token": _token("attr", name), "name": name, "description": ""})
    sensor_tok, cs_tok = _token("sensor", "LIDAR_TOP"), _token("cs", "LIDAR_TOP")
    t["sensor"].append({"token": sensor_tok, "channel": "LIDAR_TOP", "modality": "lidar"})
    (sx, sy, sz), s_yaw = NUS_SENSOR
    t["calibrated_sensor"].append({"token": cs_tok, "sensor_token": sensor_tok,
                                   "translation": [sx, sy, sz], "rotation": _yaw_quat(s_yaw),
                                   "camera_intrinsic": []})
    ego_from_sensor = _pose((sx, sy, sz), s_yaw)
    elev = np.radians(np.linspace(*NUS_BEAMS_DEG))
    stats = {"scans": 0, "points": 0, "samples": 0}
    for si in range(scenes):
        scene_tok = _token(seed, "scene", si)
        heading = rng.uniform(-math.pi, math.pi)
        speed = rng.uniform(4.0, 8.0)
        origin = np.asarray([rng.uniform(300, 2000), rng.uniform(300, 2000), 0.0])
        n_sd = samples_per_scene * sweeps
        path = speed * 0.05 * n_sd
        # every other scene is a quiet street with one car: a share this
        # script chooses, not a nuScenes statistic, so that the stage
        # configs' gt_sampling (car:2, LIMIT_WHOLE_SCENE) has frames to fill
        cars = 1 if si % 2 else rng.randint(2, 21)
        names, boxes = place_objects(
            rng, (("car", cars), ("truck", rng.randint(1, 4)),
                  ("pedestrian", rng.randint(2, 9)), ("barrier", rng.randint(0, 7))),
            path, 45.0, heading)
        boxes[:, :2] += origin[:2]
        vel = np.zeros((len(boxes), 2))
        moving = np.asarray([n == "car" and rng.rand() < 0.4 for n in names])
        vel[moving] = np.stack([np.cos(boxes[moving, 6]), np.sin(boxes[moving, 6])], 1) \
            * rng.uniform(2, 8, (int(moving.sum()), 1))
        walking = np.asarray([n == "pedestrian" and rng.rand() < 0.5 for n in names])
        vel[walking] = np.stack([np.cos(boxes[walking, 6]), np.sin(boxes[walking, 6])], 1) * 1.3
        inst = [_token(seed, "inst", si, m) for m in range(len(boxes))]
        t0 = 1_533_000_000_000_000 + si * 60_000_000
        sample_toks = [_token(seed, "sample", si, k) for k in range(samples_per_scene)]
        sd_toks = [_token(seed, "sd", si, j) for j in range(n_sd)]
        anns = {m: [] for m in range(len(boxes))}
        for j in range(n_sd):
            ts = t0 + 50_000 * j
            dt = (ts - t0) * 1e-6
            key = j % sweeps == sweeps - 1
            k = j // sweeps
            ego = _pose(origin + speed * dt * np.asarray([math.cos(heading),
                                                          math.sin(heading), 0.0]), heading)
            sensor_from_global = np.linalg.inv(ego @ ego_from_sensor)
            cur = boxes.copy()
            cur[:, :2] += vel * dt
            local = cur.copy()
            local[:, :3] = (sensor_from_global[:3, :3] @ cur[:, :3].T).T \
                + sensor_from_global[:3, 3]
            local[:, 6] = cur[:, 6] - heading - s_yaw
            az = np.linspace(0, 2 * math.pi, azimuths, endpoint=False) + rng.uniform(0, 0.005)
            e, a = np.meshgrid(elev, az, indexing="ij")
            dirs = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)],
                            -1).reshape(-1, 3).astype(np.float32)
            rng_m, obj = ray_cast(np.zeros(3), dirs, local, -sz, NUS_MAX_RANGE)
            live = rng_m > 0
            dist = rng_m[live] + rng.normal(0, 0.015, int(live.sum())).astype(np.float32)
            hit_obj = obj[live]
            pts = np.empty((int(live.sum()), 5), np.float32)
            pts[:, :3] = dirs[live] * dist[:, None]
            pts[:, 3] = np.where(hit_obj >= 0, rng.uniform(5, 100, len(dist)),
                                 rng.uniform(1, 20, len(dist)))
            pts[:, 4] = np.repeat(np.arange(len(elev)), azimuths)[live]
            folder = "samples" if key else "sweeps"
            fname = f"{folder}/LIDAR_TOP/n{seed:03d}-{si:02d}__LIDAR_TOP__{ts}.pcd.bin"
            pts.tofile(str(base / fname))
            stats["scans"] += 1
            stats["points"] += len(pts)
            ep_tok = _token(seed, "ego", si, j)
            t["ego_pose"].append({"token": ep_tok, "timestamp": ts,
                                  "translation": ego[:3, 3].tolist(),
                                  "rotation": _yaw_quat(heading)})
            t["sample_data"].append({
                "token": sd_toks[j], "sample_token": sample_toks[min(k, samples_per_scene - 1)],
                "ego_pose_token": ep_tok, "calibrated_sensor_token": cs_tok, "timestamp": ts,
                "fileformat": "pcd", "is_key_frame": key, "height": 0, "width": 0,
                "filename": fname, "prev": sd_toks[j - 1] if j else "",
                "next": sd_toks[j + 1] if j + 1 < n_sd else ""})
            if not key:
                continue
            t["sample"].append({
                "token": sample_toks[k], "timestamp": ts, "scene_token": scene_tok,
                "prev": sample_toks[k - 1] if k else "",
                "next": sample_toks[k + 1] if k + 1 < samples_per_scene else ""})
            stats["samples"] += 1
            n_pts = np.bincount(hit_obj[hit_obj >= 0], minlength=len(boxes))
            for m, name in enumerate(names):
                speed_m = float(np.hypot(*vel[m]))
                if name in ("car", "truck"):
                    attr = "vehicle.moving" if speed_m > 0.2 else "vehicle.parked"
                elif name == "pedestrian":
                    attr = "pedestrian.moving" if speed_m > 0.2 else "pedestrian.standing"
                else:
                    attr = None
                anns[m].append({
                    "token": _token(seed, "ann", si, m, k), "sample_token": sample_toks[k],
                    "instance_token": inst[m], "visibility_token": "4",
                    "attribute_tokens": [_token("attr", attr)] if attr else [],
                    "translation": cur[m, :3].tolist(),
                    "size": [cur[m, 4], cur[m, 3], cur[m, 5]],
                    "rotation": _yaw_quat(cur[m, 6]), "num_lidar_pts": int(n_pts[m]),
                    "num_radar_pts": 0})
        for m, name in enumerate(names):
            for k, ann in enumerate(anns[m]):
                ann["prev"] = anns[m][k - 1]["token"] if k else ""
                ann["next"] = anns[m][k + 1]["token"] if k + 1 < len(anns[m]) else ""
            t["sample_annotation"].extend(anns[m])
            t["instance"].append({"token": inst[m], "category_token": _token("cat", cats[name]),
                                  "nbr_annotations": len(anns[m]),
                                  "first_annotation_token": anns[m][0]["token"],
                                  "last_annotation_token": anns[m][-1]["token"]})
        t["scene"].append({"token": scene_tok, "name": f"scene-{seed:02d}{si:02d}",
                           "description": "fabricated", "log_token": _token(seed, "log", si),
                           "nbr_samples": samples_per_scene,
                           "first_sample_token": sample_toks[0],
                           "last_sample_token": sample_toks[-1]})
    tables = base / NUS_VERSION
    tables.mkdir(parents=True, exist_ok=True)
    for name, rows in t.items():
        (tables / f"{name}.json").write_text(json.dumps(rows))
    return stats


# the percentage splits the stage configs name, as seeded subsets of the
# train infos: file suffix, and whether it is a labelled subset (else the
# rest of train)
NUS_SPLITS = (("train_01", True), ("train_5", True), ("train_unlabeled_90", False))


def fabricate_nuscenes_splits(root, seed=SEED, sweeps=10, frames=8):
    """The labelled-percentage info files the stage configs read
    (nuscenes_infos_<sweeps>sweeps_train_01.pkl, _train_5.pkl,
    _train_unlabeled_90.pkl), which the JAX package's tools do not write:
    seeded subsets of ``create_infos``' train infos, ``frames`` each (8:
    two batches of 4, not the named percentage of a split this small), the
    unlabelled one the train frames outside _train_5. Returns {suffix:
    frames}."""
    import pickle

    import numpy as np

    root = Path(root)
    with open(root / f"nuscenes_infos_{sweeps}sweeps_train.pkl", "rb") as f:
        train = pickle.load(f)
    rng = np.random.RandomState(seed)
    out, labelled = {}, set()
    for suffix, subset in NUS_SPLITS:
        if subset:
            sel = sorted(rng.permutation(len(train))[:frames].tolist())
            labelled = set(sel)
        else:
            sel = [i for i in range(len(train)) if i not in labelled]
        with open(root / f"nuscenes_infos_{sweeps}sweeps_{suffix}.pkl", "wb") as f:
            pickle.dump([train[i] for i in sel], f)
        out[suffix] = len(sel)
    return out


def fabricate_waymo(raw_dir, seed=SEED, sequences=2, frames=20, rows=WAYMO_ROWS,
                    cols=WAYMO_COLS):
    """Waymo ``.tfrecord`` sequences under ``raw_dir``, written with
    ``toda_tpu_torch.datasets.waymo.tfrecord_io``'s encoders: per frame at
    10 Hz, the vehicle pose, the TOP laser's calibration (64 beam
    inclinations over ``WAYMO_INCL_DEG``, the extrinsic) and its first
    return as a 64 x 2650 range image (range, intensity, elongation, NLZ)
    with a per-pixel pose (the vehicle's at each column's time, 0.1 s a
    turn, as the rolling shutter records it), ray-cast to 75 m against the
    ground and the boxes; laser labels of Vehicle, Pedestrian and Cyclist
    boxes in the vehicle frame with their lidar point counts. ``rows`` x
    ``cols`` below 64 x 2650 thins the range image (the tests' tiny files).
    Returns {'frames', 'points'}."""
    import numpy as np

    from toda_tpu_torch.datasets.waymo import tfrecord_io as tio

    rng = np.random.RandomState(seed + 1)
    raw_dir = Path(raw_dir)
    raw_dir.mkdir(parents=True, exist_ok=True)
    beams = np.radians(np.linspace(*WAYMO_INCL_DEG, rows)) \
        + rng.normal(0, 1e-4, rows)
    incl = beams[::-1]  # row 0 is the highest beam
    col = np.arange(cols)
    az = ((cols - col - 0.5) / cols * 2 - 1) * math.pi
    e, a = np.meshgrid(incl, az, indexing="ij")
    dirs = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)],
                    -1).reshape(-1, 3).astype(np.float32)
    col_dt = (col / cols - 0.5) * 0.1
    extrinsic = _pose(WAYMO_SENSOR, 0.0)
    calib = tio.enc_laser_calibration(tio.LASER_TOP, extrinsic, float(beams[0]),
                                      float(beams[-1]), beams)
    classes = {"Vehicle": 1, "Pedestrian": 2, "Cyclist": 4}
    stats = {"frames": 0, "points": 0}
    for q in range(sequences):
        heading = rng.uniform(-math.pi, math.pi)
        speed = rng.uniform(5.0, 10.0)
        origin = np.asarray([rng.uniform(-3000, 3000), rng.uniform(-3000, 3000), 0.0])
        names, boxes = place_objects(
            rng, (("Vehicle", rng.randint(10, 31)), ("Pedestrian", rng.randint(3, 11)),
                  ("Cyclist", rng.randint(1, 4))), speed * 0.1 * frames, 60.0, heading)
        boxes[:, :2] += origin[:2]
        records = []
        context = f"{seed:04d}{q:04d}_fabricated"
        for f in range(frames):
            ts = 1_550_000_000_000_000 + q * 100_000_000 + f * 100_000
            pos = origin + speed * 0.1 * f * np.asarray([math.cos(heading), math.sin(heading), 0])
            frame_pose = _pose(pos, heading)
            inv = np.linalg.inv(frame_pose)
            local = boxes.copy()
            local[:, :3] = (inv[:3, :3] @ boxes[:, :3].T).T + inv[:3, 3]
            local[:, 6] = boxes[:, 6] - heading
            # each column's ray leaves the sensor where the vehicle is at its time
            shift = np.zeros((cols, 3), np.float32)
            shift[:, 0] = speed * col_dt
            origins = (np.asarray(WAYMO_SENSOR, np.float32)[None, None] + shift[None]).repeat(
                rows, 0).reshape(-1, 3)
            dist, obj = ray_cast(origins, dirs, local, 0.0, WAYMO_MAX_RANGE)
            live = dist > 0
            dist = np.where(live, dist + rng.normal(0, 0.015, len(dist)), 0).astype(np.float32)
            ri = np.zeros((rows, cols, 4), np.float32)
            ri[..., 0] = dist.reshape(rows, cols)
            ri[..., 1] = np.where(obj >= 0, rng.uniform(0.05, 1.0, len(dist)),
                                  rng.uniform(0.01, 0.3, len(dist))).reshape(ri.shape[:2])
            ri[..., 2] = rng.uniform(0.0, 0.3, ri.shape[:2])
            ri[..., 3] = -1.0
            ri[..., 1:3] *= ri[..., :1] > 0
            pix = np.zeros((rows, cols, 6), np.float32)
            pix[..., 2] = heading
            pix[..., 3:] = (pos + np.outer(speed * col_dt, [math.cos(heading),
                                                            math.sin(heading), 0.0]))[None]
            n_pts = np.bincount(obj[obj >= 0], minlength=len(boxes))
            labels = [tio.enc_label(classes[n], local[m], num_pts=int(n_pts[m]),
                                    obj_id=f"{q}-{m}", difficulty=1 if n_pts[m] > 5 else 2)
                      for m, n in enumerate(names)]
            records.append(tio.enc_frame(
                context, ts, frame_pose, [calib],
                [(tio.LASER_TOP, tio.enc_range_image(ri, pix), None)], labels))
            stats["frames"] += 1
            stats["points"] += int(live.sum())
        tio.write_tfrecords(raw_dir / f"segment-{context}_with_camera_labels.tfrecord",
                            records)
    return stats


# HDL-64E (KITTI's velodyne): 64 beams over [-24.9, +2.0] deg, 120 m, 1.73 m
# above the ground. 1.33M points/s at KITTI's 10 Hz is 2083 azimuth steps
# (0.173 deg; the datasheet's 0.08-0.09 deg is at 5 Hz): ~120k returns
KITTI_BEAMS_DEG = (-24.9, 2.0, 64)
KITTI_AZIMUTHS = 2083
KITTI_MAX_RANGE = 120.0
KITTI_SENSOR_Z = 1.73
KITTI_IMAGE = (375, 1242)  # (H, W) of image_2, the adapter's fallback shape
# the calibration of KITTI's training frame 000000, in its text form
KITTI_CALIB_ROWS = (
    ("P0", "7.215377e+02 0.000000e+00 6.095593e+02 0.000000e+00 0.000000e+00 7.215377e+02 "
     "1.728540e+02 0.000000e+00 0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00"),
    ("P1", "7.215377e+02 0.000000e+00 6.095593e+02 -3.875744e+02 0.000000e+00 7.215377e+02 "
     "1.728540e+02 0.000000e+00 0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00"),
    ("P2", "7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 0.000000e+00 7.215377e+02 "
     "1.728540e+02 2.163791e-01 0.000000e+00 0.000000e+00 1.000000e+00 2.745884e-03"),
    ("P3", "7.215377e+02 0.000000e+00 6.095593e+02 -3.395242e+02 0.000000e+00 7.215377e+02 "
     "1.728540e+02 2.199936e+00 0.000000e+00 0.000000e+00 1.000000e+00 2.729905e-03"),
    ("R0_rect", "9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 9.999421e-01 "
     "-4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01"),
    ("Tr_velo_to_cam", "7.533745e-03 -9.999714e-01 -6.166020e-04 -4.069766e-03 "
     "1.480249e-02 7.280733e-04 -9.998902e-01 -7.631618e-02 "
     "9.998621e-01 7.523790e-03 1.480755e-02 -2.717806e-01"),
    ("Tr_imu_to_velo", "9.999976e-01 7.553071e-04 -2.035826e-03 -8.086759e-01 "
     "-7.854027e-04 9.998898e-01 -1.482298e-02 3.195559e-01 "
     "2.024406e-03 1.482454e-02 9.998881e-01 -7.997231e-01"),
)
KITTI_CALIB = "".join(f"{name}: {values}\n" for name, values in KITTI_CALIB_ROWS)


def kitti_label_lines(names, boxes, rng, calib):
    """KITTI label_2 lines of the lidar ``boxes`` whose centre lies ahead of
    the camera and whose image box overlaps the image: the camera box, the
    projected 2D box clipped to the image, the share of it cut off as the
    truncation, an occlusion level drawn per object (0, 1 or 2), alpha from
    the viewing angle; then one DontCare region. Returns (lines, indices of
    the labelled boxes)."""
    import numpy as np

    from toda_tpu_torch.utils import box_utils

    cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
    full = box_utils.boxes3d_kitti_camera_to_imageboxes(cam, calib)
    clip = full.copy()
    clip[:, [0, 2]] = np.clip(clip[:, [0, 2]], 0, KITTI_IMAGE[1] - 1)
    clip[:, [1, 3]] = np.clip(clip[:, [1, 3]], 0, KITTI_IMAGE[0] - 1)
    area = (full[:, 2] - full[:, 0]) * (full[:, 3] - full[:, 1])
    kept = (clip[:, 2] - clip[:, 0]) * (clip[:, 3] - clip[:, 1])
    lines, labelled = [], []
    for m, name in enumerate(names):
        trunc = 1.0 - kept[m] / max(area[m], 1e-6)
        if cam[m, 2] < 2.0 or kept[m] <= 0 or trunc > 0.8:
            continue
        x, y, z, length, h, w, ry = cam[m]
        ry = (ry + math.pi) % (2 * math.pi) - math.pi
        alpha = -math.atan2(-boxes[m, 1], boxes[m, 0]) + ry
        alpha = (alpha + math.pi) % (2 * math.pi) - math.pi
        lines.append(f"{name} {trunc:.2f} {rng.choice([0, 0, 0, 1, 1, 2])} {alpha:.2f} "
                     f"{clip[m, 0]:.2f} {clip[m, 1]:.2f} {clip[m, 2]:.2f} {clip[m, 3]:.2f} "
                     f"{h:.2f} {w:.2f} {length:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}")
        labelled.append(m)
    x1, y1 = rng.uniform(0, KITTI_IMAGE[1] - 80), rng.uniform(150, 200)
    lines.append(f"DontCare -1 -1 -10 {x1:.2f} {y1:.2f} {x1 + rng.uniform(20, 80):.2f} "
                 f"{y1 + rng.uniform(10, 30):.2f} -1 -1 -1 -1000 -1000 -1000 -10")
    return lines, labelled


def _kitti_frame(base, idx, rng, calib, elev, azimuths):
    """One fabricated KITTI frame's scan and labels (``fabricate_kitti``);
    returns (points, labels)."""
    import numpy as np

    names, boxes = place_objects(
        rng, (("Car", rng.randint(4, 16)), ("Van", rng.randint(0, 3)),
              ("Pedestrian", rng.randint(0, 5)), ("Cyclist", rng.randint(0, 3))),
        50.0, 25.0, rng.normal(0, 0.1))
    boxes[:, 2] -= KITTI_SENSOR_Z
    boxes[:, 6] = (boxes[:, 6] + math.pi) % (2 * math.pi) - math.pi
    az = np.linspace(-math.pi, math.pi, azimuths, endpoint=False) + rng.uniform(0, 0.003)
    e, a = np.meshgrid(elev, az, indexing="ij")
    dirs = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)],
                    -1).reshape(-1, 3).astype(np.float32)
    dist, obj = ray_cast(np.zeros(3), dirs, boxes, -KITTI_SENSOR_Z, KITTI_MAX_RANGE)
    live = dist > 0
    dist = dist[live] + rng.normal(0, 0.01, int(live.sum())).astype(np.float32)
    pts = np.empty((len(dist), 4), np.float32)
    pts[:, :3] = dirs[live] * dist[:, None]
    pts[:, 3] = np.where(obj[live] >= 0, rng.uniform(0.2, 0.9, len(dist)),
                         rng.uniform(0.0, 0.3, len(dist)))
    pts.tofile(str(base / "training" / "velodyne" / f"{idx}.bin"))
    (base / "training" / "calib" / f"{idx}.txt").write_text(KITTI_CALIB)
    lines, labelled = kitti_label_lines(names, boxes.astype(np.float32), rng, calib)
    (base / "training" / "label_2" / f"{idx}.txt").write_text("\n".join(lines) + "\n")
    return len(pts), len(labelled)


def fabricate_kitti(root, seed=SEED, train=16, val=8, azimuths=KITTI_AZIMUTHS):
    """A KITTI object tree under ``root``: training/velodyne/<id>.bin ((N, 4)
    float32 x, y, z, reflectance), training/calib/<id>.txt (``KITTI_CALIB``),
    training/label_2/<id>.txt (``kitti_label_lines``) and
    ImageSets/{train,val}.txt, ``train`` + ``val`` frames. Each scan is
    ray-cast with the HDL-64E geometry (``KITTI_BEAMS_DEG``, ``azimuths``,
    ``KITTI_MAX_RANGE``) against the ground and a street's objects: 4-15
    cars, 0-2 vans, 0-4 pedestrians and 0-2 cyclists. Cars far off (small
    image boxes), the occlusion draw and boxes cut by the image edge give
    every difficulty. Frames are cast on a thread pool, each from its own
    seeded generator. ``azimuths`` below 2083 thins the scans (the tests'
    tiny files). Returns {'frames', 'points', 'labels'}."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from toda_tpu_torch.datasets.kitti.calibration_kitti import Calibration

    base = Path(root)
    for sub in ("velodyne", "calib", "label_2"):
        (base / "training" / sub).mkdir(parents=True, exist_ok=True)
    (base / "ImageSets").mkdir(parents=True, exist_ok=True)
    calib_file = base / "calib.txt"
    calib_file.write_text(KITTI_CALIB)
    calib = Calibration(str(calib_file))
    calib_file.unlink()
    elev = np.radians(np.linspace(*KITTI_BEAMS_DEG))
    ids = [f"{i:06d}" for i in range(train + val)]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        done = list(pool.map(lambda i: _kitti_frame(
            base, ids[i], np.random.RandomState([seed, 2, i]), calib, elev, azimuths),
            range(len(ids))))
    (base / "ImageSets" / "train.txt").write_text("\n".join(ids[:train]) + "\n")
    (base / "ImageSets" / "val.txt").write_text("\n".join(ids[train:]) + "\n")
    return {"frames": len(ids), "points": sum(n for n, _ in done),
            "labels": sum(k for _, k in done)}


def toda_cfgs(data_root=None):
    """The TODA slice at full width: (stage 1, stage 2, pseudo labels), the
    configs as the repo holds them with only each domain's DATA_PATH moved
    to the fabricated files under ``data_root`` (``phase_data``; None keeps
    the configs' own paths, for callers that read only the models).

    Stage 1: tools/cfgs/stage1_targetmix/centerpoint_20_waymo_01_nus_targetmix.yaml
    (CenterPoint with PillarResBackBone8x [16, 32, 64, 64], MAX_PILLARS 32768,
    BF16; BEV [5, 5] x [128, 256] / [256, 256]; CenterHead, one class 'car';
    range [-51.2, 51.2]^2 x [-5, 3], voxel (0.1, 0.1, 0.2) -> 1024 x 1024 x
    40; 131072 points a scan; CutMixDataset with CUTMIX_PROB 0.5 over Waymo
    (SOURCE_CFG: waymo_dataset.yaml, SAMPLED_INTERVAL 5, gt_sampling) and
    nuScenes (TARGET_CFG: nuscenes_dataset.yaml, 10 sweeps, the _train_01
    infos, CBGS, gt_sampling); adam_onecycle at LR 0.001; DATA_CONFIG_TEST
    nuScenes val). Stage 2:
    tools/cfgs/stage2_advmix/centerpoint_5_lab_nus_advmix.yaml (MixUpDataset
    over BASE_CFG nuScenes _train_5: MIXUP_PROB 0.7, GT_PROB 0.3,
    gt+ps_gt+ps, ADV_ALPHA 0.5, pseudo score 0.2, world flip / rotation /
    scaling; CL_CFG weight 0.1, score 0.3). Pseudo labels:
    tools/cfgs/pseudo_labels/centerpoint_generate_90_pseudo_nus_frames.yaml
    (DATA_CONFIG nuScenes with the _train_unlabeled_90 infos; score 0.2,
    the perturbation, eps 1.0)."""
    from toda_tpu_torch.config import EDict, cfg_from_yaml_file

    s1 = cfg_from_yaml_file(str(REPO / "tools/cfgs/stage1_targetmix/"
                                "centerpoint_20_waymo_01_nus_targetmix.yaml"), EDict())
    s2 = cfg_from_yaml_file(str(REPO / "tools/cfgs/stage2_advmix/"
                                "centerpoint_5_lab_nus_advmix.yaml"), EDict())
    pl = cfg_from_yaml_file(str(REPO / "tools/cfgs/pseudo_labels/"
                                "centerpoint_generate_90_pseudo_nus_frames.yaml"), EDict())
    if data_root is not None:
        nus, waymo = str(Path(data_root) / "nuscenes"), str(Path(data_root) / "waymo")
        s1.DATA_CONFIG.SOURCE_CFG.DATA_PATH = waymo
        for d in (s1.DATA_CONFIG.TARGET_CFG, s1.DATA_CONFIG_TEST, s2.DATA_CONFIG.BASE_CFG,
                  s2.DATA_CONFIG_TEST, pl.DATA_CONFIG):
            d.DATA_PATH = nus
    return s1, s2, pl


def occupied_pillars(sample, dataset):
    """The BEV cells of the voxel grid a prepared scan's points fill: the
    pillars the pillar backbone's voxelizer takes (up to MAX_PILLARS, in
    key order)."""
    import numpy as np

    pts = sample["points"][sample["points_mask"].astype(bool)]
    ijk = np.floor((pts[:, :3] - dataset.point_cloud_range[:3])
                   / dataset.voxel_size).astype(np.int64)
    grid = np.asarray(dataset.grid_size)
    ok = ((ijk >= 0) & (ijk < grid)).all(axis=1)
    return len(np.unique(ijk[ok, 1] * grid[0] + ijk[ok, 0]))


def phase_data(data_root):
    """The real-format data path on the host: nuScenes and Waymo fabricated
    under ``data_root`` (``fabricate_nuscenes``, ``fabricate_waymo``), their
    infos and gt databases from the port's ``create_infos`` (``nuscenes``,
    ``waymo``, ``--with_gt_db``), the labelled-percentage splits
    (``fabricate_nuscenes_splits``); then every split the stage configs read
    is built and must hold two batches; the stage-1 CutMix dataset prepares
    scans on one thread (the host loader's rate, no device), and each scan's
    points before and after ``sample_points`` and its occupied pillars
    against MAX_PILLARS are logged, as are the nuScenes val scans the
    target-domain evals read. Returns {metric: value} and the split sizes."""
    import numpy as np

    from toda_tpu_torch.datasets import build_dataset
    from toda_tpu_torch.tools import create_infos
    from toda_tpu_torch.tools.generate_pseudo_labels import build_unlabelled_loader
    from toda_tpu_torch.utils import box_utils

    root = Path(data_root)
    nus, waymo = root / "nuscenes", root / "waymo"
    secs = {}
    t = time.time()
    fn = fabricate_nuscenes(nus)
    secs["fabricate nuScenes"] = time.time() - t
    t = time.time()
    fw = fabricate_waymo(waymo / "raw")
    secs["fabricate Waymo"] = time.time() - t
    t = time.time()
    create_infos.main(["nuscenes", "--data_path", str(nus), "--version", NUS_VERSION,
                       "--max_sweeps", "10", "--with_gt_db", "--classes", ",".join(NUS_CLASSES)])
    secs["create_infos nuscenes --with_gt_db"] = time.time() - t
    t = time.time()
    create_infos.main(["waymo", "--data_path", str(waymo / "raw"), "--save_path", str(waymo),
                       "--with_gt_db", "--classes", "Vehicle,Pedestrian,Cyclist"])
    secs["create_infos waymo --with_gt_db"] = time.time() - t
    splits = fabricate_nuscenes_splits(nus)
    disk = {d.name: sum(f.stat().st_size for f in d.rglob("*") if f.is_file()) / 2**20
            for d in (nus, waymo)}
    log(f"phase data: nuScenes {fn['samples']} key frames, {fn['scans']} LIDAR_TOP scans, "
        f"{fn['points'] / fn['scans']:.0f} points a scan; Waymo {fw['frames']} frames, "
        f"{fw['points'] / fw['frames']:.0f} points a range image; splits written by the "
        f"fabricator {splits}; on disk {({k: round(v) for k, v in disk.items()})} MiB; host "
        f"seconds {({k: round(v, 1) for k, v in secs.items()})}")

    s1, s2, pl = toda_cfgs(root)
    np.random.seed(SEED)
    ds1 = build_dataset(s1.DATA_CONFIG, s1.CLASS_NAMES, training=True)
    base = build_dataset(s2.DATA_CONFIG.BASE_CFG, s2.CLASS_NAMES, training=True)
    unl, _ = build_unlabelled_loader(pl, BATCH)
    val = build_dataset(s1.DATA_CONFIG_TEST, s1.CLASS_NAMES)
    sizes = {"source": len(ds1.source), "target": len(ds1.target), "stage2_labelled": len(base),
             "unlabelled": len(unl), "val": len(val)}
    assert all(n >= 2 * BATCH for n in sizes.values()), sizes
    assert not {i["token"] for i in unl.infos} & {i["token"] for i in base.infos}

    # the target domain's gt_sampling: a call that pastes keeps its scene
    # points, its output points and the boxes it pasted (copies: the next
    # augmentations flip in place), read after the timed loop
    sampler = ds1.target.data_augmentor.data_augmentor_queue[0]
    pasted, calls = [], []

    def counted(data_dict):
        n, points = len(data_dict["gt_boxes"]), data_dict["points"]
        out = sampler(data_dict)
        calls.append(len(out["gt_boxes"]) - n)
        if calls[-1]:
            pasted.append((points, out["points"].copy(), out["gt_boxes"][n:, :7].copy()))
        return out

    ds1.target.data_augmentor.data_augmentor_queue[0] = counted
    cap = int(s1.MODEL.BACKBONE_3D.MAX_PILLARS)
    metrics = {}
    for what, ds, n in (("stage-1 CutMix (train)", ds1, 4 * BATCH), ("nuScenes val (test)",
                                                                        val, len(val))):
        raw, kept, pillars = [], [], []
        t = time.time()
        samples = [ds[i] for i in range(n)]
        rate = n / (time.time() - t)
        for i, smp in enumerate(samples):
            kept.append(int(smp["points_mask"].sum()))
            pillars.append(occupied_pillars(smp, ds))
        if ds is val:
            raw = [len(val.get_raw_scene(i)[0]) for i in range(n)]
        else:
            raw = [len(ds1.source.get_raw_scene(i)[0]) for i in range(len(ds1.source))] \
                + [len(ds1.target.get_raw_scene(i)[0]) for i in range(len(ds1.target))]
        key = "cutmix" if ds is ds1 else "val"
        metrics[f"loader_{key}_scans_per_s"] = rate
        metrics[f"pillars_{key}"] = (min(pillars), float(np.mean(pillars)), max(pillars))
        log(f"  {what}: {rate:.2f} scans/s on one host thread (prepare_data"
            f"{' + CutMix' if ds is ds1 else ''}, {n} scans); points a scan "
            f"{min(raw)}-{max(raw)} loaded, {min(kept)}-{max(kept)} after sample_points "
            f"(cap {ds.max_points}); occupied pillars {min(pillars)}-{max(pillars)} (mean "
            f"{np.mean(pillars):.0f}) against MAX_PILLARS {cap}: the cap drops "
            f"{sum(max(0, v - cap) for v in pillars) / n:.0f} a scan, on "
            f"{sum(v > cap for v in pillars)} of {n} scans")
    # the pasted objects' points come first in a sampler's output, before
    # the scene's points its carve-out kept
    objects = obj_points = inside = 0
    for points, out, boxes in pasted:
        obj = out[:len(out) - len(box_utils.remove_points_in_boxes3d(points, boxes))]
        objects += len(boxes)
        obj_points += len(obj)
        inside += int(box_utils.points_in_boxes_numpy(obj, boxes).any(0).sum())
    log(f"  splits {sizes}; the target's gt_sampling (car:2, LIMIT_WHOLE_SCENE) pasted "
        f"{objects} cars over {len(calls)} calls, {obj_points} points, {inside} of them "
        f"inside their boxes")
    assert objects > 0, "the target's gt_sampling pasted no object"
    assert inside >= 0.99 * obj_points, (inside, obj_points)
    metrics["gt_sampling_pasted"] = (objects, obj_points, inside)
    return metrics, sizes


def second_tiny(cfg, fused=False):
    """A tiny SECOND from ``cfg``, a loaded second_synthetic.yaml (of
    either package): range [-16, 16]^2 x [-3, 1], voxel 0.5 (a few hundred
    pillars), CHANNELS [16, 32, 32, 32], f32, ``FUSED_CONV`` = ``fused``.
    The first conv (8 channels) and the down convs take K8's per-group
    forward, the other convs K7's stacked one; every backward takes K7."""
    d = cfg.DATA_CONFIG
    d.POINT_CLOUD_RANGE = [-16.0, -16.0, -3.0, 16.0, 16.0, 1.0]
    d.DATA_PROCESSOR[2].NUM_POINTS = {"train": 1024, "test": 1024}
    d.DATA_PROCESSOR[3].VOXEL_SIZE = [0.5, 0.5, 0.5]
    d.DATA_PROCESSOR[3].MAX_NUMBER_OF_VOXELS = {"train": 1024, "test": 1024}
    d.NUM_SCENES = 2
    d.NUM_OBJECTS = [2, 4]
    m = cfg.MODEL
    m.BACKBONE_3D.CHANNELS = [16, 32, 32, 32]
    m.BACKBONE_3D.MAX_PILLARS = 1024
    m.BACKBONE_3D.BF16 = False
    m.BACKBONE_3D.FUSED_CONV = fused
    m.BACKBONE_2D.LAYER_NUMS = [1, 1]
    m.BACKBONE_2D.NUM_FILTERS = [16, 32]
    m.BACKBONE_2D.NUM_UPSAMPLE_FILTERS = [16, 16]
    return cfg


def parta2_tiny_cfg():
    from toda_tpu_torch.config import EDict, cfg_from_yaml_file

    return cfg_from_yaml_file(
        str(REPO / "tools/cfgs/synthetic_models/parta2_synthetic.yaml"), EDict())


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() over iters launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_tiny_parity():
    """Tiny f32 model: cuda vs cpu on the same weights and batch."""
    import numpy as np
    import torch

    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.weights import randomize_

    cfg = tiny_cfg()
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2)
    batch = next(iter(loader))
    cpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
    randomize_(cpu.module, SEED)
    gpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cuda")
    gpu.module.load_state_dict(cpu.module.state_dict(), strict=True)
    out_c = cpu.forward(cpu.to_device(batch))
    out_g = gpu.forward(gpu.to_device(batch))
    tol = 1e-3  # f32 on both sides, TF32 off: only summation order differs
    worst = 0.0
    pairs = [("spatial_features_2d", out_c["spatial_features_2d"], out_g["spatial_features_2d"])]
    pairs += [(k, out_c["center_pred_dicts"][0][k], v)
              for k, v in out_g["center_pred_dicts"][0].items()]
    for name, a, b in pairs:
        b = b.cpu()
        err = (a - b).abs().max().item()
        worst = max(worst, err / max(1.0, a.abs().max().item()))
        assert torch.allclose(a, b, rtol=tol, atol=tol), f"tiny cuda/cpu {name}: max err {err}"
    log(f"phase tiny cuda-vs-cpu (f32): head outputs agree, max rel err {worst:.3g} (tol {tol})")


def update_mismatches(final, ref_final, init, ref_grads, lr_sum):
    """The parameters whose update (final - init) after a few optimizer steps
    differs from the reference's by more than 1e-3 of ``lr_sum`` (the sum of
    the steps' LRs, the farthest an Adam step sequence moves a leaf) on an
    element whose first-step reference gradient is above 1e-3 of its leaf's
    largest. Adam moves a leaf by about LR * sign(g), so where g is within
    rounding of 0 the two sides may step apart; those elements are held to
    2 * lr_sum only. A wrong decay mask or a wrong b1 schedule moves the
    update by 1e-2 of lr_sum or more. Returns ([(name, err, tol)] of the
    leaves that fail, the largest error on a live element / lr_sum)."""
    bad, worst = [], 0.0
    for name, g in ref_grads.items():
        want = (ref_final[name].double() - init[name].double()).cpu()
        err = (final[name].double().cpu() - init[name].double().cpu() - want).abs()
        g = g.abs().double().cpu()
        live = g > 1e-3 * g.max()
        worst = max(worst, err[live].max().item() / lr_sum)
        for sel, tol in ((live, 1e-3 * lr_sum), (~live, 2 * lr_sum)):
            if sel.any() and err[sel].max().item() > tol:
                bad.append((name, err[sel].max().item(), tol))
    return bad, worst


def phase_tiny_train_parity():
    """Tiny f32 model: three train steps on cuda and on cpu from the same
    weights and batch. Losses agree to 1e-3 relative, each parameter's
    update as ``update_mismatches`` says, the BatchNorm running statistics
    to 1e-4."""
    import numpy as np
    import torch

    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.runtime.train_utils import create_train_state, make_train_step

    cfg = tiny_cfg()
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2,
                                     training=True)
    batch = next(iter(loader))
    runs = []
    for device in ("cpu", "cuda"):
        bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=device, seed=SEED)
        state, _ = create_train_state(bundle, cfg.OPTIMIZATION, 10)
        init = {k: v.detach().cpu().clone() for k, v in bundle.module.state_dict().items()}
        step = make_train_step(bundle)
        losses, grads = [], None
        for _ in range(3):
            losses.append(float(step(state, batch)[1]["loss"]))
            if grads is None:
                grads = {n: p.grad.cpu().clone() for n, p in bundle.module.named_parameters()}
        runs.append((losses, bundle.module.state_dict(), init, grads, state))
    (lc, sdc, init, gc, opt), (lg, sdg, init_g, _, _) = runs
    for a, b in zip(lc, lg):
        assert abs(a - b) <= 1e-3 * abs(a), f"tiny train cuda/cpu losses {lc} vs {lg}"
    assert all(torch.equal(init[k], init_g[k]) for k in init), "the two inits differ"
    lr_sum = sum(opt.lr_fn(i) for i in range(3))
    bad, worst = update_mismatches(sdg, sdc, init, gc, lr_sum)
    assert not bad, f"tiny train cuda/cpu updates differ: {bad[:5]}"
    for k in sdc:
        if k.endswith(("running_mean", "running_var")):
            assert torch.allclose(sdg[k].cpu(), sdc[k], rtol=1e-4, atol=1e-4), k
    log(f"phase tiny train cuda-vs-cpu (f32, 3 steps): losses {lc} vs {lg}; every "
        f"update within 1e-3 x sum(LR) where the step-1 gradient is live (max err "
        f"{worst:.3g} x sum(LR)); BN statistics within 1e-4")


class Recorder:
    """Records the arguments of each call to a kernel wrapper, as seen
    from one module, while it is installed there."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def rec(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def reset_launches():
    """Every kernel wrapper's launch count to 0."""
    from toda_tpu_torch.ops import fused_conv, gather, pointnet2_ops

    for counts in (fused_conv.LAUNCHES, gather.LAUNCHES, pointnet2_ops.LAUNCHES):
        for k in counts:
            counts[k] = 0


def k1_work(x, weights, idx, z_stride):
    """(bytes, flops) of one K1 call on these inputs: each input read once,
    the output written once; 2*C*Cout flops per (output row, valid tap,
    in-range dz)."""
    import torch

    m_in, nz_in, c = x.shape
    cout = weights.shape[-1]
    nz_out = -(-nz_in // z_stride)
    eb = x.element_size()
    nbytes = (x.numel() * eb + weights.numel() * eb + idx.numel() * 4 + 2 * c * 4
              + idx.shape[0] * nz_out * cout * eb)
    taps = int(torch.count_nonzero(idx >= 0).item())
    return nbytes, 2 * c * cout * taps * z_pairs(nz_in, z_stride)


def z_pairs(nz_in, z_stride, backward=False):
    """(output z, dz) pairs of a conv that read an input z in range (forward),
    or (input z, dz) pairs that read a staged output row (backward)."""
    nz_out = -(-nz_in // z_stride)
    if not backward:
        return sum(1 for zo in range(nz_out) for dz in range(3)
                   if 0 <= z_stride * zo + dz - 1 < nz_in)
    return sum(1 for z in range(nz_in) for dz in range(3)
               if z + 1 - dz >= 0 and (z + 1 - dz) % z_stride == 0
               and (z + 1 - dz) // z_stride < nz_out)


def dx_work(x, w, invf, gy, z_stride):
    """(bytes, flops) of one dx call: x, gy, w, invf read once, dx written
    once; 2*C*Cout flops per (input row, valid inverse tap, valid (z, dz))."""
    import torch

    c, cout = x.shape[-1], gy.shape[-1]
    eb = x.element_size()
    nbytes = (2 * x.numel() + gy.numel() + w.numel()) * eb + invf.numel() * 4 + 4 * c * 4
    taps = int(torch.count_nonzero(invf >= 0).item())
    return nbytes, 2 * c * cout * taps * z_pairs(x.shape[1], z_stride, backward=True)


def dw_work(x, idx, gy, z_stride):
    """(bytes, flops) of one dW call: x, gy, idx read once, the f32 dW
    written once; 2*C*Cout flops per (output row, valid tap, in-range dz)."""
    import torch

    c, cout = x.shape[-1], gy.shape[-1]
    eb = x.element_size()
    nbytes = (x.numel() + gy.numel()) * eb + idx.numel() * 4 + 27 * c * cout * 4 + 2 * c * 4
    taps = int(torch.count_nonzero(idx >= 0).item())
    return nbytes, 2 * c * cout * taps * z_pairs(x.shape[1], z_stride)


def dx_tolerance(x, scale, w, invf, gy, z_stride, act, ref):
    """Per-element tolerance of a dx against its plain version ``ref``: one
    bf16 ulp of the element (f32 sums in another order, then rounded to
    bf16) plus 2^-12 of the sum of its terms' magnitudes |gy| |w| (|scale|).
    A dropped tap, a lost relu mask or a zero row moves an element by far
    more."""
    import torch

    from toda_tpu_torch.ops import fused_conv

    mag = fused_conv.fused_bnconv9_bwd_plain(
        x, torch.ones_like(scale), torch.zeros_like(scale), w.abs(), invf, gy.abs(), z_stride,
        False)[0].float()
    if act:
        mag = mag * scale.abs()
    return 2.0 ** -7 * ref.float().abs() + 2.0 ** -12 * mag


def bound_ms(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def peak_flops(x):
    import torch

    return H100_BF16_FLOPS if x.dtype == torch.bfloat16 else H100_F32_FLOPS


def conv_bound(work, x):
    """(bound, the operations alone in ms) of a fused-conv call's
    (bytes, flops) at x's dtype's peak."""
    nbytes, flops = work
    return dict(bound=bound_ms(nbytes, flops, peak_flops(x)), ops_ms=1e3 * flops / peak_flops(x))


def phase_kernels(bundle, batch):
    """Record the kernels' inputs on one full-width forward, then hold each
    kernel against its plain version on them and time both."""
    import torch

    from toda_tpu_torch.ops import fused_conv, gather, pillar_sparse

    with Recorder(fused_conv, "fused_bnconv9") as k1, \
            Recorder(pillar_sparse, "scatter_rows_add") as k4, \
            Recorder(pillar_sparse, "unpack_pillars") as k5:
        out = bundle.forward(bundle.to_device(batch))
    torch.cuda.synchronize()
    heads = out["center_pred_dicts"][0] if "center_pred_dicts" in out else {
        k: out[k] for k in ("cls_preds", "box_preds", "dir_cls_preds", "roi_ious") if k in out}
    for k, v in heads.items():
        assert torch.isfinite(v).all(), f"full-width head output {k} is not finite"
    assert len(k1.calls) == 11 and len(k4.calls) == 2 and len(k5.calls) == 1, \
        (len(k1.calls), len(k4.calls), len(k5.calls))

    rows = {"K1": [check_k1_call(*args) for args, _ in k1.calls], "K4": [], "K5": []}
    for (g, idx, n), _ in k4.calls:
        y = gather.scatter_rows_add(g, idx, n)
        ref = gather.scatter_rows_add_plain(g, idx, n)
        err = (y - ref).abs()
        assert bool((err <= 1e-5 + 1e-5 * ref.abs()).all()), \
            f"K4 {tuple(g.shape)}->{n}: max err {err.max().item()}"
        safe = torch.where(idx >= 0, idx.long(), n)
        gf = g.float()
        buf = torch.zeros((n + 1, g.shape[1]), dtype=torch.float32, device=g.device)
        nbytes = g.numel() * g.element_size() + idx.numel() * 4 + n * g.shape[1] * 4
        rows["K4"].append(dict(
            shape=f"g{tuple(g.shape)} {g.dtype} -> ({n}, {g.shape[1]})",
            err=err.max().item(), tol="1e-05 abs + rel",
            ms=cuda_ms(lambda: gather.scatter_rows_add(g, idx, n), 10),
            plain_ms=cuda_ms(lambda: gather.scatter_rows_add_plain(g, idx, n), 10),
            library_ms=cuda_ms(lambda: buf.index_add_(0, safe, gf), 10),
            bound=bound_ms(nbytes, g.numel(), H100_F32_FLOPS)))
    for (sums, c, cpad, dtype), _ in k5.calls:
        y = gather.unpack_pillars(sums, c, cpad, dtype)
        ref = gather.unpack_pillars_plain(sums, c, cpad, dtype)
        err = (y.float() - ref.float()).abs().max().item()
        assert err == 0.0, f"K5: max err {err} (the same IEEE division and rounding)"
        nbytes = sums.numel() * 4 + y.numel() * y.element_size()
        rows["K5"].append(dict(
            shape=f"sums{tuple(sums.shape)} -> {tuple(y.shape)} {dtype}",
            err=err, tol="0 (exact)",
            ms=cuda_ms(lambda: gather.unpack_pillars(sums, c, cpad, dtype), 10),
            plain_ms=cuda_ms(lambda: gather.unpack_pillars_plain(sums, c, cpad, dtype), 10),
            library_ms=None, bound=bound_ms(nbytes, sums.shape[0] * c * 2, H100_F32_FLOPS)))
    log_rows(rows)
    return rows


def log_rows(rows):
    for name, rs in rows.items():
        for r in rs:
            lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            plain = "-" if r["plain_ms"] is None else f"{r['plain_ms']:.4f}"
            share = "" if "share" not in r else \
                f", ops_ms {r['ops_ms']:.4f}, present pairs {r['share']:.4f}"
            log(f"  {name} {r['shape']}: max_abs_err {r['err']:.3g} (tol {r['tol']}), "
                f"ms {r['ms']:.4f}, plain_ms {plain}, library_ms {lib}, "
                f"bound_ms {r['bound'][0]:.4f} ({r['bound'][1]}){share}")


def pair_share(table):
    """The share of a (M, 9) tap table's (pillar, tap) pairs that are
    present: what the kernels' bounds count."""
    import torch

    return int(torch.count_nonzero(table >= 0).item()) / max(1, table.numel())


def check_k1_call(x, sc, sh, w, idx, s, act, plain=True):
    """Hold one K1 call against its plain version (two bf16 ulps abs + rel:
    the sum order differs and the output rounds to bf16) and time it (and
    its plain version unless ``plain`` is False); returns its row."""
    from toda_tpu_torch.ops import fused_conv

    y = fused_conv.fused_bnconv9(x, sc, sh, w, idx, s, act)
    ref = fused_conv.fused_bnconv9_plain(x, sc, sh, w, idx, s, act)
    err = (y.float() - ref.float()).abs()
    tol = 2.0 ** -7
    assert bool((err <= tol + tol * ref.float().abs()).all()), \
        f"K1 {tuple(x.shape)}->{tuple(y.shape)}: max err {err.max().item()}"
    del ref
    return dict(
        shape=f"x{tuple(x.shape)} s{s} act{int(act)} -> y{tuple(y.shape)}",
        err=err.max().item(), tol=f"{tol:g} abs + rel", share=pair_share(idx),
        ms=cuda_ms(lambda: fused_conv.fused_bnconv9(x, sc, sh, w, idx, s, act), 10),
        plain_ms=cuda_ms(lambda: fused_conv.fused_bnconv9_plain(x, sc, sh, w, idx, s, act), 3)
        if plain else None,
        library_ms=None, **conv_bound(k1_work(x, w, idx, s), x))


def check_dx_call(x, sc, sh, w, invf, gy, s, act, plain=True):
    """Hold one dx call against its plain version (``dx_tolerance``; the
    check must fail the plain dx with the centre inverse tap dropped and an
    all-zero dx), its dscale / dshift within 3e-5 of the sum of their
    terms' magnitudes (f32 channel sums over ~10^8 rows in another order;
    cancellation leaves the sums themselves far smaller), and time it."""
    import torch

    from toda_tpu_torch.ops import fused_conv

    dx, dsc, dsh = fused_conv.fused_bnconv9_bwd_dx(x, sc, sh, w, invf, gy, s, act)
    rdx, rsc, rsh = fused_conv.fused_bnconv9_bwd_plain(x, sc, sh, w, invf, gy, s, act)
    tol = dx_tolerance(x, sc, w, invf, gy, s, act, rdx)

    def dx_ok(v):
        return bool(((v.float() - rdx.float()).abs() <= tol).all())

    err = (dx.float() - rdx.float()).abs()
    assert dx_ok(dx), f"K2 dx {tuple(x.shape)}: max err {err.max().item()}"
    dropped = invf.clone()
    dropped[:, 4] = -1
    assert not dx_ok(fused_conv.fused_bnconv9_bwd_plain(
        x, sc, sh, w, dropped, gy, s, act)[0]), "the dx check passes a dropped tap"
    assert not dx_ok(torch.zeros_like(dx)), "the dx check passes a zero dx"
    g = (rdx.float() / sc).abs()
    for a, b, mag, name in ((dsc, rsc, (g * x.float().abs()).sum((0, 1)), "dscale"),
                            (dsh, rsh, g.sum((0, 1)), "dshift")):
        e = (a - b).abs()
        assert bool((e <= 3e-5 * mag + 1e-6).all()), f"K2 {name}: max err {e.max().item()}"
    del dx, rdx, tol, g, dropped
    return dict(
        shape=f"dx x{tuple(x.shape)} gy{tuple(gy.shape)} s{s} act{int(act)}",
        err=err.max().item(), tol="2^-7 rel + 2^-12 x sum|terms|", share=pair_share(invf),
        ms=cuda_ms(lambda: fused_conv.fused_bnconv9_bwd_dx(x, sc, sh, w, invf, gy, s, act), 5),
        plain_ms=cuda_ms(lambda: fused_conv.fused_bnconv9_bwd_plain(
            x, sc, sh, w, invf, gy, s, act), 2) if plain else None,
        library_ms=None, **conv_bound(dx_work(x, w, invf, gy, s), x))


def check_dw_call(x, sc, sh, idx, gy, s, act, plain=True):
    """Hold one dW call against its plain version (f32 sums over ~10^7
    rows in another order: within 3e-5 of the sum of the terms' magnitudes;
    the activation is >= 0 when act), a second run bit-equal to the first,
    and time it."""
    import torch

    from toda_tpu_torch.ops import fused_conv

    dw = fused_conv.fused_bnconv9_dw(x, sc, sh, idx, gy, s, act)
    again = fused_conv.fused_bnconv9_dw(x, sc, sh, idx, gy, s, act)
    assert torch.equal(dw, again), "dW: two runs differ (the sum order must be fixed)"
    ref = fused_conv.fused_bnconv9_dw_plain(x, sc, sh, idx, gy, s, act)
    mag = fused_conv.fused_bnconv9_dw_plain(x if act else x.abs(), sc, sh, idx, gy.abs(), s, act)
    err = (dw - ref).abs()
    assert bool((err <= 3e-5 * mag + 1e-6).all()), \
        f"dW {tuple(x.shape)} act {act}: max err {err.max().item()}"
    return dict(
        shape=f"dW x{tuple(x.shape)} gy{tuple(gy.shape)} s{s} act{int(act)}",
        err=err.max().item(), tol="3e-05 x sum|terms|, bit-equal reruns", share=pair_share(idx),
        ms=cuda_ms(lambda: fused_conv.fused_bnconv9_dw(x, sc, sh, idx, gy, s, act), 5),
        plain_ms=cuda_ms(lambda: fused_conv.fused_bnconv9_dw_plain(
            x, sc, sh, idx, gy, s, act), 2) if plain else None,
        library_ms=None, **conv_bound(dw_work(x, idx, gy, s), x))


def check_train_kernels(dx_calls, dw_calls, gather_calls):
    """Hold each recorded backward call's kernel against its plain version
    (``check_dx_call``, ``check_dw_call``; K6 exactly, ``check_gathers``)
    and time both; returns the K2, K3 and K6 rows."""
    rows = {"K2": [check_dx_call(*args) for args, _ in dx_calls], "K3": [], "K6": []}
    for args, _ in dw_calls:
        rows["K2" if args[-1] else "K3"].append(check_dw_call(*args))
    rows["K6"] = check_gathers((), gather_calls)["K6"]
    return rows


STRESS_EXTRA = 101  # rows past a stress table's plane: M is odd, not a multiple of a tile


def stress_table(h, w, stride, device):
    """A tap table no flagship scene gives, and its inverse: (idx, invf,
    m_in). The first rows are a dense h x w BEV plane (a LiDAR ground
    plane's neighbourhood; at stride 2 its (h/2) x (w/2) coarse cells), where
    every interior pillar has all 9 taps; then STRESS_EXTRA rows of which
    every 13th has its centre tap alone (onto an input row of its own) and
    the rest none, so each block of rows there holds one present pillar
    among pillars with no taps."""
    import torch

    ho, wo = h // stride, w // stride
    yy, xx = torch.meshgrid(torch.arange(ho, device=device), torch.arange(wo, device=device),
                            indexing="ij")
    taps = []
    for t in range(9):
        iy, ix = stride * yy + t // 3 - 1, stride * xx + t % 3 - 1
        inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        taps.append(torch.where(inside, iy * w + ix, -1).reshape(-1))
    extra = torch.full((STRESS_EXTRA, 9), -1, dtype=torch.long, device=device)
    k = torch.arange(STRESS_EXTRA, device=device)
    extra[:, 4] = torch.where(k % 13 == 6, h * w + k, -1)
    idx = torch.cat([torch.stack(taps, 1), extra]).int().contiguous()
    m_in = h * w + STRESS_EXTRA
    inv = torch.full((m_in * 9 + 1,), -1, dtype=torch.int32, device=device)
    slot = torch.where(idx >= 0, idx.long() * 9 + torch.arange(9, device=device), m_in * 9)
    rows = torch.arange(idx.shape[0], device=device, dtype=torch.int32)[:, None].expand(-1, 9)
    inv.scatter_(0, slot.reshape(-1), rows.reshape(-1))
    return idx, inv[:m_in * 9].view(m_in, 9), m_in


# (C, Cout, nz, z_stride, act, plane side) of the stress tables: stage-1
# widths (the first conv's C = 8 raw, a subm conv, the stride-2 down conv)
# and stage-3 widths (a subm conv and the stride-2 down conv to stage 4)
STRESS_LAYERS = ((8, 16, 40, 1, False, 256), (16, 16, 40, 1, True, 256),
                 (16, 32, 40, 2, False, 256), (64, 64, 10, 1, True, 128),
                 (64, 64, 10, 2, False, 128))


def phase_stress_tables():
    """K1, dx and dW (bf16) on ``stress_table`` tables at stage-1 and
    stage-3 widths, both strides, the first conv's C = 8 with act=False:
    each held against its plain version at the recorded calls' tolerances
    (``check_k1_call``, ``check_dx_call``, ``check_dw_call``), and timed
    beside its bound; the dense planes have every tap present, so the
    operations bound matters there. Their launches are not the main
    path's and are not counted."""
    import torch

    rows = {"K1": [], "K2": [], "K3": []}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for c, cout, nz, s, act, side in STRESS_LAYERS:
        idx, invf, m_in = stress_table(side, side, s, "cuda")
        nz_out = -(-nz // s)

        def rand(*shape, std=1.0):
            return (torch.randn(shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

        x = rand(m_in, nz, c)
        sc = (0.5 + torch.rand(c, generator=gen, device="cuda")).contiguous()
        sh = (torch.rand(c, generator=gen, device="cuda") - 0.5).contiguous()
        w = rand(3, 3, 3, c, cout, std=(2.0 / (27 * c)) ** 0.5)
        gy = rand(idx.shape[0], nz_out, cout)
        rows["K1"].append(check_k1_call(x, sc, sh, w, idx, s, act, plain=False))
        rows["K2"].append(check_dx_call(x, sc, sh, w, invf, gy, s, act, plain=False))
        rows["K2" if act else "K3"].append(check_dw_call(x, sc, sh, idx, gy, s, act,
                                                        plain=False))
        del x, w, gy, idx, invf
        torch.cuda.empty_cache()
    log(f"phase stress tables (bf16; dense planes with every tap present, then "
        f"{STRESS_EXTRA} rows of lone pillars and pillars with no taps):")
    log_rows(rows)
    return rows


UNPACK_STRESS_CELLS = 512 * 7 + 37  # K5's blocks take 512 cells: a partial last block


def unpack_sums(gen, ncell, c, device):
    """(ncell, c + 1) f32 voxelizer sums: counts in [0, 12] with every
    integer and every x.5 (rint's ties, to even), zeros among them, and
    feature sums of that many points."""
    import torch

    cnt = torch.randint(0, 25, (ncell,), generator=gen).float() / 2
    feats = torch.randn((ncell, c), generator=gen) * (cnt[:, None] + 1) * 7
    return torch.cat([feats, cnt[:, None]], 1).to(device)


def phase_stress_unpack():
    """K5 exactly against its plain version on calls no scene gives: a cell
    count that leaves the last block partial, the sums 4, 8 and 12 bytes
    past a 16-byte boundary (and aligned), c = 1, 4, 5 and 64, cpad 5, 6, 8
    (and 64), f32 and bf16 outputs, counts of 0 and of x.5."""
    import torch

    from toda_tpu_torch.ops import gather

    gen = torch.Generator().manual_seed(SEED)
    cases = [(c, cpad) for c in (1, 4, 5) for cpad in (5, 6, 8) if cpad >= c] + [(64, 64)]
    n = 0
    for c, cpad in cases:
        base = unpack_sums(gen, UNPACK_STRESS_CELLS, c, "cuda")
        for shift in (0, 1, 2, 3):
            buf = torch.empty(base.numel() + 4, dtype=torch.float32, device="cuda")
            sums = buf[shift:shift + base.numel()].view_as(base)
            sums.copy_(base)
            assert sums.data_ptr() % 16 == 4 * shift and sums.is_contiguous()
            for dtype in (torch.float32, torch.bfloat16):
                y = gather.unpack_pillars(sums, c, cpad, dtype)
                ref = gather.unpack_pillars_plain(sums, c, cpad, dtype)
                torch.cuda.synchronize()
                assert torch.equal(y, ref), \
                    f"K5 stress c {c} cpad {cpad} {dtype} sums +{4 * shift} B: not exact"
                n += 1
    ties = (base[:, -1] * 2) % 2 == 1
    log(f"phase stress K5: {n} calls exactly equal to the plain version ({len(cases)} (c, "
        f"cpad) pairs from (1, 5) to (64, 64), the sums 0/4/8/12 bytes past 16-byte "
        f"alignment, f32 and bf16 out, {UNPACK_STRESS_CELLS} cells = 7 blocks of 512 + 37, "
        f"{int((base[:, -1] == 0).sum())} zero counts and {int(ties.sum())} x.5 counts in the "
        f"last table)")


def phase_train_kernels(state, step, batch):
    """Record the backward kernels' inputs on one full-width train step, then
    hold each kernel against its plain version on them and time both."""
    import torch

    from toda_tpu_torch.ops import fused_conv, gather

    # the dense scatter's VJP calls gather_rows from inside ops/gather.py
    with Recorder(fused_conv, "fused_bnconv9_bwd_dx") as kdx, \
            Recorder(fused_conv, "fused_bnconv9_dw") as kdw, \
            Recorder(gather, "gather_rows") as k6:
        _, tb = step(state, batch)
        loss = float(tb["loss"])
    assert math.isfinite(loss), loss
    assert len(kdx.calls) == 10 and len(kdw.calls) == 11 and len(k6.calls) == 1, \
        (len(kdx.calls), len(kdw.calls), len(k6.calls))

    # the recorded scale, shift and weights carry autograd history: check
    # without recording, or every plain version keeps its whole graph alive
    with torch.no_grad():
        rows = check_train_kernels(kdx.calls, kdw.calls, k6.calls)
    log(f"phase train kernels: recorded step loss {loss:.4f}")
    log_rows(rows)
    return rows


def phase_main_path(bundle, cfg, loader, dataset):
    """eval_one_epoch with every counter at 0; then steady predict throughput."""
    import numpy as np
    import torch

    from toda_tpu_torch.ops import fused_conv, gather
    from toda_tpu_torch.runtime.eval_utils import eval_one_epoch

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    result, annos = eval_one_epoch(bundle, loader, dataset, cfg.CLASS_NAMES)
    wall = time.time() - t0
    launches = {"K1": fused_conv.LAUNCHES["fused_bnconv9"],
                "K4": gather.LAUNCHES["scatter_rows_add"],
                "K5": gather.LAUNCHES["unpack_pillars"]}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_fwd = len(loader)
    assert launches["K1"] == 11 * n_fwd, launches
    assert launches["K4"] == 2 * n_fwd and launches["K5"] == n_fwd, launches
    assert gather.LAUNCHES["gather9_stacked_t"] == gather.LAUNCHES["gather_rows_taps_t"] == 0
    assert len(annos) == BATCH * n_fwd
    for a in annos:
        assert np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
    n_det = sum(len(a["score"]) for a in annos)
    log(f"phase main path: eval_one_epoch over {n_fwd} batches of {BATCH} in {wall:.1f}s; "
        f"launches {launches}; {n_det} detections, all finite; "
        f"mAP {result['mAP']:.4f}, recall/0.3 {result['recall/0.3']:.4f}; "
        f"eval sec/example {result['sec_per_example']:.4f} "
        f"({1.0 / result['sec_per_example']:.2f} scans/s incl. host recall + mAP prep); "
        f"peak device memory {peak_gib:.2f} GiB")

    # steady-state predict (forward + decode + NMS) as bench.py times it:
    # device-resident batches, one host readback per step, best of 3 passes
    best = steady_rate(predict_run(bundle, loader))
    log(f"phase predict throughput: {best:.2f} scans/s steady state (batch {BATCH}, "
        f"best of 3 x 10 steps)")
    return launches, best


def phase_train_main(bundle, state, step, batches):
    """TRAIN_STEPS make_train_step steps with every counter at 0, loss read
    back every step; then the steady train throughput and peak memory."""
    import torch

    from toda_tpu_torch.ops import fused_conv, gather

    # dW runs with act=False (K3's function) on the four raw-input layers:
    # stage 1's first conv and the three down convs, whose inputs are the
    # residual joins' applied outputs
    per_step = {"K1": 11, "K2dx": 10, "dW": 11, "K6": 1, "K4": 2, "K5": 1, "dW_raw": 4}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    losses = []
    for i in range(TRAIN_STEPS):
        state, tb = step(state, batches[i % len(batches)])
        losses.append(float(tb["loss"]))
    wall = time.time() - t0
    fc, ga = fused_conv.LAUNCHES, gather.LAUNCHES
    launches = {"K1": fc["fused_bnconv9"], "K2dx": fc["fused_bnconv9_bwd_dx"],
                "dW": fc["fused_bnconv9_dw"], "K6": ga["gather_rows"],
                "K4": ga["scatter_rows_add"], "K5": ga["unpack_pillars"],
                "dW_raw": fc["fused_bnconv9_dw_raw"]}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    assert launches == {k: n * TRAIN_STEPS for k, n in per_step.items()}, launches
    assert ga["gather9_stacked_t"] == ga["gather_rows_taps_t"] == 0
    assert all(math.isfinite(v) for v in losses), losses
    log(f"phase train main path: {TRAIN_STEPS} make_train_step steps (batch {BATCH}, "
        f"numpy batches in) in {wall:.1f}s; launches {launches}; losses "
        f"{[round(v, 4) for v in losses]}; peak device memory {peak_gib:.2f} GiB")

    # steady state as bench.py times training: device-resident batches, the
    # loss read back every step, best of 3 passes
    best = steady_rate(train_run(bundle, state, step, batches))
    log(f"phase train throughput: {best:.2f} scans/s steady state (batch {BATCH}, best of "
        f"3 x 10 steps, loss read back every step)")
    return launches, best, peak_gib, bundle.to_device(batches[0])


PROFILER_RANGES = ("Buffer Flush", "Activity Buffer Request")


def phase_profile(run, what):
    """Kernel time by name over 2 steps of ``run`` (torch.profiler), and the
    device's busy share of the steady step time measured just before."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    step_ms = (time.time() - t) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # the profiler's activity-buffer ranges and the stage ranges' spans on
    # the device are not kernels
    dev_ms = sum(e.self_device_time_total for e in ka if e.device_type == DeviceType.CUDA
                 and e.key not in PROFILER_RANGES and not e.key.startswith("stage:")) / 2e3
    log(f"profile {what}: steady step {step_ms:.1f} ms (host clock, batch {BATCH}); device "
        f"kernel time {dev_ms:.1f} ms per step; busy share {dev_ms / step_ms:.3f}")
    # a stage range's host-side entry sums the kernel time of the aten ops it
    # ran, not of the port's own kernels (launched through ctypes); its
    # device-side entry spans the range's work on the device, gaps included
    for side, what in ((DeviceType.CPU, "aten kernel time"), (DeviceType.CUDA, "device span")):
        stages = [e for e in ka if e.key.startswith("stage:") and e.device_type == side]
        if stages:
            log(f"  {what} by stage per step: " + ", ".join(
                f"{e.key[6:]} {e.device_time_total / 2e3:.1f} ms" for e in stages))
    log(ka.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))


PARTA2_HEAD_KEYS = ("point_cls_scores", "point_part_offset", "point_features",
                    "spatial_features_2d", "cls_preds", "box_preds", "dir_cls_preds")


def phase_parta2_tiny_parity():
    """Tiny PartA2 in f32: cuda vs cpu on the same weights and batch; then
    the RoI head on both devices from the cpu's RoIs and point outputs.
    Twice: in full f32, and with cuDNN's TF32 on, the precision the
    full-width run is timed at."""
    import numpy as np
    import torch

    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.weights import randomize_

    cfg = parta2_tiny_cfg()
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2)
    batch = next(iter(loader))
    cpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
    randomize_(cpu.module, SEED)
    gpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cuda")
    gpu.module.load_state_dict(cpu.module.state_dict(), strict=True)
    out_c = cpu.forward(cpu.to_device(batch))
    head_in = {k: out_c[k] for k in ("point_features", "point_coords", "point_mask",
                                     "point_cls_scores", "point_part_offset", "rois", "roi_mask")}
    # f32: only summation order differs, elementwise to 1e-3. TF32 rounds
    # every convolution's inputs to 10 mantissa bits (2^-11 relative), so
    # each output is held to 5e-3 of max(1, its largest magnitude), ~4x the
    # 1.23e-3 read on an H100.
    for tf32, tol in ((False, 1e-3), (True, 5e-3)):
        torch.backends.cudnn.allow_tf32 = tf32
        out_g = gpu.forward(gpu.to_device(batch))
        with torch.inference_mode():
            rcnn_g = gpu.module.roi_head({k: v.cuda() for k, v in head_in.items()})
        worst = 0.0
        pairs = [(k, out_c[k], out_g[k]) for k in PARTA2_HEAD_KEYS]
        pairs += [(k, out_c[k], rcnn_g[k]) for k in ("rcnn_cls", "rcnn_reg")]
        for name, a, b in pairs:
            b = b.cpu()
            err = (a - b).abs().max().item()
            rel = err / max(1.0, a.abs().max().item())
            worst = max(worst, rel)
            ok = rel <= tol if tf32 else torch.allclose(a, b, rtol=tol, atol=tol)
            assert ok, f"tiny PartA2 cuda/cpu (TF32 {tf32}) {name}: max err {err}, rel {rel:.3g}"
        log(f"phase PartA2 tiny cuda-vs-cpu (f32, cuDNN TF32 {'on' if tf32 else 'off'}): point, "
            f"BEV and anchor head outputs and the RoI head on the same RoIs agree, max rel err "
            f"{worst:.3g} (tol {tol})")
    torch.backends.cudnn.allow_tf32 = False


def gather_bound(table, idx):
    """(bytes, 0 flops) of one row gather: the rows that idx names read
    once, every output row written once, idx read once."""
    import torch

    row_bytes = table.shape[1] * table.element_size()
    return (int(torch.count_nonzero(idx >= 0).item()) + idx.numel()) * row_bytes \
        + idx.numel() * 4, 0


def check_gathers(taps_calls, gather_calls):
    """Hold each recorded K9 and K6 call against its plain version (exact)
    and time it beside its plain version and the library's index_select."""
    import torch

    from toda_tpu_torch.ops import gather

    rows = {"K9": [], "K6": []}
    for key, calls, fn, plain in (
            ("K9", taps_calls, gather.gather_rows_taps, gather.gather_rows_taps_plain),
            ("K6", gather_calls, gather.gather_rows, gather.gather_rows_plain)):
        for (table, idx), _ in calls:
            out = fn(table, idx)
            assert torch.equal(out, plain(table, idx)), f"{key} {tuple(table.shape)} differs"
            padded = torch.cat([table, table.new_zeros((1, table.shape[1]))])
            safe = torch.where(idx >= 0, idx.long(), table.shape[0])
            if key == "K9":
                safe = safe.t().contiguous()

                def library(padded=padded, safe=safe):
                    return [padded.index_select(0, s) for s in safe]
            else:
                def library(padded=padded, safe=safe):
                    return padded.index_select(0, safe)
            rows[key].append(dict(
                shape=f"table{tuple(table.shape)} {table.dtype} idx{tuple(idx.shape)}",
                err=0.0, tol="0 (exact)",
                ms=cuda_ms(lambda: fn(table, idx), 10),
                plain_ms=cuda_ms(lambda: plain(table, idx), 3),
                library_ms=cuda_ms(library, 10),
                bound=bound_ms(*gather_bound(table, idx), H100_F32_FLOPS)))
            del out, padded, safe, library
    return rows


def phase_parta2_kernels(bundle, batch):
    """Record every K9, K6, K4 and K5 call of one full-width PartA2 forward,
    then hold each kernel against its plain version on them and time both."""
    import torch

    from toda_tpu_torch.ops import gather, pillar_sparse

    with Recorder(pillar_sparse, "gather_rows_taps") as k9, \
            Recorder(pillar_sparse, "gather_rows") as k6, \
            Recorder(pillar_sparse, "scatter_rows_add") as k4, \
            Recorder(pillar_sparse, "unpack_pillars") as k5:
        out = bundle.forward(bundle.to_device(batch))
    torch.cuda.synchronize()
    for k in ("point_cls_scores", "rcnn_cls", "rcnn_reg", "rois"):
        assert torch.isfinite(out[k]).all(), f"full-width PartA2 output {k} is not finite"
    assert len(k9.calls) == 63 and len(k6.calls) == 27, (len(k9.calls), len(k6.calls))
    assert len(k4.calls) == 1 and len(k5.calls) == 1, (len(k4.calls), len(k5.calls))
    log(f"phase PartA2 kernels: one forward, {int(out['roi_mask'].sum())} RoIs kept; "
        f"{len(k9.calls)} K9 and {len(k6.calls)} K6 calls recorded")
    del out
    with torch.no_grad():
        rows = check_gathers(k9.calls, k6.calls)
        for (g, idx, n), _ in k4.calls:
            y = gather.scatter_rows_add(g, idx, n)
            ref = gather.scatter_rows_add_plain(g, idx, n)
            err = (y - ref).abs()
            assert bool((err <= 1e-5 + 1e-5 * ref.abs()).all()), f"K4: max err {err.max()}"
            safe = torch.where(idx >= 0, idx.long(), n)
            buf = torch.zeros((n + 1, g.shape[1]), dtype=torch.float32, device=g.device)
            nbytes = g.numel() * g.element_size() + idx.numel() * 4 + n * g.shape[1] * 4
            rows.setdefault("K4", []).append(dict(
                shape=f"g{tuple(g.shape)} -> ({n}, {g.shape[1]})", err=err.max().item(),
                tol="1e-05 abs + rel", ms=cuda_ms(lambda: gather.scatter_rows_add(g, idx, n), 10),
                plain_ms=cuda_ms(lambda: gather.scatter_rows_add_plain(g, idx, n), 10),
                library_ms=cuda_ms(lambda: buf.index_add_(0, safe, g), 10),
                bound=bound_ms(nbytes, g.numel(), H100_F32_FLOPS)))
        for (sums, c, cpad, dtype), _ in k5.calls:
            y = gather.unpack_pillars(sums, c, cpad, dtype)
            assert torch.equal(y, gather.unpack_pillars_plain(sums, c, cpad, dtype)), "K5"
            rows.setdefault("K5", []).append(dict(
                shape=f"sums{tuple(sums.shape)} -> {tuple(y.shape)} {dtype}", err=0.0,
                tol="0 (exact)", ms=cuda_ms(lambda: gather.unpack_pillars(sums, c, cpad, dtype), 10),
                plain_ms=cuda_ms(lambda: gather.unpack_pillars_plain(sums, c, cpad, dtype), 10),
                library_ms=None,
                bound=bound_ms(sums.numel() * 4 + y.numel() * y.element_size(),
                               sums.shape[0] * c * 2, H100_F32_FLOPS)))
    log_rows({k: rows[k] for k in ("K4", "K5")})
    for key in ("K9", "K6"):
        # one line per distinct call shape: the calls' count and summed numbers
        shapes = {}
        for r in rows[key]:
            shapes.setdefault(r["shape"], []).append(r)
        for shape, rs in shapes.items():
            log(f"  {key} {len(rs)} x {shape}: exact; ms {sum(r['ms'] for r in rs):.4f}, "
                f"plain_ms {sum(r['plain_ms'] for r in rs):.4f}, index_select ms "
                f"{sum(r['library_ms'] for r in rs):.4f}, bound_ms "
                f"{sum(r['bound'][0] for r in rs):.4f} (bytes)")
        log(f"  {key} per forward: {sum(r['ms'] for r in rows[key]):.3f} ms over "
            f"{len(rows[key])} calls, bound {sum(r['bound'][0] for r in rows[key]):.3f} ms, "
            f"plain {sum(r['plain_ms'] for r in rows[key]):.3f} ms, index_select "
            f"{sum(r['library_ms'] for r in rows[key]):.3f} ms")
    return rows


def phase_parta2_main(bundle, cfg, loader, dataset):
    """eval_one_epoch with every counter at 0; then the steady predict
    throughput; returns the launches and scans/s."""
    import numpy as np
    import torch

    from toda_tpu_torch.ops import fused_conv, gather
    from toda_tpu_torch.runtime.eval_utils import eval_one_epoch

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    result, annos = eval_one_epoch(bundle, loader, dataset, cfg.CLASS_NAMES)
    wall = time.time() - t0
    ga = gather.LAUNCHES
    launches = {"K9": ga["gather_rows_taps"], "K6": ga["gather_rows"],
                "K4": ga["scatter_rows_add"], "K5": ga["unpack_pillars"],
                "K1": fused_conv.LAUNCHES["fused_bnconv9"]}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_fwd = len(loader)
    assert n_fwd >= 3, n_fwd
    assert launches == {"K9": 63 * n_fwd, "K6": 27 * n_fwd, "K4": n_fwd, "K5": n_fwd,
                        "K1": 0}, launches
    assert ga["gather9_stacked_t"] == ga["gather_rows_taps_t"] == 0
    assert len(annos) == BATCH * n_fwd
    for a in annos:
        assert np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
    assert "recall/roi_0.3" in result, sorted(result)
    n_det = sum(len(a["score"]) for a in annos)
    log(f"phase PartA2 main path: eval_one_epoch over {n_fwd} batches of {BATCH} in "
        f"{wall:.1f}s; launches {launches}; {n_det} detections, all finite; mAP "
        f"{result['mAP']:.4f}, recall/0.3 {result['recall/0.3']:.4f}, recall/roi_0.3 "
        f"{result['recall/roi_0.3']:.4f}, recall/roi_0.5 {result['recall/roi_0.5']:.4f}; "
        f"eval sec/example {result['sec_per_example']:.4f}; peak device memory "
        f"{peak_gib:.2f} GiB")

    best = steady_rate(predict_run(bundle, loader))
    log(f"phase PartA2 predict throughput: {best:.2f} scans/s steady state (batch {BATCH}, "
        f"best of 3 x 10 steps)")
    return launches, best, bundle.to_device(next(iter(loader)))


def phase_parta2_tf32(bundle, dev):
    """PartA2's f32 convolutions (the BEV backbone's and the RoI head's)
    under cuDNN TF32 at full width: one forward of the batch with TF32 off
    and one with it on. The dense head maps compare directly; the RoI head
    runs under TF32 on the TF32-off forward's RoIs and point outputs (the
    proposal NMS may keep other RoIs). Prints each output's max |diff| over
    max(1, its largest magnitude), beside the tiny check's 5e-3."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    ref = bundle.forward(dev)
    torch.backends.cudnn.allow_tf32 = True
    out = bundle.forward(dev)
    with torch.inference_mode():
        rcnn = bundle.module.roi_head({k: ref[k] for k in (
            "point_features", "point_coords", "point_mask", "point_cls_scores",
            "point_part_offset", "rois", "roi_mask")})
    rels = {k: (ref[k] - out[k]).abs().max().item() / max(1.0, ref[k].abs().max().item())
            for k in ("cls_preds", "box_preds")}
    rels.update({k: (ref[k] - rcnn[k]).abs().max().item() / max(1.0, ref[k].abs().max().item())
                 for k in ("rcnn_cls", "rcnn_reg")})
    same = int((ref["rois"] == out["rois"]).all(-1).sum())
    log(f"phase PartA2 TF32 at full width (one forward, batch {BATCH}): max rel diff TF32 on vs "
        f"off " + ", ".join(f"{k} {v:.3g}" for k, v in rels.items())
        + f" (the tiny check's tolerance 5e-3); {same} of {ref['rois'].shape[0] * ref['rois'].shape[1]}"
        f" RoI slots identical across the two forwards")
    return rels


PVRCNN_KEYS = ("point_features_before_fusion", "point_features", "point_cls_scores",
                     "spatial_features_2d", "cls_preds", "box_preds", "dir_cls_preds")


def pvrcnn_tiny_cfg():
    from toda_tpu_torch.config import EDict, cfg_from_yaml_file

    return cfg_from_yaml_file(
        str(REPO / "tools/cfgs/synthetic_models/pvrcnn_synthetic.yaml"), EDict())


def phase_pvrcnn_tiny_parity():
    """Tiny PV-RCNN (pvrcnn_synthetic.yaml) in f32, TF32 off: cuda vs cpu on
    the same weights and batch. The FPS keypoints and their mask equal; the
    keypoint, BEV and anchor head outputs to 1e-3; the RoI head on both
    devices from the cpu's RoIs and keypoint outputs to 1e-3."""
    import numpy as np
    import torch

    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.weights import randomize_

    cfg = pvrcnn_tiny_cfg()
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2)
    batch = next(iter(loader))
    cpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
    randomize_(cpu.module, SEED)
    gpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cuda")
    gpu.module.load_state_dict(cpu.module.state_dict(), strict=True)
    out_c = cpu.forward(cpu.to_device(batch))
    out_g = gpu.forward(gpu.to_device(batch))
    for k in ("point_coords", "point_mask"):
        assert torch.equal(out_c[k], out_g[k].cpu()), f"tiny PV-RCNN cuda/cpu {k} differ"
    with torch.inference_mode():
        rcnn_g = gpu.module.roi_head({k: out_c[k].cuda() for k in (
            "point_features", "point_coords", "point_mask", "point_cls_scores", "rois",
            "roi_mask")})
    tol = 1e-3  # f32 on both sides, TF32 off: only summation order differs
    worst = 0.0
    pairs = [(k, out_c[k], out_g[k]) for k in PVRCNN_KEYS]
    pairs += [(k, out_c[k], rcnn_g[k]) for k in ("rcnn_cls", "rcnn_reg")]
    for name, a, b in pairs:
        b = b.cpu()
        err = (a - b).abs().max().item()
        worst = max(worst, err / max(1.0, a.abs().max().item()))
        assert torch.allclose(a, b, rtol=tol, atol=tol), f"tiny PV-RCNN cuda/cpu {name}: {err}"
    log(f"phase PV-RCNN tiny cuda-vs-cpu (f32, TF32 off): FPS keypoints equal; keypoint, BEV "
        f"and anchor head outputs and the RoI head on the same RoIs agree, max rel err "
        f"{worst:.3g} (tol {tol})")


def fps_bound(points, mask, ns):
    """(bound_ms, by) of one FPS call: the points and mask read once, the
    indices written once; 9 f32 operations (3 sub, 3 mul, 2 add, 1 min) a
    point and step after the first."""
    b, n, _ = points.shape
    nbytes = points.numel() * 4 + mask.numel() + b * ns * 4
    return bound_ms(nbytes, 9 * b * n * (ns - 1), H100_F32_FLOPS)


def bq_bound(xyz, xmask, q, qmask, nsample, idx, cnt):
    """(bound_ms, by) of one ball query, a floor any exact algorithm obeys:
    the inputs read once and idx and cnt written once (bytes); 9 f32
    operations (3 sub, 3 mul, 2 add, 1 compare) for each returned
    neighbour, 9 x the sum of cnt (operations); the larger of the two."""
    nbytes = (xyz.numel() * 4 + xmask.numel() + q.numel() * 4 + qmask.numel()
              + idx.numel() * 4 + cnt.numel() * 4)
    return bound_ms(nbytes, 9 * int(cnt.sum().item()), H100_F32_FLOPS)


def device_ops(run, calls=5):
    """The device kernels, copies and memsets of one call of run(), from a
    torch.profiler trace of ``calls`` calls (CPU and CUDA activities, as
    ``phase_profile`` traces): (their count, their device us, [(name, us)]
    by device time), each a mean over the calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.key not in PROFILER_RANGES]
    by_time = sorted(((e.key, e.self_device_time_total / calls) for e in ops),
                     key=lambda t: -t[1])
    return sum(e.count for e in ops) / calls, sum(t for _, t in by_time), by_time


BQ_STRESS_SCANS = 4


def bq_lattice(gen, pillars=8192, sites=5):
    """x_conv4's sources at full size: the voxel centres of ``pillars``
    random pillars of the Waymo 1504 x 1504 grid at stride 8 (a 0.8 m
    lattice) and ``sites`` z-sites each, as ``_voxel_source_points``
    computes them (4 x 40,960 candidates); ~10% of the pillars invalid, the
    last scan all invalid. Queries: 4096 a scan, a third lattice sites, a
    third sites moved by exactly 2.4 m along x (three steps: d2 == r2 in
    real numbers for 2.4 and on the 4.8 ball's lattice rows), a third
    random in the lattice's box; every 64th invalid."""
    import torch

    from toda_tpu_torch.models.backbones_3d.pfe import voxel_set_abstraction as vsa

    b = BQ_STRESS_SCANS
    cells = torch.stack([torch.randperm(188 * 188, generator=gen)[:pillars] for _ in range(b)])
    coords = torch.stack([cells // 188, cells % 188], -1)
    pmask = torch.rand((b, pillars), generator=gen) > 0.1
    pmask[-1] = False
    ms = {"features": torch.zeros((b, pillars, sites, 1)), "coords": coords, "mask": pmask,
          "stride": 8}
    xyz, _, mask = vsa._voxel_source_points(ms, (0.1, 0.1, 0.15), (-75.2, -75.2, -2.0), 40)
    m = 4096
    q = xyz[:, torch.randint(0, xyz.shape[1], (m,), generator=gen)].clone()
    q[:, m // 3:2 * m // 3, 0] += 2.4
    q[:, 2 * m // 3:] = torch.rand((b, m - 2 * m // 3, 3), generator=gen) * torch.tensor(
        [150.4, 150.4, 6.0]) + torch.tensor([-75.2, -75.2, -2.0])
    qmask = torch.ones((b, m), dtype=torch.bool)
    qmask[:, ::64] = False
    return xyz, mask, q, qmask


def bq_boundaries(gen, radius, n=65536, m=4096):
    """n points a scan in [-10, 10)^2 x [-2, 4), ~10% invalid, a point at
    the grid's corner, half the points on cell boundaries of
    ``ball_query_grid``'s grid (corner + k * side, and the f32 values next
    to them); queries on boundaries moved by exactly the radius along one
    axis, near points, one just outside the corner (within the radius of
    it), one far outside the cloud."""
    import torch

    b = BQ_STRESS_SCANS
    lo = torch.tensor([-10.0, -10.0, -2.0])
    xyz = torch.rand((b, n, 3), generator=gen) * torch.tensor([20.0, 20.0, 6.0]) + lo
    mask = torch.rand((b, n), generator=gen) > 0.1
    xyz[:, 0], mask[:, 0] = lo, True
    side = torch.tensor(radius * (1 + 2.0 ** -10), dtype=torch.float32)
    k = torch.floor(torch.rand((b, n // 2, 3), generator=gen) * ((xyz[0, 1:].amax(0) - lo) / side))
    on = lo + k * side
    on = torch.nextafter(on, on + torch.randint(-1, 2, on.shape, generator=gen).float())
    xyz[:, 1:n // 2 + 1] = torch.maximum(on, lo)
    pick = torch.randint(1, n // 2 + 1, (m,), generator=gen)
    q = xyz[:, pick].clone()
    axis = torch.randint(0, 3, (m,), generator=gen)
    q[:, torch.arange(m), axis] += torch.tensor(radius, dtype=torch.float32)
    q[:, m // 2:] += torch.randn((b, m - m // 2, 3), generator=gen) * radius
    q[:, 0] = lo - 0.9 * radius
    q[:, 1] = 1000.0
    return xyz, mask, q, torch.ones((b, m), dtype=torch.bool)


def bq_cluster(gen, n=20003, dense=6000, m=1024):
    """n points a scan (not a multiple of 32): ``dense`` of them in a 1 m
    cube at random indices (so one ball holds hundreds of hits in several
    cells, their indices interleaved between the cells), the rest spread
    over 40 x 40 x 4 m; queries in and around the cube."""
    import torch

    b = BQ_STRESS_SCANS
    xyz = torch.rand((b, n, 3), generator=gen) * torch.tensor([40.0, 40.0, 4.0]) - 20.0
    at = torch.stack([torch.randperm(n, generator=gen)[:dense] for _ in range(b)])
    xyz.scatter_(1, at[..., None].expand(-1, -1, 3), torch.rand((b, dense, 3), generator=gen))
    q = torch.rand((b, m, 3), generator=gen) * 1.6 - 0.3
    return xyz, torch.ones((b, n), dtype=torch.bool), q, torch.ones((b, m), dtype=torch.bool)


def phase_stress_ball_query():
    """The ball query (BQ) exactly against its plain version on calls no
    scene gives: x_conv4's lattice at 4 x 40,960 candidates with radii
    2.4 and 4.8 (multiples of its spacing) and an all-invalid scan; points
    on the grid's cell boundaries with queries at exactly the radius, one
    outside the cloud and one far away; a dense cluster with hundreds of
    hits a ball in several cells, N not a multiple of 32, nsample 16, 32,
    64 and 128."""
    import torch

    from toda_tpu_torch.ops import pointnet2_ops as p2

    gen = torch.Generator().manual_seed(SEED)
    lattice, cluster = bq_lattice(gen), bq_cluster(gen)
    cases = [("lattice", 2.4, 16, lattice), ("lattice", 4.8, 32, lattice),
             ("boundaries", 0.4, 16, bq_boundaries(gen, 0.4)),
             ("boundaries", 0.8, 32, bq_boundaries(gen, 0.8))]
    cases += [("cluster", 0.4, ns, cluster) for ns in (16, 32, 64, 128)]
    for what, radius, ns, args in cases:
        xyz, mask, q, qmask = (t.cuda() for t in args)
        idx, cnt = p2.ball_query(radius, ns, xyz, mask, q, qmask)
        ref = p2.ball_query_plain(radius, ns, xyz, mask, q, qmask)
        torch.cuda.synchronize()
        assert torch.equal(cnt, ref[1]) and torch.equal(idx, ref[0]), \
            f"BQ stress {what} r {radius} ns {ns}: differs from the plain version"
        full = (cnt == ns).float().mean().item()
        if what == "lattice":
            assert (cnt[-1] == 0).all() and (cnt[0] > 0).any(), "BQ stress lattice: counts"
        if what == "cluster":
            assert full > 0, "BQ stress cluster: no query holds more than nsample hits"
        log(f"  BQ stress {what} r {radius} ns {ns} xyz{tuple(xyz.shape)} "
            f"queries{tuple(q.shape[:2])}: equal; mean count {cnt.float().mean().item():.2f}, "
            f"{full:.3f} of the queries full, ms "
            f"{cuda_ms(lambda: p2.ball_query(radius, ns, xyz, mask, q, qmask), 3):.4f}")
    log(f"phase stress BQ: {len(cases)} calls exactly equal to the plain version")


def check_point_ops(fps_calls, bq_calls):
    """Hold each recorded FPS and ball-query call against its plain version
    (indices and counts equal) and time both; log the device operations of
    the first ball-query call (the raw points') by device time."""
    import torch

    from toda_tpu_torch.ops import pointnet2_ops as p2

    rows = {"FPS": [], "BQ": []}
    for (points, mask, ns), _ in fps_calls:
        got = p2.farthest_point_sampling(points, mask, ns)
        assert torch.equal(got, p2.farthest_point_sampling_plain(points, mask, ns)), "FPS differs"
        rows["FPS"].append(dict(
            shape=f"points{tuple(points.shape)} -> {ns} samples", err=0.0, tol="0 (exact)",
            ms=cuda_ms(lambda: p2.farthest_point_sampling(points, mask, ns), 3, warmup=1),
            plain_ms=cuda_ms(lambda: p2.farthest_point_sampling_plain(points, mask, ns), 1,
                             warmup=0),
            library_ms=None, bound=fps_bound(points, mask, ns)))
    (radius, ns, xyz, xmask, q, qmask, *_), _ = bq_calls[0]
    n_ops, us, by_time = device_ops(lambda: p2.ball_query(radius, ns, xyz, xmask, q, qmask))
    log(f"  BQ r {radius} xyz{tuple(xyz.shape)}: one call launches {n_ops:g} device kernels, "
        f"copies and memsets (two memsets, the bounds, keys and pack kernels, the radix "
        f"sort's passes, the grid kernel), {us:.1f} us of device time: " + ", ".join(
            f"{name[:48]} {t:.1f}" for name, t in by_time))
    for (radius, ns, xyz, xmask, q, qmask, *_), _ in bq_calls:
        idx, cnt = p2.ball_query(radius, ns, xyz, xmask, q, qmask)
        ref = p2.ball_query_plain(radius, ns, xyz, xmask, q, qmask)
        assert torch.equal(cnt, ref[1]) and torch.equal(idx, ref[0]), \
            f"BQ r {radius} ns {ns} {tuple(xyz.shape)} differs"
        rows["BQ"].append(dict(
            shape=f"r {radius} ns {ns} xyz{tuple(xyz.shape)} queries{tuple(q.shape[:2])}, "
                  f"mean count {cnt.float().mean().item():.2f}",
            err=0.0, tol="0 (exact)", ms=cuda_ms(lambda: p2.ball_query(radius, ns, xyz, xmask, q,
                                                                       qmask), 5),
            plain_ms=cuda_ms(lambda: p2.ball_query_plain(radius, ns, xyz, xmask, q, qmask), 1,
                             warmup=0),
            library_ms=None, bound=bq_bound(xyz, xmask, q, qmask, ns, idx, cnt)))
    log_rows(rows)
    return rows


def phase_pvrcnn(cfg):
    """PV-RCNN at full width (``pvrcnn_cfg``, random weights): one forward
    records the FPS and ball-query calls, each held against its plain
    version and timed; then, with every counter at 0, ``eval_one_epoch``
    (per forward: K1 11, K4 2, K5 1, FPS 1, BQ 8: 6 VSA groups and 2 RoI-grid
    groups), the steady predict rate and a profile with kernel time by
    stage. Returns the kernels' rows, the launches and scans/s."""
    import numpy as np
    import torch

    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.models.backbones_3d.pfe import voxel_set_abstraction as vsa
    from toda_tpu_torch.ops import fused_conv, gather, pointnet2_ops
    from toda_tpu_torch.runtime.eval_utils import eval_one_epoch
    from toda_tpu_torch.weights import randomize_

    np.random.seed(SEED)
    dataset, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=BATCH)
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device="cuda")
    randomize_(bundle.module, SEED)
    first = next(iter(loader))
    log(f"PV-RCNN full width: grid {dataset.grid_size.tolist()}, {first['points'].shape[1]} "
        f"points/scan, {int(first['points_mask'].sum(1).min())}-"
        f"{int(first['points_mask'].sum(1).max())} real, "
        f"{int((first['gt_boxes'][..., -1] > 0).sum())} gt boxes in the first batch")
    with Recorder(vsa, "farthest_point_sampling") as fps, \
            Recorder(pointnet2_ops, "ball_query") as bq:
        out = bundle.forward(bundle.to_device(first))
    torch.cuda.synchronize()
    for k in ("point_features", "point_cls_scores", "rois", "rcnn_cls", "rcnn_reg"):
        assert torch.isfinite(out[k]).all(), f"full-width PV-RCNN output {k} is not finite"
    assert len(fps.calls) == 1 and len(bq.calls) == 8, (len(fps.calls), len(bq.calls))
    log(f"phase PV-RCNN kernels: one forward, {int(out['point_mask'].sum())} keypoints, "
        f"{int(out['roi_mask'].sum())} RoIs kept; 1 FPS and 8 ball-query calls recorded")
    del out
    with torch.no_grad():
        rows = check_point_ops(fps.calls, bq.calls)
    del fps, bq
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    result, annos = eval_one_epoch(bundle, loader, dataset, cfg.CLASS_NAMES)
    wall = time.time() - t0
    ga, pn = gather.LAUNCHES, pointnet2_ops.LAUNCHES
    launches = {"K1": fused_conv.LAUNCHES["fused_bnconv9"], "K4": ga["scatter_rows_add"],
                "K5": ga["unpack_pillars"], "FPS": pn["farthest_point_sampling"],
                "BQ": pn["ball_query"]}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_fwd = len(loader)
    assert n_fwd >= 3, n_fwd
    assert launches == {"K1": 11 * n_fwd, "K4": 2 * n_fwd, "K5": n_fwd, "FPS": n_fwd,
                        "BQ": 8 * n_fwd}, launches
    assert len(annos) == BATCH * n_fwd
    for a in annos:
        assert np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
    n_det = sum(len(a["score"]) for a in annos)
    log(f"phase PV-RCNN main path: eval_one_epoch over {n_fwd} batches of {BATCH} in "
        f"{wall:.1f}s; launches {launches}; {n_det} detections, all finite; mAP "
        f"{result['mAP']:.4f}, recall/0.3 {result['recall/0.3']:.4f}, recall/roi_0.3 "
        f"{result['recall/roi_0.3']:.4f}; eval sec/example {result['sec_per_example']:.4f}; "
        f"peak device memory {peak_gib:.2f} GiB")
    best = steady_rate(predict_run(bundle, loader))
    log(f"phase PV-RCNN predict throughput: {best:.2f} scans/s steady state (batch {BATCH}, "
        f"best of 3 x 10 steps)")
    dev = bundle.to_device(first)
    phase_profile(lambda: float(bundle.predict(dev)["pred_scores"][0, 0]), "PV-RCNN predict")
    return rows, launches, best


SECOND_HEAD_KEYS = ("spatial_features_2d", "cls_preds", "box_preds", "dir_cls_preds")


def rel_err(a, b):
    """max |a - b| over max(1e-12, max |a|), b moved to a's device."""
    return ((a - b.to(a.device)).abs().max() / a.abs().max().clamp(min=1e-12)).item()


def phase_second_tiny():
    """Tiny SECOND in f32 (``second_tiny``, legacy contract): three train
    steps on cuda and on cpu from the same weights and batch, held as
    ``phase_tiny_train_parity`` holds CenterPoint-Res, with the eval
    forward before them to 1e-3 elementwise. On the card, the fused
    contract (K1-K3) on the same weights and batch: eval forward outputs
    within 1e-4 of each tensor's largest magnitude, the first train step's
    loss within 1e-5, and in training mode the 3D backbone's output within
    1e-4 and its parameters' gradients, for one fixed cotangent on that
    output, within 1e-3 of each parameter's largest (f32 both; the two
    contracts sum in other orders). The whole model's gradients are not
    held: the tiny BEV map has 128 cells, and a 1e-5 change of one input
    (the two contracts' outputs differ by that much) can flip a relu where
    the loss gradient is large, which moves the BEV's gradients by percents
    of their largest; their difference is logged. Then one
    ``pillar_conv3d_t`` with Cout 8 (one K7 launch forward, K8's three
    per-group launches backward) against its cpu run, to 1e-4 of each
    result's largest magnitude."""
    import numpy as np
    import torch

    from toda_tpu_torch.config import EDict, cfg_from_yaml_file
    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.ops import fused_conv, gather, pillar_sparse
    from toda_tpu_torch.runtime.train_utils import create_train_state, make_train_step

    cfg = second_tiny(cfg_from_yaml_file(
        str(REPO / "tools/cfgs/synthetic_models/second_synthetic.yaml"), EDict()))
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2,
                                     training=True)
    batch = next(iter(loader))
    runs = {}
    cot = None
    for device, fused in (("cpu", False), ("cuda", False), ("cuda", True)):
        cfg.MODEL.BACKBONE_3D.FUSED_CONV = fused
        bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=device, seed=SEED)
        out = bundle.forward(bundle.to_device(batch))
        heads = {k: out[k].cpu() for k in SECOND_HEAD_KEYS}
        # the 3D backbone alone in training mode, one fixed output cotangent
        probe = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device=device, seed=SEED)
        probe.module.train()
        enc = probe.module.backbone_3d(probe.to_device(batch))["encoded_spconv_tensor"]
        if cot is None:
            cot = torch.randn(enc.shape, generator=torch.Generator().manual_seed(SEED))
        enc.backward(cot.to(enc.device))
        bb3d = (enc.detach().cpu(), {n: p.grad.cpu() for n, p in
                                     probe.module.backbone_3d.named_parameters()})
        del probe, enc
        state, _ = create_train_state(bundle, cfg.OPTIMIZATION, 10)
        init = {k: v.detach().cpu().clone() for k, v in bundle.module.state_dict().items()}
        step = make_train_step(bundle)
        losses, grads = [], None
        reset_launches()
        for _ in range(1 if fused else 3):
            losses.append(float(step(state, batch)[1]["loss"]))
            if grads is None:
                grads = {n: p.grad.cpu().clone() for n, p in bundle.module.named_parameters()}
        runs[device, fused] = dict(heads=heads, losses=losses, grads=grads, init=init, bb3d=bb3d,
                                   final=bundle.module.state_dict(), opt=state,
                                   launches=dict(gather.LAUNCHES, **fused_conv.LAUNCHES))
    c, g, f = runs["cpu", False], runs["cuda", False], runs["cuda", True]
    assert g["launches"]["gather9_stacked_t"] > 0 and g["launches"]["gather_rows_taps_t"] > 0, \
        g["launches"]
    for k in SECOND_HEAD_KEYS:
        assert torch.allclose(c["heads"][k], g["heads"][k], rtol=1e-3, atol=1e-3), k
    for a, b in zip(c["losses"], g["losses"]):
        assert abs(a - b) <= 1e-3 * abs(a), f"tiny SECOND cuda/cpu losses {c['losses']} vs {g['losses']}"
    assert all(torch.equal(c["init"][k], g["init"][k]) for k in c["init"]), "the inits differ"
    lr_sum = sum(c["opt"].lr_fn(i) for i in range(3))
    bad, worst = update_mismatches(g["final"], c["final"], c["init"], c["grads"], lr_sum)
    assert not bad, f"tiny SECOND cuda/cpu updates differ: {bad[:5]}"
    for k in c["final"]:
        if k.endswith(("running_mean", "running_var")):
            assert torch.allclose(g["final"][k].cpu(), c["final"][k], rtol=1e-4, atol=1e-4), k
    fwd_err = max(rel_err(g["heads"][k], f["heads"][k]) for k in SECOND_HEAD_KEYS)
    (genc, ggrad), (fenc, fgrad) = g["bb3d"], f["bb3d"]
    enc_err = rel_err(genc, fenc)
    grad_err, grad_name = max((rel_err(ggrad[n], fgrad[n]), n) for n in ggrad)
    assert fwd_err <= 1e-4 and enc_err <= 1e-4, (fwd_err, enc_err)
    assert grad_err <= 1e-3, (grad_name, grad_err)
    assert abs(f["losses"][0] - g["losses"][0]) <= 1e-5 * abs(g["losses"][0]), \
        (f["losses"], g["losses"])
    assert f["launches"]["fused_bnconv9"] > 0 and f["launches"]["gather9_stacked_t"] == 0
    whole, whole_name = max((rel_err(g["grads"][n], f["grads"][n]), n) for n in g["grads"])
    log(f"phase SECOND tiny cuda-vs-cpu (f32, legacy contract, 3 steps): losses {c['losses']} "
        f"vs {g['losses']}; updates within 1e-3 x sum(LR) where live (max {worst:.3g}); BN "
        f"statistics within 1e-4; fused vs legacy contract on the card: eval outputs "
        f"{fwd_err:.3g} of max (tol 1e-4), 3D backbone output {enc_err:.3g} (tol 1e-4) and "
        f"gradients {grad_err:.3g} of max (tol 1e-3, {grad_name}), step-1 loss "
        f"{f['losses'][0]:.6f} vs {g['losses'][0]:.6f}; whole-model step-1 gradients "
        f"{whole:.3g} of max ({whole_name}; not held, see the docstring)")

    # one conv with Cout 8: K7 forward, the per-group K8 backward
    gen = torch.Generator().manual_seed(SEED)
    p, nz, c_in, cout = 2048, 8, 16, 8
    keys = torch.randperm(128 * 128, generator=gen)[:p - 48].sort().values
    coords = torch.full((1, p, 2), -1, dtype=torch.int32)
    coords[0, :p - 48, 0], coords[0, :p - 48, 1] = keys // 128, keys % 128
    mask = coords[..., 0] >= 0
    idxf = pillar_sparse.bev_neighbor_idx_sorted_batched(coords, mask, coords, mask,
                                                         (128, 128), 1)[0]
    x = torch.randn(nz * c_in, p, generator=gen) * mask[0]
    w = torch.randn(3, 3, 3, c_in, cout, generator=gen) * 0.2
    ct = torch.randn(nz * cout, p, generator=gen)
    res = {}
    for device in ("cpu", "cuda"):
        xd, wd = (v.detach().to(device).requires_grad_() for v in (x, w))
        i = idxf.to(device)
        reset_launches()
        out = pillar_sparse.pillar_conv3d_t(xd, i, wd, mask[0].to(device), nz, 1, 4,
                                            i.flip(1).contiguous())
        out.backward(ct.to(device))
        res[device] = (out.detach().cpu(), xd.grad.cpu(), wd.grad.cpu())
    launches = {k: gather.LAUNCHES[k] for k in ("gather9_stacked_t", "gather_rows_taps_t")}
    assert launches == {"gather9_stacked_t": 1, "gather_rows_taps_t": 3}, launches
    errs = [rel_err(a, b) for a, b in zip(res["cpu"], res["cuda"])]
    assert max(errs) <= 1e-4, errs
    log(f"phase pillar_conv3d_t Cout 8 cuda-vs-cpu (f32): out, dx, dW within "
        f"{max(errs):.3g} of max (tol 1e-4); launches {launches}")


def column_gather_work(table, idx, taps):
    """(bytes, 0 flops) of one K7 or K8 call: the table columns that idx
    names read once, the (taps x W, M) output written once, idx read once."""
    import torch

    cols = int(torch.unique(idx[idx >= 0]).numel())
    eb, w = table.element_size(), table.shape[0]
    return cols * w * eb + taps * w * idx.shape[0] * eb + idx.numel() * 4, 0


def check_column_gathers(k7_calls, k8_calls):
    """Hold each recorded K7 and K8 call against its plain version (exact)
    and time it beside its plain version and the library's index_selects."""
    import torch

    from toda_tpu_torch.ops import gather

    rows = {"K7": [], "K8": []}
    for key, calls, fn, plain in (
            ("K7", k7_calls, gather.gather9_stacked_t, gather.gather9_stacked_t_plain),
            ("K8", k8_calls, gather.gather_rows_taps_t, gather.gather_rows_taps_t_plain)):
        for (table, idx), kw in calls:
            out = fn(table, idx, **kw)
            assert torch.equal(out, plain(table, idx, **kw)), \
                f"{key} {tuple(table.shape)} {kw} differs from its plain version"
            del out
            w, n = table.shape
            padded = torch.cat([table, table.new_zeros((w, 1))], dim=1)
            safe = torch.where(idx >= 0, idx.long(), n).t().contiguous()
            chunk = kw.get("chunk")

            def library(padded=padded, safe=safe, chunk=chunk):
                g = torch.stack([padded.index_select(1, s) for s in safe])
                if chunk is not None:  # K7's [W / chunk][t][chunk] row order
                    g = g.view(9, -1, chunk, g.shape[-1]).transpose(0, 1).contiguous()
                return g

            rows[key].append(dict(
                shape=f"table{tuple(table.shape)} {table.dtype} idx{tuple(idx.shape)} "
                      f"{kw or ''}".strip(),
                err=0.0, tol="0 (exact)", ms=cuda_ms(lambda: fn(table, idx, **kw), 5),
                plain_ms=cuda_ms(lambda: plain(table, idx, **kw), 2),
                library_ms=cuda_ms(library, 5),
                bound=bound_ms(*column_gather_work(table, idx, idx.shape[1]), H100_F32_FLOPS)))
            del padded, safe, library
    return rows


def zconv_choice(call):
    """The stacked conv's z contraction two ways, on the first recorded K7
    call (stage 1's second conv, C = Cout = 16, bf16): ``_zconv_t``'s nine
    batched products over the output z, and one convolution with the taps
    as input channels and a (3C, 1) kernel stepping C rows, which is what
    JAX's ``conv_general_dilated`` computes. Logs both times; asserts only
    that they agree to bf16 rounding."""
    import torch
    import torch.nn.functional as F

    from toda_tpu_torch.ops import gather, pillar_sparse

    (table, idx), kw = call
    c = cout = 16
    g = gather.gather9_stacked_t(table, idx, **kw).view(9, table.shape[0], -1)
    taps_w = (torch.randn((9, 3, c, cout), generator=torch.Generator().manual_seed(SEED))
              * (2.0 / (27 * c)) ** 0.5).to(device=g.device, dtype=g.dtype)
    k = taps_w.permute(3, 0, 1, 2).reshape(cout, 9, 3 * c, 1)

    def tall():
        return F.conv2d(g.view(1, *g.shape), k, stride=(c, 1))[0].transpose(0, 1)

    def products():
        return pillar_sparse._zconv_t(g, taps_w, c, 1)

    a, b = products().float(), tall().float()
    err = ((a - b).abs().max() / b.abs().max()).item()
    assert err <= 2.0 ** -6, err  # nine bf16 roundings against one
    log(f"  z contraction of {tuple(g.shape)} {g.dtype} taps (C = Cout = {c}): nine batched "
        f"products {cuda_ms(products, 5):.3f} ms, one tall-kernel convolution "
        f"{cuda_ms(tall, 5):.3f} ms; max diff {err:.3g} of max")


def phase_second_kernels(state, step, batch, layer_shapes):
    """Record every K7 and K8 call of one full-width train step (forward and
    backward), then hold each kernel against its plain version on them and
    time both; then K10 on the forward's stride-1 K7 calls (``phase_k10``).
    Returns (rows, K10 launches)."""
    import torch

    from toda_tpu_torch.ops import pillar_sparse

    with Recorder(pillar_sparse, "gather9_stacked_t") as k7, \
            Recorder(pillar_sparse, "gather_rows_taps_t") as k8:
        _, tb = step(state, batch)
        loss = float(tb["loss"])
    assert math.isfinite(loss), loss
    assert len(k7.calls) == 18 and len(k8.calls) == 12, (len(k7.calls), len(k8.calls))
    log(f"phase SECOND kernels: one recorded train step, loss {loss:.4f}; {len(k7.calls)} K7 "
        f"and {len(k8.calls)} K8 calls")
    with torch.no_grad():
        rows = check_column_gathers(k7.calls, k8.calls)
        zconv_choice(k7.calls[0])
    log_rows(rows)
    for key in ("K7", "K8"):
        log(f"  {key} per train step: {sum(r['ms'] for r in rows[key]):.3f} ms over "
            f"{len(rows[key])} calls, bound {sum(r['bound'][0] for r in rows[key]):.3f} ms, "
            f"plain {sum(r['plain_ms'] for r in rows[key]):.3f} ms, index_select "
            f"{sum(r['library_ms'] for r in rows[key]):.3f} ms")
    forward = [call for call in k7.calls if "chunk" not in call[1]]
    del k7, k8
    assert len(forward) == 7, len(forward)
    with torch.no_grad():
        k10_rows, k10_launches = phase_k10(forward, layer_shapes)
    rows.update(k10_rows)
    return rows, k10_launches


def second_launches():
    from toda_tpu_torch.ops import fused_conv, gather

    ga = gather.LAUNCHES
    return {"K7": ga["gather9_stacked_t"], "K8": ga["gather_rows_taps_t"],
            "K4": ga["scatter_rows_add"], "K5": ga["unpack_pillars"], "K6": ga["gather_rows"],
            "K9": ga["gather_rows_taps"], "K1-K3": sum(fused_conv.LAUNCHES.values())}


def predict_run(bundle, batches):
    """One ``predict`` per call over the device-resident batches in turn,
    returning a score read back to the host."""
    dev = [bundle.to_device(b) for b in batches]
    turn = itertools.count()
    return lambda: float(bundle.predict(dev[next(turn) % len(dev)])["pred_scores"][0, 0])


def train_run(bundle, state, step, batches):
    """One train step per call over the device-resident batches in turn,
    returning its loss read back to the host."""
    dev = [bundle.to_device(b) for b in batches]
    turn = itertools.count()
    return lambda: float(step(state, dev[next(turn) % len(dev)])[1]["loss"])


def steady_rate(run, iters=10):
    """Scans/s of ``run`` (one batch of BATCH, ending in a host readback):
    best of 3 passes of ``iters`` runs after one warm-up."""
    import torch

    run()
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(3):
        t = time.time()
        for _ in range(iters):
            assert math.isfinite(run())
        best = max(best, iters * BATCH / (time.time() - t))
    return best


def phase_second(cfg):
    """Full-width SECOND on its main path: ``eval_one_epoch`` and predict
    throughput (random weights), then training (flax-like init): the K7 /
    K8 check on one recorded step, counted steps, throughput, peak memory,
    and a profile of each. Returns (rows, launches, predict and train
    scans/s, train peak GiB)."""
    import numpy as np
    import torch

    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.runtime.eval_utils import eval_one_epoch
    from toda_tpu_torch.runtime.train_utils import create_train_state, make_train_step
    from toda_tpu_torch.weights import randomize_

    np.random.seed(SEED)
    dataset, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=BATCH)
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device="cuda")
    randomize_(bundle.module, SEED)
    first = next(iter(loader))
    log(f"SECOND full width: grid {dataset.grid_size.tolist()}, {first['points'].shape[1]} "
        f"points/scan, {int(first['points_mask'].sum(1).min())}-"
        f"{int(first['points_mask'].sum(1).max())} real")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    result, annos = eval_one_epoch(bundle, loader, dataset, cfg.CLASS_NAMES)
    wall = time.time() - t0
    n_fwd = len(loader)
    launches = second_launches()
    assert n_fwd >= 3, n_fwd
    assert launches == {"K7": 7 * n_fwd, "K8": 12 * n_fwd, "K4": 2 * n_fwd, "K5": n_fwd,
                        "K6": 0, "K9": 0, "K1-K3": 0}, launches
    assert len(annos) == BATCH * n_fwd
    for a in annos:
        assert np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
    n_det = sum(len(a["score"]) for a in annos)
    log(f"phase SECOND main path: eval_one_epoch over {n_fwd} batches of {BATCH} in "
        f"{wall:.1f}s; launches {launches}; {n_det} detections, all finite; mAP "
        f"{result['mAP']:.4f}, recall/0.3 {result['recall/0.3']:.4f}; eval sec/example "
        f"{result['sec_per_example']:.4f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    predict = predict_run(bundle, loader)
    predict_rate = steady_rate(predict)
    log(f"phase SECOND predict throughput: {predict_rate:.2f} scans/s steady state (batch "
        f"{BATCH}, best of 3 x 10 steps)")
    phase_profile(predict, "SECOND predict")
    del bundle, predict, loader, dataset
    torch.cuda.empty_cache()

    np.random.seed(SEED)
    tdataset, tloader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=BATCH,
                                            training=True)
    tbatches = list(tloader)
    tbundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), tdataset, device="cuda", seed=SEED)
    state, _ = create_train_state(tbundle, cfg.OPTIMIZATION, SCHEDULE_STEPS)
    step = make_train_step(tbundle)
    log(f"SECOND training: {len(tbatches)} batches of {BATCH} augmented scans, "
        f"{int(sum((b['gt_boxes'][..., -1] > 0).sum() for b in tbatches))} gt boxes")
    # the haloed table height W = (nz + 2) * C of each stage's stride-1 convs
    nz, layer_shapes = int(tdataset.grid_size[2]), {}
    for ch in cfg.MODEL.BACKBONE_3D.CHANNELS:
        layer_shapes[(nz + 2) * ch] = (nz, ch)
        nz = -(-nz // 2)
    rows, k10_launches = phase_second_kernels(state, step, tbatches[0], layer_shapes)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    losses = [float(step(state, tbatches[i % len(tbatches)])[1]["loss"])
              for i in range(SECOND_TRAIN_STEPS)]
    wall = time.time() - t0
    tlaunches = second_launches()
    n = SECOND_TRAIN_STEPS
    assert tlaunches == {"K7": 18 * n, "K8": 12 * n, "K4": 2 * n, "K5": n, "K6": n, "K9": 0,
                         "K1-K3": 0}, tlaunches
    assert all(math.isfinite(v) for v in losses), losses
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase SECOND train main path: {n} make_train_step steps (numpy batches in) in "
        f"{wall:.1f}s; launches {tlaunches}; losses {[round(v, 4) for v in losses]}; peak "
        f"device memory {peak:.2f} GiB")
    train = train_run(tbundle, state, step, tbatches)
    train_rate = steady_rate(train)
    log(f"phase SECOND train throughput: {train_rate:.2f} scans/s steady state (batch {BATCH}, "
        f"best of 3 x 10 steps, loss read back every step)")
    phase_profile(train, "SECOND train step")
    launches = {key: launches[key] + tlaunches[key] for key in launches}
    launches["K10"] = k10_launches
    return rows, launches, predict_rate, train_rate, peak


def toda_launches():
    from toda_tpu_torch.ops import fused_conv, gather

    fc, ga = fused_conv.LAUNCHES, gather.LAUNCHES
    return {"K1": fc["fused_bnconv9"], "dx": fc["fused_bnconv9_bwd_dx"],
            "dx_raw": fc["fused_bnconv9_bwd_dx_raw"], "dW": fc["fused_bnconv9_dw"],
            "dW_raw": fc["fused_bnconv9_dw_raw"], "K4": ga["scatter_rows_add"],
            "K5": ga["unpack_pillars"], "K6": ga["gather_rows"],
            "K7-K10": ga["gather9_stacked_t"] + ga["gather_rows_taps_t"]
            + ga["gather_rows_taps"] + ga["gather9_conv_t"]}


# launches of one step on the TODA path: a train step (stage 1; act=False
# dx and dW at the three down convs, whose inputs are residual joins'
# applied outputs, and dW at the first conv), the perturbation (the
# eval-mode loss's gradient in the points: every conv's dx, so one more
# act=False dx, the raw first conv's; no dW; K6 for the dense scatter's VJP
# and for K4's) and a CL step (two forwards, one backward)
TODA_PER_STEP = {
    "train": {"K1": 11, "dx": 10, "dx_raw": 3, "dW": 11, "dW_raw": 4, "K4": 2, "K5": 1,
              "K6": 1, "K7-K10": 0},
    "perturb": {"K1": 11, "dx": 11, "dx_raw": 4, "dW": 0, "dW_raw": 0, "K4": 2, "K5": 1,
                "K6": 2, "K7-K10": 0},
    "predict": {"K1": 11, "dx": 0, "dx_raw": 0, "dW": 0, "dW_raw": 0, "K4": 2, "K5": 1,
                "K6": 0, "K7-K10": 0},
    "cl": {"K1": 22, "dx": 20, "dx_raw": 6, "dW": 22, "dW_raw": 8, "K4": 4, "K5": 2,
           "K6": 2, "K7-K10": 0},
}


def times(per_step, n, plus=None):
    return {k: v * n + (plus or {}).get(k, 0) for k, v in per_step.items()}


def phase_toda_tiny():
    """Tiny f32 CenterPoint-Res, cuda vs cpu on the same weights and batch:
    the points gradient of the eval-mode loss (the pseudo-label
    perturbation's; every conv's dx kernel, the raw first conv's with
    act=False at C = 8, K4's VJP through K6) within 1e-4 of its largest
    value and of the same sign wherever |g| > 1e-3 of the largest; then one
    ``make_train_step_cl`` step (score threshold 0, so every top-32 box is
    matched) from the same weights on the same dual batch: the five loss
    terms within 1e-4 relative, the updates as ``update_mismatches`` holds
    them, the BatchNorm statistics within 1e-4."""
    import numpy as np
    import torch

    from toda_tpu_torch.datasets import DataLoader, build_dataloader
    from toda_tpu_torch.datasets.dataset_cl import CLPairDataset
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.runtime.pseudo_label import points_gradient
    from toda_tpu_torch.runtime.train_cl import make_train_step_cl
    from toda_tpu_torch.runtime.train_utils import create_train_state
    from toda_tpu_torch.weights import randomize_

    cfg = tiny_cfg()
    np.random.seed(SEED)
    ds, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2)
    batch = next(iter(loader))
    cpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cpu")
    randomize_(cpu.module, SEED)
    gpu = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cuda")
    gpu.module.load_state_dict(cpu.module.state_dict(), strict=True)
    reset_launches()
    g_g = points_gradient(gpu, batch).cpu()
    launches = toda_launches()
    g_c = points_gradient(cpu, batch)
    scale = g_c.abs().max().item()
    err = (g_g - g_c).abs().max().item()
    live = g_c[..., :3].abs() > 1e-3 * scale
    assert scale > 0 and err <= 1e-4 * scale, (err, scale)
    assert int(live.sum()) > 100 and torch.equal(torch.sign(g_g[..., :3])[live],
                                                 torch.sign(g_c[..., :3])[live])
    assert launches == TODA_PER_STEP["perturb"], launches

    np.random.seed(SEED)
    tds, _, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=2, training=True)
    cl = CLPairDataset(tds)
    cl_batch = next(iter(DataLoader(cl, batch_size=2, training=True, prefetch=0)))
    runs = {}
    for device in ("cpu", "cuda"):
        bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), cl, device=device, seed=SEED)
        state, _ = create_train_state(bundle, cfg.OPTIMIZATION, 10)
        init = {k: v.detach().cpu().clone() for k, v in bundle.module.state_dict().items()}
        _, tb = make_train_step_cl(bundle, 0.1, score_thresh=0.0)(state, cl_batch)
        runs[device] = dict(tb={k: float(v) for k, v in tb.items()}, init=init, opt=state,
                            grads={n: p.grad.cpu() for n, p in bundle.module.named_parameters()},
                            final={k: v.cpu() for k, v in bundle.module.state_dict().items()})
    c, g = runs["cpu"], runs["cuda"]
    for k, v in c["tb"].items():
        assert abs(g["tb"][k] - v) <= 1e-4 * abs(v), (k, g["tb"][k], v)
    assert c["tb"]["consistency_center"] > 0
    assert all(torch.equal(c["init"][k], g["init"][k]) for k in c["init"]), "the inits differ"
    bad, worst = update_mismatches(g["final"], c["final"], c["init"], c["grads"],
                                   c["opt"].lr_fn(0))
    assert not bad, f"tiny CL step cuda/cpu updates differ: {bad[:5]}"
    for k in c["final"]:
        if k.endswith(("running_mean", "running_var")):
            assert torch.allclose(g["final"][k], c["final"][k], rtol=1e-4, atol=1e-4), k
    log(f"phase TODA tiny cuda-vs-cpu (f32): eval-loss points gradient within "
        f"{err / scale:.3g} of its max (tol 1e-4), signs equal on {int(live.sum())} live "
        f"elements, launches {launches}; one CL step: losses {g['tb']} vs {c['tb']}; updates "
        f"within 1e-3 x LR where live (max {worst:.3g} x LR); BN statistics within 1e-4")


def phase_toda(data_root):
    """The TODA recipe at full width (``toda_cfgs`` over the fabricated
    Waymo and nuScenes files under ``data_root``) through the entry points
    its three CLIs call: stage 1 (``train_model`` over one epoch of the
    CutMix loader, its checkpoint, ``load_params_only``), pseudo labels
    (``generate_pseudo_labels`` with the perturbation over the pseudo
    config's unlabelled nuScenes split, as the CLI builds its loader, with
    the stage-1 weights), stage 2 (``MixUpDataset`` over those pseudo infos
    in ``CLPairDataset``, ``make_train_step_cl`` steps; a pseudo frame is
    read through its 'frame_info', checked against the unlabelled split's
    own reader).
    Launch counts are asserted per step; the perturbation's raw first-conv
    dx and K4-VJP K6 calls are held against their plain versions
    (``check_train_kernels``). Returns (rows, launches, {metric: value})."""
    import shutil

    import numpy as np
    import torch

    from toda_tpu_torch.datasets import (
        DataLoader,
        build_cutmix_dataloader,
        build_dataloader,
        build_mixup_dataloader,
    )
    from toda_tpu_torch.datasets.dataset_cl import CLPairDataset
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.ops import fused_conv, gather
    from toda_tpu_torch.runtime import checkpoint
    from toda_tpu_torch.runtime.pseudo_label import generate_pseudo_labels, make_perturb_step
    from toda_tpu_torch.runtime.train_cl import make_train_step_cl, select_cl_arrays
    from toda_tpu_torch.runtime.train_utils import (
        create_train_state,
        make_train_step,
        train_model,
    )
    from toda_tpu_torch.tools.generate_pseudo_labels import build_unlabelled_loader

    s1, s2, pl = toda_cfgs(data_root)
    plcfg = pl.PSEUDO_LABEL
    metrics, total = {}, {}
    ckpt_dir = REPO / "build" / "toda_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    # stage 1: inter-domain CutMix training through train_model
    np.random.seed(SEED)
    ds1, loader1, _ = build_cutmix_dataloader(s1.DATA_CONFIG, s1.CLASS_NAMES, batch_size=BATCH,
                                              training=True)
    b1 = build_network(s1.MODEL, len(s1.CLASS_NAMES), ds1, device="cuda", seed=SEED)
    state1, _ = create_train_state(b1, s1.OPTIMIZATION, len(loader1))
    seen = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    state1 = train_model(b1, state1, loader1, 0, 1, ckpt_dir,
                         hooks=[lambda st, batch, tb, it: seen.append((batch, float(tb["loss"])))])
    wall = time.time() - t0
    launches = toda_launches()
    n1 = len(seen)
    assert n1 == len(loader1) == len(ds1) // BATCH >= 2, (n1, len(loader1))
    assert launches == times(TODA_PER_STEP["train"], n1), launches
    assert all(math.isfinite(v) for _, v in seen) and ds1.train_percent == 1.0
    total = times(TODA_PER_STEP["train"], n1)
    ckpt = checkpoint.latest_checkpoint(ckpt_dir)
    assert ckpt is not None and ckpt.name == "checkpoint_epoch_1.pth", ckpt
    log(f"phase TODA stage 1: train_model over one CutMix epoch of {len(ds1)} frames "
        f"({n1} steps of {BATCH}, numpy batches from the prefetching loader) in {wall:.1f}s; "
        f"launches {launches}; losses {[round(v, 4) for _, v in seen]}; "
        f"{int(sum((b['gt_boxes'][..., -1] > 0).sum() for b, _ in seen))} gt boxes; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; wrote {ckpt.name}")

    # the checkpoint round trip: params-only transfer and a full resume
    probe = build_network(s1.MODEL, len(s1.CLASS_NAMES), ds1, device="cuda", seed=SEED + 1)
    checkpoint.load_params_only(ckpt, probe)
    sd = b1.module.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in probe.module.state_dict().items())
    pstate, _ = create_train_state(probe, s1.OPTIMIZATION, len(loader1))
    assert checkpoint.load_checkpoint(ckpt, probe, pstate) == 1 and pstate.count == n1
    assert all(torch.equal(a, b) for a, b in zip(pstate.mu + pstate.nu, state1.mu + state1.nu))
    del probe, pstate
    step1 = make_train_step(b1)
    run1 = train_run(b1, state1, step1, [b for b, _ in seen])
    metrics["stage1_train_scans_per_s"] = steady_rate(run1)
    log(f"phase TODA checkpoint: load_params_only and load_checkpoint of {ckpt.name} give "
        f"the same weights, BN statistics and Adam state; stage-1 train throughput "
        f"{metrics['stage1_train_scans_per_s']:.2f} scans/s steady state (batch {BATCH}, "
        f"best of 3 x 10 steps, loss read back every step)")
    phase_profile(run1, "TODA stage-1 train step")
    # the fused convs on the real-format traffic: one stage-1 forward's K1,
    # K4, K5 and one train step's dx, dW, K6 calls, each held against its
    # plain version and timed (logged beside the synthetic scenes' rows,
    # not summed into the kernels line)
    log("phase TODA kernels on the stage-1 CutMix batches (Waymo and nuScenes scans):")
    real = phase_kernels(b1, seen[0][0])
    real.update(phase_train_kernels(state1, step1, seen[0][0]))
    metrics["real_kernel_ms"] = {
        k: (round(sum(r["ms"] for r in rs), 4), round(sum(r["plain_ms"] or 0 for r in rs), 4))
        for k, rs in real.items()}
    metrics["real_pair_share"] = {
        k: float(np.mean([r["share"] for r in rs])) for k, rs in real.items()
        if rs and "share" in rs[0]}
    log(f"  summed over the recorded calls (ms, plain ms): {metrics['real_kernel_ms']}; mean "
        f"present-pair share {metrics['real_pair_share']}")
    del b1, state1, step1, run1, seen, real
    torch.cuda.empty_cache()

    # pseudo labels with the perturbation over the unlabelled split, stage-1 weights
    tds, tloader = build_unlabelled_loader(pl, BATCH)
    pb = build_network(pl.MODEL, len(pl.CLASS_NAMES), tds, device="cuda", seed=SEED + 1)
    checkpoint.load_params_only(ckpt, pb)
    n_pl = len(tloader)
    with Recorder(fused_conv, "fused_bnconv9_bwd_dx") as kdx, \
            Recorder(gather, "gather_rows") as k6:
        reset_launches()
        t0 = time.time()
        infos = generate_pseudo_labels(pb, tloader, tds, pl.CLASS_NAMES,
                                       score_thresh=float(plcfg.SCORE_THRESH),
                                       with_perturb=bool(plcfg.WITH_PERTURB),
                                       eps=float(plcfg.EPS))
        wall = time.time() - t0
        launches = toda_launches()
    per_sweep = {k: TODA_PER_STEP["predict"][k] + v for k, v in TODA_PER_STEP["perturb"].items()}
    assert launches == times(per_sweep, n_pl), launches
    total = times(per_sweep, n_pl, total)
    # the first conv's dx (act=False on the voxelizer's means, 8 channels)
    # and K4's VJP (a K6 gather of the (cell, features + count) f32 sums'
    # cotangent); the other K6 call of each step is the dense scatter's VJP
    c = tds.point_feature_encoder.num_point_features
    raw_dx = [k for k in kdx.calls if not k[0][7] and k[0][0].shape[-1] == -(-c // 8) * 8]
    k4_vjp = [k for k in k6.calls if k[0][0].shape[1] == c + 1]
    assert len(raw_dx) == n_pl and len(k4_vjp) == n_pl and len(k6.calls) == 2 * n_pl, \
        (len(raw_dx), len(k4_vjp), len(k6.calls))
    n_boxes = sum(len(i["gt_boxes"]) for i in infos)
    assert len(infos) == BATCH * n_pl and all(
        i["point_perturb"].shape == (tds.max_points, 3)
        and set(np.unique(i["point_perturb"])) <= {-1.0, 0.0, 1.0} for i in infos)
    assert any(np.abs(i["point_perturb"]).sum() > 0 for i in infos)
    unlabelled = [i["token"] for i in tds.infos]
    assert [i["index"] for i in infos] == [i["frame_info"]["token"] for i in infos] \
        == [unlabelled[k % len(unlabelled)] for k in range(len(infos))]
    log(f"phase TODA pseudo labels: generate_pseudo_labels over {len(infos)} unlabelled "
        f"nuScenes frames ({len(tds)} in the split, the last batch padded) "
        f"(score {plcfg.SCORE_THRESH}, eps {plcfg.EPS}, the perturbation) in {wall:.1f}s; "
        f"launches {launches} ({n_pl} predict + {n_pl} perturb steps: per perturb step "
        f"{TODA_PER_STEP['perturb']}); {n_boxes} pseudo boxes kept, "
        f"{sum(len(i['p_voxel_coords']) for i in infos)} perturbed voxels stored")
    # the same sweep at score 0, post-processing's threshold at 0 too: the
    # box-bearing pseudo frames of the F1 pass (the few-step stage-1 weights
    # score hardly a box above POST_PROCESSING.SCORE_THRESH 0.1)
    post = pb.post_cfg
    pb.post_cfg = {**post, "SCORE_THRESH": 0.0}
    infos0 = generate_pseudo_labels(pb, tloader, tds, pl.CLASS_NAMES, score_thresh=0.0,
                                    with_perturb=True, eps=float(plcfg.EPS))
    pb.post_cfg = post
    n_boxes0 = sum(len(i["gt_boxes"]) for i in infos0)
    assert n_boxes0 > 0, "no pseudo box even at score 0"
    log(f"  at score 0 (and POST_PROCESSING.SCORE_THRESH 0) the same sweep keeps "
        f"{n_boxes0} boxes")
    with torch.no_grad():
        rows = check_train_kernels(raw_dx, (), k4_vjp)
    del kdx, k6, raw_dx, k4_vjp
    log_rows(rows)
    first = next(iter(tloader))
    # targets of the head's 7 box columns (no velocity) and the class, as
    # generate_pseudo_labels gives the perturbation (the loader's nuScenes
    # boxes carry velocity)
    gt = first["gt_boxes"]
    dev = pb.to_device({"points": first["points"], "points_mask": first["points_mask"],
                        "gt_boxes": np.concatenate([gt[..., :7], gt[..., -1:]], -1)})
    perturb = make_perturb_step(pb)
    metrics["perturb_scans_per_s"] = steady_rate(lambda: float(perturb(dev)[0, 0, 0]))
    log(f"phase TODA perturb throughput: {metrics['perturb_scans_per_s']:.2f} scans/s steady "
        f"state (batch {BATCH}, best of 3 x 10 steps, the sign read back every step)")
    phase_profile(lambda: float(perturb(dev)[0, 0, 0]), "TODA perturb step")
    del pb, dev, perturb
    torch.cuda.empty_cache()

    # stage 2: MixUp over the pseudo infos, two views, the consistency loss
    np.random.seed(SEED)
    mds, _, _ = build_mixup_dataloader(s2.DATA_CONFIG, s2.CLASS_NAMES, batch_size=BATCH,
                                       pseudo_infos=infos, training=True)
    # a pseudo frame through the labelled split's dataset: the unlabelled
    # split's own points (the shift, the sweeps)
    probe = infos[-1]
    got = mds.base.get_raw_scene(probe["frame_info"])[0]
    want = tds.get_raw_scene(unlabelled.index(probe["index"]))[0]
    assert probe["index"] not in {i["token"] for i in mds.base.infos}
    assert got.shape == want.shape and np.array_equal(got, want), (got.shape, want.shape)
    cl = CLPairDataset(mds)
    cbatches = [b for _, b in zip(range(TODA_CL_STEPS), DataLoader(cl, BATCH, training=True))]
    b2 = build_network(s2.MODEL, len(s2.CLASS_NAMES), cl, device="cuda", seed=SEED + 2)
    checkpoint.load_params_only(ckpt, b2)
    state2, _ = create_train_state(b2, s2.OPTIMIZATION, SCHEDULE_STEPS)
    cl_cfg = s2.MODEL.CL_CFG
    step2 = make_train_step_cl(b2, consistency_weight=float(cl_cfg.WEIGHT),
                               score_thresh=float(cl_cfg.SCORE_THRESH))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    tbs = [{k: round(float(v), 4) for k, v in step2(state2, b)[1].items()} for b in cbatches]
    wall = time.time() - t0
    launches = toda_launches()
    n2 = len(cbatches)
    assert n2 == TODA_CL_STEPS and launches == times(TODA_PER_STEP["cl"], n2), launches
    total = times(TODA_PER_STEP["cl"], n2, total)
    assert all(math.isfinite(v) for tb in tbs for v in tb.values()), tbs
    metrics["cl_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase TODA stage 2: {n2} make_train_step_cl steps (MixUpDataset over {len(infos)} "
        f"pseudo frames, read through their frame_info ({len(got)} points in the probe, "
        f"equal to the unlabelled split's), + {len(mds.labeled_indices)} labelled, adv and org "
        f"views of {BATCH} scans, numpy batches in) in {wall:.1f}s; launches {launches}; "
        f"{tbs}; peak device memory "
        f"{metrics['cl_peak_gib']:.2f} GiB")
    dev2 = [{view: b2.to_device(v) for view, v in select_cl_arrays(b).items()} for b in cbatches]
    turn = itertools.count()

    def cl_run():
        return float(step2(state2, dev2[next(turn) % len(dev2)])[1]["loss"])

    metrics["cl_train_scans_per_s"] = steady_rate(cl_run)
    log(f"phase TODA CL throughput: {metrics['cl_train_scans_per_s']:.2f} scans/s steady state "
        f"(batch {BATCH} scans, two views each, best of 3 x 10 steps, loss read back every "
        f"step)")
    phase_profile(cl_run, "TODA CL step")
    del step2, dev2, cbatches

    # stage 2 on box-bearing pseudo frames: MixUp over the score-0 pseudo
    # labels, the consistency matched at score 0 (the few-step stage-1
    # weights score no box above 0.2, so at the config's 0.3 nothing would
    # match)
    np.random.seed(SEED + 1)
    mds0, _, _ = build_mixup_dataloader(s2.DATA_CONFIG, s2.CLASS_NAMES, batch_size=BATCH,
                                        pseudo_infos=infos0, training=True)
    fbatches = [b for _, b in zip(range(2), DataLoader(CLPairDataset(mds0), BATCH,
                                                        training=True))]
    step0 = make_train_step_cl(b2, consistency_weight=float(cl_cfg.WEIGHT), score_thresh=0.0)
    reset_launches()
    tbs0 = [{k: float(v) for k, v in step0(state2, b)[1].items()} for b in fbatches]
    launches = toda_launches()
    assert launches == times(TODA_PER_STEP["cl"], len(fbatches)), launches
    assert all(math.isfinite(v) for tb in tbs0 for v in tb.values()), tbs0
    assert all(tb["consistency_center"] > 0 and tb["consistency_size"] > 0 for tb in tbs0), \
        f"the consistency terms vanish on box-bearing pseudo frames: {tbs0}"
    n_gt = [int((b[v]["gt_boxes"][..., -1] > 0).sum()) for b in fbatches for v in ("adv", "org")]
    log(f"phase TODA stage 2 on pseudo boxes (F1): {len(fbatches)} make_train_step_cl steps "
        f"over MixUpDataset of the {n_boxes0} score-0 pseudo boxes, consistency matched at "
        f"score 0; boxes per view batch {n_gt}; launches {launches}; "
        f"{[{k: round(v, 4) for k, v in tb.items()} for tb in tbs0]}; both consistency "
        f"terms nonzero")
    del b2, state2, step0, fbatches, mds0
    torch.cuda.empty_cache()
    return rows, total, metrics


SECOND_IOU_CFG = "tools/cfgs/stage1_targetmix/second_iou_nus_kitti_targetmix.yaml"
# launches of one SECOND-IoU step (PillarBackBone8x on the fused contract):
# a train step takes every conv's dW and every conv's dx but the first's,
# act=False only at the first conv (its input is the voxelizer's means)
SECOND_IOU_PER_STEP = {
    "train": {"K1": 11, "dx": 10, "dx_raw": 0, "dW": 11, "dW_raw": 1, "K4": 2, "K5": 1,
              "K6": 1, "K7-K10": 0},
    "predict": {"K1": 11, "dx": 0, "dx_raw": 0, "dW": 0, "dW_raw": 0, "K4": 2, "K5": 1,
                "K6": 0, "K7-K10": 0},
}
# the car AP_R40 keys of the KITTI metric the track's evals must give
KITTI_AP_KEYS = tuple(f"car_{m}_{d}_R40" for m in ("3d", "bev", "bbox")
                      for d in ("easy", "moderate", "hard"))


def second_iou_cfg(data_root=None):
    """TODA's nuScenes -> KITTI stage 1 at full width:
    tools/cfgs/stage1_targetmix/second_iou_nus_kitti_targetmix.yaml with only
    the domains' DATA_PATHs moved to the fabricated files under
    ``data_root`` (None keeps them). SECONDNetIoU: PillarBackBone8x [16, 32,
    64, 64], MAX_PILLARS 32768, BF16, the fused convs; HeightCompression
    320; BEV [5, 5] x [128, 256] / [256, 256]; AnchorHeadSingle (car, 2
    rotations, the direction classifier); SECONDHead (128 RoIs, 7 x 7 grid,
    SHARED_FC [256, 256]); num_pts_iou_cls rescoring at IOU_WEIGHT 0.68,
    NMS 1024 -> 128; range [-40, 40]^2 x [-3, 1], voxel (0.05, 0.05, 0.1) ->
    1600 x 1600 x 40, 65536 points a scan; CutMixDataset polarmix (ASC,
    CUTMIX_PROB 0.5) of nuScenes (10 sweeps, CBGS, gt_sampling car:2) and
    KITTI (gt_sampling Car:15, CLASS_MAPPING Car -> car); adam_onecycle at
    LR 0.003, batch 4; DATA_CONFIG_TEST KITTI val, EVAL_METRIC kitti."""
    from toda_tpu_torch.config import EDict, cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / SECOND_IOU_CFG), EDict())
    if data_root is not None:
        nus, kitti = str(Path(data_root) / "nuscenes"), str(Path(data_root) / "kitti")
        cfg.DATA_CONFIG.SOURCE_CFG.DATA_PATH = nus
        cfg.DATA_CONFIG.TARGET_CFG.DATA_PATH = kitti
        cfg.DATA_CONFIG_TEST.DATA_PATH = kitti
    return cfg


def check_kitti_metric(result, what):
    """The car AP_R40 of 3D, BEV and bbox at the three difficulties are
    in the result and finite."""
    missing = [k for k in KITTI_AP_KEYS if k not in result]
    assert not missing, f"{what}: KITTI metric lacks {missing}"
    assert all(math.isfinite(float(result[k])) for k in KITTI_AP_KEYS), result
    return {k: round(float(result[k]), 4) for k in KITTI_AP_KEYS}


def phase_kitti(data_root):
    """TODA's nuScenes -> KITTI stage 1 on the card (``second_iou_cfg``): a
    KITTI tree fabricated under ``data_root`` beside ``phase_data``'s
    nuScenes files (``fabricate_kitti``: 16 train, 8 val HDL-64E frames),
    its infos and gt database from ``create_infos kitti``. The host loader
    prepares 4 batches of polarmix CutMix samples on one thread (scans/s,
    points, occupied pillars against MAX_PILLARS; the KITTI target's
    gt_sampling must paste nothing: Car:15 keys no pool under
    CLASS_NAMES ['car']). On those batches: every K1, K4, K5 call of one
    forward and every dx, dW, K6 call of one train step held against its
    plain version (the present-pair share of each K1 call logged), the
    steady train and predict rates on device-resident batches, peak memory
    and profiles. Then the stage-1 CLI's ``main`` for one epoch at batch 4
    (with its KITTI val eval) and ``test``'s ``main`` on its checkpoint,
    launches asserted per stage, the car AP_R40 of 3D, BEV and bbox finite
    at the three difficulties. Returns (rows, launches, {metric: value})."""
    import shutil

    import numpy as np
    import torch
    import yaml

    from toda_tpu_torch.config import cfg as global_cfg
    from toda_tpu_torch.datasets import build_dataset
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.runtime.train_utils import create_train_state, make_train_step
    from toda_tpu_torch.tools import create_infos, stage1_cutmix_train, test

    root = Path(data_root)
    t = time.time()
    fk = fabricate_kitti(root / "kitti")
    fab_s = time.time() - t
    t = time.time()
    create_infos.main(["kitti", "--data_path", str(root / "kitti"), "--with_gt_db",
                       "--classes", "Car,Pedestrian,Cyclist"])
    log(f"phase KITTI data: {fk['frames']} HDL-64E frames, {fk['points'] / fk['frames']:.0f} "
        f"points a scan, {fk['labels']} labelled objects; fabricated in {fab_s:.1f}s, "
        f"create_infos kitti --with_gt_db in {time.time() - t:.1f}s")

    cfg = second_iou_cfg(root)
    metrics = {}
    np.random.seed(SEED)
    ds = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=True)
    sampler = ds.target.data_augmentor.data_augmentor_queue[0]
    calls = []

    def counted(data_dict):
        n = len(data_dict["gt_boxes"])
        out = sampler(data_dict)
        calls.append(len(out["gt_boxes"]) - n)
        return out

    ds.target.data_augmentor.data_augmentor_queue[0] = counted
    n = 4 * BATCH
    t = time.time()
    samples = [ds[i] for i in np.random.permutation(len(ds))[:n]]
    metrics["loader_scans_per_s"] = n / (time.time() - t)
    pillars = [occupied_pillars(smp, ds) for smp in samples]
    cap = int(cfg.MODEL.BACKBONE_3D.MAX_PILLARS)
    metrics["pillars"] = (min(pillars), float(np.mean(pillars)), max(pillars))
    kitti_raw = [len(ds.target.get_raw_scene(i)[0]) for i in range(len(ds.target))]
    log(f"  CutMix polarmix (nuScenes {len(ds.source)} -> KITTI {len(ds.target)} frames): "
        f"{metrics['loader_scans_per_s']:.2f} scans/s on one host thread ({n} scans); KITTI "
        f"scans {min(kitti_raw)}-{max(kitti_raw)} points, {ds.max_points} kept; occupied "
        f"pillars {min(pillars)}-{max(pillars)} (mean {np.mean(pillars):.0f}) against "
        f"MAX_PILLARS {cap}: the cap drops {sum(max(0, v - cap) for v in pillars) / n:.0f} a "
        f"scan, on {sum(v > cap for v in pillars)} of {n} scans; the KITTI target's "
        f"gt_sampling pasted {sum(calls)} objects over {len(calls)} calls (groups "
        f"{sampler.sample_groups})")
    # the class-key question of the reference: SAMPLE_GROUPS Car:15 keys a
    # pool CLASS_NAMES ['car'] never fills
    assert calls and sum(calls) == 0 and not sampler.sample_groups, \
        (calls, sampler.sample_groups)
    batches = [ds.collate_batch(samples[i * BATCH:(i + 1) * BATCH]) for i in range(4)]
    val = build_dataset(cfg.DATA_CONFIG_TEST, cfg.CLASS_NAMES)
    vbatches = [val.collate_batch([val[(i * BATCH + j) % len(val)] for j in range(BATCH)])
                for i in range(-(-len(val) // BATCH))]

    # the kernels on the track's traffic, then its steady rates
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds, device="cuda", seed=SEED)
    state, _ = create_train_state(bundle, cfg.OPTIMIZATION, SCHEDULE_STEPS)
    step = make_train_step(bundle)
    log("phase KITTI kernels on the SECOND-IoU CutMix batches:")
    rows = phase_kernels(bundle, batches[0])
    rows.update(phase_train_kernels(state, step, batches[0]))
    metrics["k1_share"] = [round(r["share"], 3) for r in rows["K1"]]
    metrics["kernel_ms"] = {k: round(sum(r["ms"] for r in rs), 4) for k, rs in rows.items()}
    log(f"  present-pair share of each K1 call (the 11 convs in order: stage 1 at 1600 x "
        f"1600, then the down conv and two convs of stages 2-4): {metrics['k1_share']}; "
        f"summed ms {metrics['kernel_ms']}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = train_run(bundle, state, step, batches)
    metrics["train_scans_per_s"] = steady_rate(run)
    metrics["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    phase_profile(run, "SECOND-IoU train step")
    predict = predict_run(bundle, vbatches)
    metrics["predict_scans_per_s"] = steady_rate(predict)
    phase_profile(predict, "SECOND-IoU predict")
    log(f"phase KITTI throughput: train {metrics['train_scans_per_s']:.2f} scans/s, predict "
        f"{metrics['predict_scans_per_s']:.2f} scans/s steady state (batch {BATCH}, best of 3 x "
        f"10 steps, read back every step); train peak memory "
        f"{metrics['train_peak_gib']:.2f} GiB")
    del bundle, state, step, run, predict, batches, samples
    torch.cuda.empty_cache()

    # the track through its CLIs: stage 1 (with its KITTI val eval), then
    # test, both evaluating at score 0: eight steps from the init score few
    # boxes above POST_PROCESSING.SCORE_THRESH 0.1 (in one run none in the
    # camera's view of the 8 val frames), and the metric computes its bbox
    # AP and AOS only from detections there
    cfg.MODEL.POST_PROCESSING.SCORE_THRESH = 0.0
    cli = REPO / "build" / "cli_kitti"
    shutil.rmtree(cli, ignore_errors=True)
    (cli / "cfgs" / "kitti").mkdir(parents=True)
    cfg_file = cli / "cfgs" / "kitti" / "second_iou_stage1.yaml"
    cfg_file.write_text(yaml.safe_dump({k: v for k, v in plain_cfg(cfg).items() if k not in (
        "TAG", "EXP_GROUP_PATH", "ROOT_DIR", "LOCAL_RANK")}))
    global_cfg.ROOT_DIR = cli
    steps = len(ds) // BATCH
    evals = len(vbatches)
    total, results = {}, {}
    for name, fn, argv, want in (
            ("stage1_cutmix_train", stage1_cutmix_train.main,
             ["--epochs", "1"], times(SECOND_IOU_PER_STEP["train"], steps,
                                      times(SECOND_IOU_PER_STEP["predict"], evals))),
            ("test", test.main,
             ["--ckpt", str(cli / "output" / "kitti" / "second_iou_stage1" / "kitti" / "ckpt"
                            / "checkpoint_epoch_1.pth")],
             times(SECOND_IOU_PER_STEP["predict"], evals))):
        np.random.seed(SEED)
        reset_launches()
        t0 = time.time()
        results[name] = fn(["--cfg_file", str(cfg_file), "--extra_tag", "kitti", "--batch_size",
                            str(BATCH), *argv])
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = toda_launches()
        assert got == want, f"CLI {name}: launches {got}, want {want}"
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        metrics[f"{name}_s"] = wall
        log(f"phase KITTI CLI {name}: {wall:.1f}s wall, launches {got}; car AP_R40 "
            f"{check_kitti_metric(results[name], name)}")
    assert steps >= 4, steps
    return rows, total, metrics


# the keys and per-frame shapes of a pseudo info as JAX's
# generate_pseudo_labels writes it with the perturbation
# (toda_tpu/runtime/pseudo_label.py); K boxes, N padded points, V voxels.
# The port's record adds 'frame_info' for a frame of a real dataset.
PSEUDO_INFO_SHAPES = {"gt_boxes": ("K", 7), "gt_names": ("K",), "score": ("K",),
                      "point_perturb": ("N", 3), "p_voxel_coords": ("V", 3),
                      "p_voxel_perturb": ("V", 3), "p_voxel_size": (3,), "p_pc_range": (6,)}


def plain_cfg(c):
    """A config as plain dicts and lists (for yaml.safe_dump)."""
    if isinstance(c, dict):
        return {k: plain_cfg(v) for k, v in c.items()}
    if isinstance(c, (list, tuple)):
        return [plain_cfg(v) for v in c]
    return c


def phase_cli(data_root, sizes):
    """The TODA recipe through the port's CLIs on the card, world size 1:
    ``stage1_cutmix_train.main`` (one epoch, then its target-domain eval on
    nuScenes val), then ``generate_pseudo_labels.main --perturb`` with its
    checkpoint over the pseudo config's unlabelled split, then
    ``stage2_mixup_train_cl.main`` (one epoch of CL steps, then its
    target-domain eval), then ``test.main`` on the stage-2 checkpoint. The
    configs are ``toda_cfgs(data_root)`` at full width, written as YAML
    files, with ``cfg.ROOT_DIR`` at build/cli; ``sizes`` are the splits'
    frame counts (``phase_data``), which set each stage's steps. Each
    stage's launches are asserted, its checkpoint and the pseudo-info
    pickle's structure checked, and the evals return the nuScenes metric's
    keys, finite. Returns the launches summed."""
    import pickle
    import shutil

    import numpy as np
    import torch
    import yaml

    from toda_tpu_torch.config import cfg as global_cfg
    from toda_tpu_torch.tools import (
        generate_pseudo_labels,
        stage1_cutmix_train,
        stage2_mixup_train_cl,
        test,
    )

    s1, s2, pl = toda_cfgs(data_root)
    plcfg = pl.PSEUDO_LABEL
    root = REPO / "build" / "cli"
    shutil.rmtree(root, ignore_errors=True)
    cfg_dir = root / "cfgs" / "toda"
    cfg_dir.mkdir(parents=True)
    files = {}
    for name, c in (("stage1", s1), ("pseudo", pl), ("stage2", s2)):
        c = {k: v for k, v in plain_cfg(c).items()
             if k not in ("TAG", "EXP_GROUP_PATH", "ROOT_DIR", "LOCAL_RANK")}
        files[name] = cfg_dir / f"{name}.yaml"
        files[name].write_text(yaml.safe_dump(c))
    global_cfg.ROOT_DIR = root
    run = root / "output" / "toda"
    b = ["--batch_size", str(BATCH)]
    walls, total = {}, {}

    def stage(name, fn, argv, want):
        np.random.seed(SEED)
        reset_launches()
        t0 = time.time()
        out = fn(argv)
        torch.cuda.synchronize()
        walls[name] = time.time() - t0
        got = toda_launches()
        assert got == want, f"CLI {name}: launches {got}, want {want}"
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        log(f"phase CLI {name}: {walls[name]:.1f}s wall, launches {got}")
        return out

    evals = -(-sizes["val"] // BATCH)
    stage("stage1_cutmix_train", stage1_cutmix_train.main,
          ["--cfg_file", str(files["stage1"]), "--extra_tag", "cli", "--epochs", "1", *b],
          times(TODA_PER_STEP["train"], (sizes["source"] + sizes["target"]) // BATCH,
                times(TODA_PER_STEP["predict"], evals)))
    ck1 = run / "stage1" / "cli" / "ckpt" / "checkpoint_epoch_1.pth"
    assert sorted(p.name for p in ck1.parent.iterdir()) == [ck1.name]
    per_sweep = {k: TODA_PER_STEP["predict"][k] + v for k, v in TODA_PER_STEP["perturb"].items()}
    n_pl = -(-sizes["unlabelled"] // BATCH)
    out = stage("generate_pseudo_labels --perturb", generate_pseudo_labels.main,
                ["--cfg_file", str(files["pseudo"]), "--ckpt", str(ck1), "--perturb",
                 "--score_thresh", str(plcfg.SCORE_THRESH), "--eps", str(plcfg.EPS),
                 "--output", str(root / "pseudo_infos.pkl"), *b],
                times(per_sweep, n_pl))
    with open(out, "rb") as f:
        infos = pickle.load(f)
    assert len(infos) == n_pl * BATCH, len(infos)
    with open(Path(pl.DATA_CONFIG.DATA_PATH) / pl.DATA_CONFIG.INFO_PATH["train"][0], "rb") as f:
        unlabelled = [i["token"] for i in pickle.load(f)]
    for i, info in enumerate(infos):
        assert set(info) == set(PSEUDO_INFO_SHAPES) | {"index", "frame_info"}, set(info)
        k, v = len(info["gt_boxes"]), len(info["p_voxel_coords"])
        for key, shape in PSEUDO_INFO_SHAPES.items():
            want = tuple({"K": k, "V": v, "N": info["point_perturb"].shape[0]}.get(d, d)
                         for d in shape)
            assert np.asarray(info[key]).shape == want, (key, np.asarray(info[key]).shape)
        assert info["p_voxel_coords"].dtype == np.int32
        assert info["index"] == info["frame_info"]["token"] == unlabelled[i % len(unlabelled)]
        assert set(np.unique(info["point_perturb"])) <= {-1.0, 0.0, 1.0}
    res2 = stage("stage2_mixup_train_cl", stage2_mixup_train_cl.main,
                 ["--cfg_file", str(files["stage2"]), "--pseudo_info_path", str(out),
                  "--pretrained_model", str(ck1), "--extra_tag", "cli", "--epochs", "1", *b],
                 times(TODA_PER_STEP["cl"], (sizes["stage2_labelled"] + len(infos)) // BATCH,
                       times(TODA_PER_STEP["predict"], evals)))
    ck2 = run / "stage2" / "cli" / "ckpt" / "checkpoint_epoch_1.pth"
    assert ck2.exists()
    res = stage("test", test.main, ["--cfg_file", str(files["stage2"]), "--ckpt", str(ck2),
                                    "--extra_tag", "cli", *b],
                times(TODA_PER_STEP["predict"], evals))
    keys = {"mAP", "NDS", "sec_per_example", "compile_sec"} \
        | {f"m{k.upper()}" for k in ("trans_err", "scale_err", "orient_err", "vel_err",
                                     "attr_err")} \
        | {f"AP_{c}" for c in s2.CLASS_NAMES} \
        | {f"AP_{c}@{d}" for c in s2.CLASS_NAMES for d in (0.5, 1.0, 2.0, 4.0)} \
        | {f"recall/{t}" for t in s2.MODEL.POST_PROCESSING.RECALL_THRESH_LIST}
    assert set(res) == set(res2) == keys, (set(res) ^ keys)
    assert all(math.isfinite(float(v)) for v in res.values()), res
    log(f"phase CLI: the TODA recipe through the CLIs in {sum(walls.values()):.1f}s "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in walls.items())}); {len(infos)} pseudo infos "
        f"of the unlabelled split with JAX's keys and shapes and their frame_info, "
        f"{sum(len(i['gt_boxes']) for i in infos)} boxes; test result on nuScenes val "
        f"{{{', '.join(f'{k}: {float(v):.4g}' for k, v in sorted(res.items()))}}}; "
        f"launches summed {total}")
    return total


def k10_work(table, idx, nz, cout, identity):
    """(bytes, flops) of one K10 call: the table columns it names (and its
    own, for the identity tap) read once, the (nz*Cout, M) output written
    once, idx and the (3, 3, 3, C, Cout) weights read once; 2*3C*Cout flops
    per output z of each (column, tap) that reads a column."""
    import torch

    w = table.shape[0]
    c = w // (nz + 2)
    m = idx.shape[0]
    taps = idx.clone()
    if identity is not None and m == table.shape[1]:
        taps[:, identity] = torch.arange(m, device=idx.device, dtype=idx.dtype)
    cols = int(torch.unique(taps[taps >= 0]).numel())
    eb = table.element_size()
    pairs = int(torch.count_nonzero(taps >= 0).item())
    nbytes = cols * w * eb + nz * cout * m * eb + idx.numel() * 4 + 27 * c * cout * eb
    return nbytes, 2 * 3 * c * cout * nz * pairs


def check_k10_call(table, idx, w, nz, it, what):
    """K10 on one call, held against its plain version (2^-7 relative +
    2^-12 of the sum of the terms' magnitudes: f32 sums in another order,
    one rounding each) and against K7 followed by ``pillar_conv3d_t``'s z
    product, the path it would replace (which rounds each tap's partial sum
    to the table's type: 2^-7 relative + 9 x 2^-8 of the sum of
    magnitudes); all three timed. Returns its row, whose ``launches`` is
    the launch count of the one checked call (the timing launches aside)."""
    import torch

    from toda_tpu_torch.ops import gather, pillar_sparse

    c, cout = w.shape[3:]
    before = gather.LAUNCHES["gather9_conv_t"]
    out = gather.gather9_conv_t(table, idx, w, nz, identity_tap=it)
    launches = gather.LAUNCHES["gather9_conv_t"] - before
    ref = gather.gather9_conv_t_plain(table, idx, w, nz, identity_tap=it)
    mag = gather.gather9_conv_t_plain(table.float().abs(), idx, w.float().abs(), nz,
                                      identity_tap=it)
    taps_w = w.permute(1, 2, 0, 3, 4).reshape(9, 3, c, cout)

    def k7_path():
        g = gather.gather9_stacked_t(table, idx, identity_tap=it)
        return pillar_sparse._zconv_t(g.view(9, table.shape[0], -1), taps_w, c, 1)

    path = k7_path().reshape(out.shape)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 2.0 ** -7 * ref.float().abs() + 2.0 ** -12 * mag).all()), \
        f"K10 {what}: max err {err.max().item()} against its plain version"
    perr = (out.float() - path.float()).abs()
    assert bool((perr <= 2.0 ** -7 * path.float().abs() + 9 * 2.0 ** -8 * mag).all()), \
        f"K10 {what}: max err {perr.max().item()} against K7 + z product"
    del out, ref, mag, path
    nbytes, flops = k10_work(table, idx, nz, cout, it)
    return dict(shape=what, err=err.max().item(), tol="2^-7 rel + 2^-12 x sum|terms|",
                path_err=perr.max().item(), launches=launches,
                ms=cuda_ms(lambda: gather.gather9_conv_t(table, idx, w, nz, identity_tap=it), 5),
                plain_ms=cuda_ms(lambda: gather.gather9_conv_t_plain(table, idx, w, nz, it), 2),
                path_ms=cuda_ms(k7_path, 5), library_ms=None,
                bound=bound_ms(nbytes, flops, peak_flops(table)))


def log_k10_rows(rows):
    for r in rows:
        log(f"  K10 {r['shape']}: max_abs_err {r['err']:.3g} vs plain ({r['tol']}), "
            f"{r['path_err']:.3g} vs K7 + z product; ms {r['ms']:.4f}, plain_ms "
            f"{r['plain_ms']:.4f}, K7 + z product ms {r['path_ms']:.4f}, bound_ms "
            f"{r['bound'][0]:.4f} ({r['bound'][1]})")


def phase_k10(k7_calls, layer_shapes):
    """K10 (``gather9_conv_t``) on every stride-1 K7 call of SECOND's
    recorded forward (stages 1-4): each table and tap table gets seeded
    He-normal weights of its layer's (C, C) shape and goes through
    ``check_k10_call``. ``layer_shapes`` maps a haloed table height W to
    (nz, C). K10's launches are those of the checks here (no path runs
    it)."""
    import torch

    from toda_tpu_torch.ops import gather

    gen = torch.Generator().manual_seed(SEED)
    rows = {"K10": []}
    for (table, idx), kw in k7_calls:
        nz, c = layer_shapes[table.shape[0]]
        w = (torch.randn((3, 3, 3, c, c), generator=gen) * (2.0 / (27 * c)) ** 0.5).to(
            device=table.device, dtype=table.dtype)
        rows["K10"].append(check_k10_call(
            table, idx, w, nz, kw.get("identity_tap"),
            f"table{tuple(table.shape)} {table.dtype} idx{tuple(idx.shape)} nz{nz} C=Cout={c}"))
    launches = sum(r["launches"] for r in rows["K10"])
    assert launches == len(k7_calls), launches
    log(f"phase K10: {launches} stride-1 convs of SECOND's forward through gather9_conv_t")
    log_k10_rows(rows["K10"])
    log(f"  K10 per forward: {sum(r['ms'] for r in rows['K10']):.3f} ms over {launches} "
        f"calls, bound {sum(r['bound'][0] for r in rows['K10']):.3f} ms, K7 + z product "
        f"{sum(r['path_ms'] for r in rows['K10']):.3f} ms")
    return rows, launches


def misaligned(t):
    """A contiguous copy of t whose data starts 2 bytes past a 16-byte
    boundary."""
    import torch

    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


def random_taps(gen, m, n, present, device):
    """An (m, 9) int32 tap table into n columns, each entry present with
    probability ``present``, nondecreasing per tap where present (as the
    key-sorted pillars' tables are)."""
    import torch

    vals = torch.sort(torch.randint(0, n, (m, 9), generator=gen, device=device), dim=0).values
    keep = torch.rand((m, 9), generator=gen, device=device) < present
    return torch.where(keep, vals, -1).int().contiguous()


def phase_stress_column_gathers():
    """K7 and K10 on tables no scene gives, on top of the recorded calls,
    each held against its plain version (K7 exactly, K10 by
    ``check_k10_call``; both also timed). K7: an odd M (not a multiple of
    8), all -1 indices, an f32 table, chunks 16, 32 and 64, M = 2N with no
    identity tap (the backward's inverse tables), N = 1, a table not 16-byte
    aligned, and a dense stage-3 plane (every tap present) in both row
    orders at full width. K10: each Cout in {8, 16, 32, 64}, C = 8, nz = 1,
    an odd M, a tap absent from a whole block, no identity tap, an f32
    table, a table not aligned, and the dense stage-3 plane at full width.
    Their launches are not the main path's and are not counted."""
    import torch

    from toda_tpu_torch.ops import gather

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    rows = {"K7": [], "K10": []}
    dense, _, n_dense = stress_table(256, 256, 1, "cuda")  # M = N = 65637, odd
    small, _, n_small = stress_table(48, 48, 1, "cuda")    # M = N = 2405
    k7_cases = [
        ("dense stage-3 plane, [t][W]", rand(640, n_dense), dense, None, 4),
        ("dense stage-3 plane, chunk 64", rand(640, n_dense), dense, 64, 4),
        ("odd M, chunk 16", rand(192, n_small), small, 16, 4),
        ("chunk 32", rand(192, n_small), small, 32, 4),
        ("f32 table, chunk 64", rand(192, n_small, dtype=torch.float32), small, 64, 4),
        ("all -1", rand(64, 999), torch.full((999, 9), -1, dtype=torch.int32, device="cuda"),
         None, None),
        ("M = 2N, no identity", rand(128, 1500), random_taps(gen, 3000, 1500, 0.5, "cuda"),
         32, None),
        ("N = 1", rand(64, 1), random_taps(gen, 37, 1, 0.5, "cuda"), None, None),
        ("table not 16-byte aligned", misaligned(rand(96, n_small)), small, 32, 4),
    ]
    for what, table, idx, chunk, it in k7_cases:
        kw = dict(chunk=chunk, identity_tap=it)
        out = gather.gather9_stacked_t(table, idx, **kw)
        assert torch.equal(out, gather.gather9_stacked_t_plain(table, idx, **kw)), \
            f"K7 stress {what} differs from its plain version"
        del out
        rows["K7"].append(dict(
            shape=f"{what}: table{tuple(table.shape)} {table.dtype} idx{tuple(idx.shape)}",
            err=0.0, tol="0 (exact)",
            ms=cuda_ms(lambda: gather.gather9_stacked_t(table, idx, **kw), 5),
            plain_ms=cuda_ms(lambda: gather.gather9_stacked_t_plain(table, idx, **kw), 2),
            library_ms=None,
            bound=bound_ms(*column_gather_work(table, idx, 9), H100_F32_FLOPS)))
    absent = small.clone()
    absent[:512, 0] = -1  # tap 0 absent from the first 8 blocks of 64 columns
    bf16 = torch.bfloat16
    k10_cases = [  # (what, C, Cout, nz, idx, N, identity, dtype, aligned)
        ("dense stage-3 plane", 64, 64, 10, dense, n_dense, 4, bf16, True),
        ("Cout 8", 16, 8, 4, small, n_small, 4, bf16, True),
        ("Cout 16, tap 0 absent from 8 blocks", 16, 16, 4, absent, n_small, 4, bf16, True),
        ("Cout 32, nz 1", 32, 32, 1, small, n_small, 4, bf16, True),
        ("Cout 64, no identity tap", 64, 64, 3, small, n_small, None, bf16, True),
        ("C 8", 8, 16, 3, small, n_small, 4, bf16, True),
        ("odd M = 2N, no identity", 16, 32, 2, random_taps(gen, 1201, 600, 0.5, "cuda"), 600,
         None, bf16, True),
        ("f32 table", 16, 16, 3, small, n_small, 4, torch.float32, True),
        ("table not 16-byte aligned", 32, 16, 2, small, n_small, 4, bf16, False),
    ]
    for what, c, cout, nz, idx, n, it, dtype, aligned in k10_cases:
        table = rand((nz + 2) * c, n, dtype=dtype)
        table[:c] = 0
        table[-c:] = 0
        if not aligned:
            table = misaligned(table)
        w = rand(3, 3, 3, c, cout, dtype=dtype) * (2.0 / (27 * c)) ** 0.5
        rows["K10"].append(check_k10_call(
            table, idx, w.to(dtype), nz, it,
            f"{what}: table{tuple(table.shape)} {dtype} idx{tuple(idx.shape)} nz{nz} C={c} "
            f"Cout={cout}"))
        assert rows["K10"][-1]["launches"] == 1, rows["K10"][-1]["launches"]
        del table, w
    del dense, small, absent
    torch.cuda.empty_cache()
    log("phase stress column gathers (K7 exact, K10 at its tolerance):")
    log_rows({"K7": rows["K7"]})
    log_k10_rows(rows["K10"])
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "toda_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: toda_tpu_torch is missing next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    # f32 convolutions and products in full f32 (the tiny parity check)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import numpy as np

    from toda_tpu_torch.datasets import build_dataloader
    from toda_tpu_torch.models import build_network
    from toda_tpu_torch.ops import _build
    from toda_tpu_torch.weights import randomize_

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t = time.time()
    _build.build_all()
    log(f"phase build: {len(_build.SOURCES)} sources in {time.time() - t:.1f}s")
    for name, out in _build.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    phase_tiny_parity()
    phase_tiny_train_parity()

    cfg = full_cfg()
    np.random.seed(SEED)
    dataset, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=BATCH)
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device="cuda")
    randomize_(bundle.module, SEED)
    first = next(iter(loader))
    log(f"full width: grid {dataset.grid_size.tolist()}, {first['points'].shape[1]} points/scan, "
        f"{int(first['points_mask'].sum(1).min())}-{int(first['points_mask'].sum(1).max())} real")
    rows = phase_kernels(bundle, first)
    phase_stress_unpack()
    launches, scans_per_s = phase_main_path(bundle, cfg, loader, dataset)
    dev = bundle.to_device(first)
    phase_profile(lambda: bundle.predict(dev), "predict")
    del bundle, dev

    # training at the same widths and scale, augmentor on, JAX-like init
    from toda_tpu_torch.runtime.train_utils import create_train_state, make_train_step

    np.random.seed(SEED)
    tdataset, tloader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size=BATCH,
                                            training=True)
    tbatches = list(tloader)
    tbundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), tdataset, device="cuda", seed=SEED)
    state, _ = create_train_state(tbundle, cfg.OPTIMIZATION, SCHEDULE_STEPS)
    step = make_train_step(tbundle)
    log(f"training: {len(tbatches)} batches of {BATCH} augmented scans, "
        f"{int(sum((b['gt_boxes'][..., -1] > 0).sum() for b in tbatches))} gt boxes")
    rows.update(phase_train_kernels(state, step, tbatches[0]))
    phase_stress_tables()
    tlaunches, train_scans, train_peak, tdev = phase_train_main(tbundle, state, step, tbatches)
    phase_profile(lambda: float(step(state, tdev)[1]["loss"]), "train step")
    launches.update({"K2": tlaunches["K2dx"] + tlaunches["dW"] - tlaunches["dW_raw"],
                     "K3": tlaunches["dW_raw"], "K6": tlaunches["K6"]})
    del tbundle, state, step, tdev, tbatches
    torch.cuda.empty_cache()

    # the TODA stages on fabricated Waymo and nuScenes files: stage-1 mix
    # training, FGSM pseudo labels, stage-2 CL
    phase_toda_tiny()
    (REPO / "build").mkdir(exist_ok=True)
    data_root = Path(tempfile.mkdtemp(prefix="toda_data_", dir=REPO / "build"))
    try:
        data_metrics, sizes = phase_data(data_root)
        trows, tl, toda = phase_toda(data_root)
        for key, rs in trows.items():
            rows[key].extend(rs)
        _, kl, kitti = phase_kitti(data_root)
        cl = phase_cli(data_root, sizes)
    finally:
        shutil.rmtree(data_root, ignore_errors=True)
    for t in (tl, kl, cl):
        launches["K1"] += t["K1"]
        launches["K2"] += t["dx"] + t["dW"] - t["dW_raw"]
        launches["K3"] += t["dW_raw"]
        for key in ("K4", "K5", "K6"):
            launches[key] += t[key]

    # PartA2 inference at the Waymo config's widths
    phase_parta2_tiny_parity()
    # PyTorch's default again for the full-width PartA2 run: cuDNN may take
    # f32 convolutions in TF32 (JAX's f32 convolutions on the TPU run at its
    # default, bf16-pass precision). UNetV2's conv_out promotes to f32, so
    # PartA2's BEV backbone runs in f32, where cuDNN's full-f32 choice (an
    # FFT) is orders of magnitude slower than its TF32 kernels.
    torch.backends.cudnn.allow_tf32 = True
    pcfg = parta2_cfg()
    np.random.seed(SEED)
    pdataset, ploader, _ = build_dataloader(pcfg.DATA_CONFIG, pcfg.CLASS_NAMES, batch_size=BATCH)
    pbundle = build_network(pcfg.MODEL, len(pcfg.CLASS_NAMES), pdataset, device="cuda")
    randomize_(pbundle.module, SEED)
    pfirst = next(iter(ploader))
    log(f"PartA2 full width: grid {pdataset.grid_size.tolist()}, {pfirst['points'].shape[1]} "
        f"points/scan, {int(pfirst['points_mask'].sum(1).min())}-"
        f"{int(pfirst['points_mask'].sum(1).max())} real, "
        f"{int((pfirst['gt_boxes'][..., -1] > 0).sum())} gt boxes in the first batch")
    for key, rs in phase_parta2_kernels(pbundle, pfirst).items():
        rows.setdefault(key, []).extend(rs)
    torch.cuda.empty_cache()
    plaunches, parta2_scans, pdev = phase_parta2_main(pbundle, pcfg, ploader, pdataset)
    phase_profile(lambda: float(pbundle.predict(pdev)["pred_scores"][0, 0]), "PartA2 predict")
    for key in ("K9", "K6", "K4", "K5"):
        launches[key] = launches.get(key, 0) + plaunches[key]
    phase_parta2_tf32(pbundle, pdev)
    del pbundle, pdev
    torch.cuda.empty_cache()

    # PV-RCNN inference at the Waymo config's widths (TF32 as for PartA2)
    torch.backends.cudnn.allow_tf32 = False
    phase_stress_ball_query()
    phase_pvrcnn_tiny_parity()
    torch.backends.cudnn.allow_tf32 = True
    vrows, vlaunches, pvrcnn_scans = phase_pvrcnn(pvrcnn_cfg())
    rows.update(vrows)
    for key, n in vlaunches.items():
        launches[key] = launches.get(key, 0) + n
    torch.cuda.empty_cache()

    # SECOND: the legacy conv contract (K7, K8), training and inference
    torch.backends.cudnn.allow_tf32 = False
    phase_second_tiny()
    phase_stress_column_gathers()
    torch.backends.cudnn.allow_tf32 = True
    srows, slaunches, second_scans, second_train, second_peak = phase_second(second_cfg())
    rows.update(srows)
    for key in ("K7", "K8", "K4", "K5", "K6", "K10"):
        launches[key] = launches.get(key, 0) + slaunches[key]

    meta = {
        "K1": ("fused_bnconv9", "toda_tpu_torch/csrc/fused_conv.cu",
               "toda_tpu/ops/pallas_fused_conv.py:475"),
        "K2": ("fused_bnconv9_bwd_dx + fused_bnconv9_dw", "toda_tpu_torch/csrc/fused_conv_bwd.cu",
               "toda_tpu/ops/pallas_fused_conv.py:934"),
        "K3": ("fused_bnconv9_dw (act=False)", "toda_tpu_torch/csrc/fused_conv_bwd.cu",
               "toda_tpu/ops/pallas_fused_conv.py:736"),
        "K4": ("scatter_rows_add", "toda_tpu_torch/csrc/gather.cu",
               "toda_tpu/ops/pallas_gather.py:925"),
        "K5": ("unpack_pillars", "toda_tpu_torch/csrc/gather.cu",
               "toda_tpu/ops/pallas_gather.py:1200"),
        "K6": ("gather_rows", "toda_tpu_torch/csrc/gather.cu",
               "toda_tpu/ops/pallas_gather.py:97"),
        "K7": ("gather9_stacked_t", "toda_tpu_torch/csrc/gather.cu",
               "toda_tpu/ops/pallas_gather.py:514"),
        "K8": ("gather_rows_taps_t", "toda_tpu_torch/csrc/gather.cu",
               "toda_tpu/ops/pallas_gather.py:354"),
        "K9": ("gather_rows_taps", "toda_tpu_torch/csrc/gather.cu",
               "toda_tpu/ops/pallas_gather.py:201"),
        "K10": ("gather9_conv_t", "toda_tpu_torch/csrc/gather.cu",
                "toda_tpu/ops/pallas_gather.py:729"),
        "FPS": ("farthest_point_sampling", "toda_tpu_torch/csrc/pointnet2.cu",
                "toda_tpu/ops/pointnet2_ops.py:22"),
        "BQ": ("ball_query", "toda_tpu_torch/csrc/pointnet2.cu",
               "toda_tpu/ops/pointnet2_ops.py:48"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        rs = rows[key]
        bnd = sum(r["bound"][0] for r in rs)
        by_ops = sum(r["bound"][0] for r in rs if r["bound"][1] == "operations")
        libs = [r["library_ms"] for r in rs]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key],
            "max_abs_err": max(r["err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": bnd,
            "bound_by": "operations" if by_ops * 2 > bnd else "bytes",
            "library_ms": None if any(v is None for v in libs) else sum(libs),
        })
    log(f"(kernel times are summed over the kernel's recorded calls: K1 per CenterPoint-Res "
        f"forward of batch {BATCH}; K2, K3 per train step, K2 also the TODA perturbation's "
        f"raw first-conv dx (one per perturb step); K9 per PartA2 forward; K4, K5 one "
        f"CenterPoint-Res and one PartA2 forward; K6 one train step, one PartA2 forward and "
        f"the perturbation's K4 VJPs (one per perturb step); K7, K8 one SECOND train step; "
        f"FPS and BQ one PV-RCNN forward (1 and 8 calls); K10 the seven stride-1 "
        f"convs of one SECOND forward, which no path runs through it. Launches are summed "
        f"over the counted runs: eval_one_epoch of each model, {TRAIN_STEPS} CenterPoint-Res "
        f"and {SECOND_TRAIN_STEPS} SECOND train steps, the TODA stages (stage-1 train_model, "
        f"the pseudo-label sweep, {TODA_CL_STEPS} CL steps), the same recipe through the "
        f"CLIs (with its target-domain evals and test.py), the nuScenes -> KITTI track's "
        f"stage-1 and test CLIs, K10's checks. "
        f"{scans_per_s:.2f} CenterPoint-Res predict scans/s, {train_scans:.2f} train scans/s, "
        f"train peak memory {train_peak:.2f} GiB, {parta2_scans:.2f} PartA2 predict scans/s, "
        f"{pvrcnn_scans:.2f} PV-RCNN predict scans/s, "
        f"{second_scans:.2f} SECOND predict scans/s, {second_train:.2f} SECOND train scans/s, "
        f"SECOND train peak memory {second_peak:.2f} GiB; TODA: "
        f"{toda['stage1_train_scans_per_s']:.2f} stage-1 train scans/s, "
        f"{toda['perturb_scans_per_s']:.2f} perturb scans/s, {toda['cl_train_scans_per_s']:.2f} "
        f"CL train scans/s, CL peak memory {toda['cl_peak_gib']:.2f} GiB; host loader "
        f"{data_metrics['loader_cutmix_scans_per_s']:.2f} CutMix and "
        f"{data_metrics['loader_val_scans_per_s']:.2f} nuScenes val scans/s on one thread; "
        f"SECOND-IoU nuScenes -> KITTI: {kitti['train_scans_per_s']:.2f} train and "
        f"{kitti['predict_scans_per_s']:.2f} predict scans/s, train peak memory "
        f"{kitti['train_peak_gib']:.2f} GiB, host loader {kitti['loader_scans_per_s']:.2f} "
        f"polarmix scans/s; on {card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
