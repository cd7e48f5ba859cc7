"""Dataset info and gt-database generation:
``python -m toda_tpu_torch.tools.create_infos kitti|nuscenes|waymo|consolidate ...``.

Counterpart of ``tools/create_infos.py``, with the same flags, for the
datasets the port reads:

  * ``kitti``: ``kitti_infos_{train,val}.pkl`` from the raw tree under
    ``--data_path`` (training/{velodyne,calib,label_2},
    ImageSets/{train,val}.txt); with ``--with_gt_db`` the train split's gt
    database ``kitti_dbinfos_train.pkl`` of the ``--classes`` (KITTI's
    names: Car, Pedestrian, Cyclist), one box-relative ``.bin`` per object
    under ``gt_database/``;
  * ``nuscenes``: ``nuscenes_infos_<N>sweeps_{train,val}.pkl`` from the raw
    JSON tables and sweep files of ``--data_path/<version>``; with
    ``--with_gt_db`` the train split's gt database
    ``nuscenes_dbinfos_<N>sweeps.pkl`` (one box-relative ``.bin`` per object
    under ``gt_database/``), and with ``--sub_db_percents`` the seeded
    percentage sub-databases ``nuscenes_dbinfos_<N>sweeps_<p>pct.pkl``;
  * ``waymo``: every ``.tfrecord`` under ``--data_path`` extracted into
    ``<save>/waymo_processed_data/<sequence>/NNNN.npy`` and
    ``waymo_infos_train.pkl``; with ``--with_gt_db`` ``waymo_dbinfos_train.pkl``;
  * ``consolidate``: a per-object gt database packed into one ``.npy`` and
    offset-carrying infos, for the sampler's ``USE_SHARED_MEMORY`` path.

``lyft`` and ``pandaset`` are not ported yet and exit non-zero.

Examples:
  python -m toda_tpu_torch.tools.create_infos kitti --data_path data/kitti --with_gt_db \\
      --classes Car,Pedestrian,Cyclist
  python -m toda_tpu_torch.tools.create_infos nuscenes --data_path data/nuscenes \\
      --version v1.0-trainval --with_gt_db --classes car
  python -m toda_tpu_torch.tools.create_infos waymo --data_path data/waymo/raw \\
      --save_path data/waymo --with_gt_db --classes Vehicle,Pedestrian,Cyclist
"""

import argparse
import pickle
from pathlib import Path

from ..config import EDict
from ..utils import common_utils

NOT_PORTED = ("lyft", "pandaset")


def _db_cfg(info_name, used, extra=None):
    """A test-mode dataset config over one info pickle (None: none),
    without processors, augmentation, shifts or filters: the frames as they
    lie on disk."""
    return EDict({
        "INFO_PATH": {"train": [], "test": [info_name] if info_name else []},
        "POINT_CLOUD_RANGE": [-75.2, -75.2, -5.0, 75.2, 75.2, 4.0],
        "POINT_FEATURE_ENCODING": {
            "encoding_type": "absolute_coordinates_encoding",
            "used_feature_list": used, "src_feature_list": used,
        },
        "DATA_PROCESSOR": [], **(extra or {}),
    })


def _kitti(args, logger):
    from ..datasets.kitti.kitti_dataset import KittiDataset

    save = Path(args.save_path or args.data_path)
    for split, fname in (("train", "kitti_infos_train.pkl"), ("val", "kitti_infos_val.pkl")):
        cfg = _db_cfg(None, ["x", "y", "z", "intensity"], {
            "DATA_PATH": args.data_path, "DATA_SPLIT": {"train": split, "test": split}})
        ds = KittiDataset(cfg, None, training=False, root_path=args.data_path, logger=logger)
        try:
            infos = ds.get_infos()
        except FileNotFoundError as e:
            logger.warning("split %s skipped (%s)", split, e)
            continue
        with open(save / fname, "wb") as f:
            pickle.dump(infos, f)
        logger.info("%s: %d infos -> %s", split, len(infos), save / fname)
        if split == "train" and args.with_gt_db:
            ds.infos = infos
            db = ds.create_groundtruth_database(used_classes=args.classes.split(","),
                                                out_path=save / "kitti_dbinfos_train.pkl")
            logger.info("gt database: %s", {k: len(v) for k, v in db.items()})


def _nuscenes(args, logger):
    from ..datasets.nuscenes.nuscenes_dataset import NuScenesDataset
    from ..datasets.nuscenes.nuscenes_utils import create_nuscenes_infos

    save = Path(args.save_path or args.data_path)
    train, val = create_nuscenes_infos(args.version or "v1.0-mini", args.data_path,
                                       save_path=save, max_sweeps=args.max_sweeps, logger=logger)
    logger.info("train %d / val %d infos", len(train), len(val))
    if args.with_gt_db:
        classes = args.classes.split(",")
        tag = f"{args.max_sweeps}sweeps"
        ds = NuScenesDataset(
            _db_cfg(str(save / f"nuscenes_infos_{tag}_train.pkl"),
                    ["x", "y", "z", "intensity", "timestamp"],
                    {"MAX_SWEEPS": args.max_sweeps}),
            classes, training=False, root_path=args.data_path, logger=logger)
        db = ds.create_groundtruth_database(used_classes=classes,
                                            out_path=save / f"nuscenes_dbinfos_{tag}.pkl")
        logger.info("gt database: %s", {k: len(v) for k, v in db.items()})
        for pct in args.sub_db_percents:
            ds.create_sub_groundtruth_database(
                pct / 100.0, out_path=save / f"nuscenes_dbinfos_{tag}_{pct:g}pct.pkl")
            logger.info("sub gt database: %g%%", pct)


def _waymo(args, logger):
    from ..datasets.waymo.waymo_dataset import WaymoDataset, create_waymo_infos

    save = Path(args.save_path or args.data_path)
    infos = create_waymo_infos(args.data_path, save / "waymo_processed_data",
                               sampled_interval=args.sampled_interval, logger=logger)
    with open(save / "waymo_infos_train.pkl", "wb") as f:
        pickle.dump(infos, f)
    logger.info("%d infos -> %s", len(infos), save / "waymo_infos_train.pkl")
    if args.with_gt_db:
        classes = args.classes.split(",")
        ds = WaymoDataset(_db_cfg("waymo_infos_train.pkl",
                                  ["x", "y", "z", "intensity", "elongation"]),
                          classes, training=False, root_path=save, logger=logger)
        db = ds.create_groundtruth_database(used_classes=classes,
                                            out_path=save / "waymo_dbinfos_train.pkl")
        logger.info("gt database: %s", {k: len(v) for k, v in db.items()})


def _consolidate(args, logger):
    from ..datasets.augmentor.database_sampler import consolidate_gt_database

    if not args.dbinfos:
        raise SystemExit("--dbinfos is required for `consolidate`")
    consolidate_gt_database(args.dbinfos, args.data_path,
                            num_point_features=args.num_point_features, logger=logger)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dataset",
                        choices=["kitti", "nuscenes", "waymo", "consolidate", *NOT_PORTED])
    parser.add_argument("--data_path", required=True,
                        help="raw dataset root (waymo: dir of .tfrecord files)")
    parser.add_argument("--save_path", default=None,
                        help="output dir for info pkls (default: data_path)")
    parser.add_argument("--version", default=None,
                        help="nuscenes table version (default v1.0-mini)")
    parser.add_argument("--max_sweeps", type=int, default=10)
    parser.add_argument("--sampled_interval", type=int, default=1,
                        help="waymo: keep every Nth frame")
    parser.add_argument("--with_gt_db", action="store_true",
                        help="also build the gt copy-paste database")
    parser.add_argument("--classes", default="Car,Pedestrian,Cyclist",
                        help="classes for the gt database (comma-separated; nuScenes uses "
                             "its lowercase names, e.g. car,pedestrian,truck)")
    parser.add_argument("--sub_db_percents", type=float, nargs="*", default=[],
                        help="nuscenes: also build labelled-percentage sub gt databases "
                             "(e.g. 1 5 10)")
    parser.add_argument("--dbinfos", default=None,
                        help="consolidate: path to the dbinfos pkl to pack")
    parser.add_argument("--num_point_features", type=int, default=None,
                        help="consolidate: keep the first N point columns (default: every "
                             "column the database's objects hold)")
    args = parser.parse_args(argv)
    if args.dataset in NOT_PORTED:
        raise SystemExit(f"create_infos {args.dataset}: not ported to the PyTorch package yet")
    logger = common_utils.create_logger()
    {"kitti": _kitti, "nuscenes": _nuscenes, "waymo": _waymo,
     "consolidate": _consolidate}[args.dataset](args, logger)


if __name__ == "__main__":
    main()
