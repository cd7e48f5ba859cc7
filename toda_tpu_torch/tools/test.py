"""Evaluation entry point: ``python -m toda_tpu_torch.tools.test --cfg_file ...``.

Counterpart of ``tools/test.py``: ``--ckpt`` evaluates one checkpoint;
``--eval_all`` watches a checkpoint directory and evaluates each new
checkpoint (recorded in ``eval_list_<tag>.txt``, so a restarted watcher
skips what it did) until none has come for ``--max_waiting_mins``. Each
evaluation writes its detections to ``eval/[<eval_tag>/]epoch_<n>/result.pkl``.
With ``--launcher`` the frames are split over the processes and the results
merged (``eval_one_epoch``).
"""

import argparse
import pickle
import time
from pathlib import Path

import numpy as np

from ..datasets import build_dataloader
from ..models import build_network
from ..runtime import checkpoint as ckpt_lib
from ..runtime.eval_utils import eval_one_epoch, make_predict_step
from ..utils import commu_utils
from .cli_args import add_launcher_args, init_from_args, load_cfg, make_logger, run_dirs


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description="toda_tpu_torch evaluator")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None)
    parser.add_argument("--eval_all", action="store_true")
    parser.add_argument("--ckpt_dir", type=str, default=None)
    parser.add_argument("--max_waiting_mins", type=float, default=30)
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    parser.add_argument("--workers", type=int, default=0,
                        help="loader prefetch depth (reference num_workers analog)")
    parser.add_argument("--eval_tag", type=str, default="default",
                        help="subdirectory under eval/ separating result sets")
    parser.add_argument("--start_epoch", type=int, default=0,
                        help="--eval_all skips checkpoints before this epoch")
    parser.add_argument("--save_to_file", action="store_true",
                        help="per-frame KITTI label files: needs the KITTI adapter, which "
                             "the port does not have yet")
    add_launcher_args(parser)
    args = parser.parse_args(argv)
    if args.save_to_file:
        raise NotImplementedError("--save_to_file writes KITTI label files; the KITTI "
                                  "adapter is not ported yet")
    return args, load_cfg(args.cfg_file, args.set_cfgs)


def ckpt_epoch(path):
    """The epoch in a ``checkpoint_epoch_<n>.pth`` name (0 if none)."""
    tail = Path(path).stem.rsplit("_", 1)[-1]
    return int(tail) if tail.isdigit() else 0


def eval_ckpt(cfg, bundle, ckpt_path, loader, dataset, logger, result_root, predict_step=None):
    """Load ``ckpt_path``'s weights into ``bundle`` and evaluate; the
    detections go to ``<result_root>/epoch_<n>/result.pkl``. Returns
    (result_dict, epoch)."""
    epoch = ckpt_lib.load_checkpoint(ckpt_path, bundle)
    result, det_annos = eval_one_epoch(bundle, loader, dataset, cfg.CLASS_NAMES, logger=logger,
                                       predict_step=predict_step)
    if commu_utils.get_rank() == 0:
        result_dir = Path(result_root) / f"epoch_{epoch}"
        result_dir.mkdir(parents=True, exist_ok=True)
        with open(result_dir / "result.pkl", "wb") as f:
            pickle.dump(det_annos, f)
    return result, epoch


def repeat_eval_ckpt(cfg, bundle, args, ckpt_dir, loader, dataset, logger, result_root):
    """Evaluate each new checkpoint of ``ckpt_dir`` as training writes them;
    returns {epoch: result}."""
    record = result_root / f"eval_list_{cfg.TAG}.txt"
    evaluated = set(record.read_text().split()) if record.exists() else set()
    predict_step = make_predict_step(bundle)
    results = {}
    wait_start = time.time()
    while True:
        ckpts = [c for c in ckpt_lib.scan_dir_for_ckpts(ckpt_dir)
                 if str(c) not in evaluated and ckpt_epoch(c) >= args.start_epoch]
        if not ckpts:
            if time.time() - wait_start > args.max_waiting_mins * 60:
                return results
            time.sleep(30)
            continue
        for c in ckpts:
            result, epoch = eval_ckpt(cfg, bundle, c, loader, dataset, logger, result_root,
                                      predict_step)
            logger.info("ckpt %s: %s", c.name, result)
            results[epoch] = result
            evaluated.add(str(c))
            with open(record, "a") as f:
                f.write(str(c) + "\n")
        wait_start = time.time()


def main(argv=None):
    """Returns the result dict of ``--ckpt``, or {epoch: result} of
    ``--eval_all``."""
    args, cfg = parse_config(argv)
    device, rank, world = init_from_args(args)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    output_dir, ckpt_dir = run_dirs(cfg, args.extra_tag)
    result_root = output_dir / "eval"
    if args.eval_tag != "default":
        result_root = result_root / args.eval_tag
    result_root.mkdir(parents=True, exist_ok=True)
    logger = make_logger(output_dir, "test", rank)

    np.random.seed(1024)
    dataset, loader, _ = build_dataloader(cfg.get("DATA_CONFIG_TEST", cfg.DATA_CONFIG),
                                          cfg.CLASS_NAMES, batch_size, dist=world > 1,
                                          training=False, logger=logger, workers=args.workers)
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device=device)
    if args.eval_all:
        return repeat_eval_ckpt(cfg, bundle, args, Path(args.ckpt_dir or ckpt_dir), loader,
                                dataset, logger, result_root)
    if args.ckpt is None:
        raise ValueError("--ckpt is needed unless --eval_all")
    result, _ = eval_ckpt(cfg, bundle, args.ckpt, loader, dataset, logger, result_root)
    logger.info("final result: %s", result)
    return result


if __name__ == "__main__":
    main()
