"""TODA pseudo labels, plain or with the FGSM input perturbation:
``python -m toda_tpu_torch.tools.generate_pseudo_labels --cfg_file ... --ckpt ...``.

Counterpart of ``tools/generate_pseudo_labels.py``: a test-mode sweep of
``UNLABEL_DATA_CONFIG`` (else ``DATA_CONFIG``) with the checkpoint's weights
(``runtime.pseudo_label.generate_pseudo_labels``); ``--perturb`` adds each
frame's eps * sign of the loss gradient in its points and its voxel-keyed
form. The infos are pickled to ``--output`` (default
``<run dir>/pseudo_infos.pkl``).
"""

import argparse
import pickle

from ..datasets import build_dataloader
from ..models import build_network
from ..runtime import checkpoint as ckpt_lib
from ..runtime.pseudo_label import generate_pseudo_labels
from ..utils.common_utils import resolve_device
from .cli_args import add_device_arg, load_cfg, make_logger, run_dirs


def main(argv=None):
    """Returns the path of the written pickle."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--score_thresh", "--pseudo_thresh", dest="score_thresh", type=float,
                        default=0.2)
    parser.add_argument("--perturb", action="store_true")
    parser.add_argument("--eps", type=float, default=1.0)
    parser.add_argument("--min_points", type=int, default=0,
                        help="drop pseudo boxes with fewer interior points")
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--workers", type=int, default=0,
                        help="loader prefetch depth (reference num_workers analog)")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    cfg = load_cfg(args.cfg_file, args.set_cfgs)
    device = resolve_device(args.device)

    output_dir, _ = run_dirs(cfg, args.extra_tag)
    logger = make_logger(output_dir, "pseudo")
    dataset, loader, _ = build_dataloader(cfg.get("UNLABEL_DATA_CONFIG", cfg.DATA_CONFIG),
                                          cfg.CLASS_NAMES, args.batch_size or 2, training=False,
                                          logger=logger, workers=args.workers)
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device=device)
    ckpt_lib.load_checkpoint(args.ckpt, bundle)
    infos = generate_pseudo_labels(bundle, loader, dataset, cfg.CLASS_NAMES,
                                   score_thresh=args.score_thresh, with_perturb=args.perturb,
                                   eps=args.eps, min_points=args.min_points, logger=logger)
    out_path = args.output or (output_dir / "pseudo_infos.pkl")
    with open(out_path, "wb") as f:
        pickle.dump(infos, f)
    logger.info("wrote %d pseudo infos to %s", len(infos), out_path)
    return out_path


if __name__ == "__main__":
    main()
