"""TODA stage 1, inter-domain mix training:
``python -m toda_tpu_torch.tools.stage1_cutmix_train --cfg_file ...``.

Counterpart of ``tools/stage1_cutmix_train.py``: ``train.py``'s skeleton
over the stage-1 CutMix loader (the mixers' curriculum ``train_percent`` is
set by ``train_model``), then the target-domain evaluation of
``DATA_CONFIG_TEST`` unless ``--skip_eval``. ``--batch_size`` is each
process's batch (``BATCH_SIZE_PER_GPU``).
"""

import argparse

from ..config import log_config_to_file
from ..datasets import build_cutmix_dataloader
from ..models import build_network
from ..runtime import checkpoint as ckpt_lib
from ..runtime.eval_utils import evaluate_target_domain
from ..runtime.train_utils import create_train_state, train_model
from ..utils.common_utils import set_random_seed
from .cli_args import (
    add_common_train_args,
    init_from_args,
    load_cfg,
    log_compat_notes,
    make_logger,
    run_dirs,
)


def main(argv=None):
    """Returns the target-domain eval result, or None when skipped."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--pretrained_model", type=str, default=None)
    parser.add_argument("--fix_random_seed", action="store_true")
    parser.add_argument("--skip_eval", action="store_true",
                        help="skip the post-training target-domain eval")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    add_common_train_args(parser)
    args = parser.parse_args(argv)
    cfg = load_cfg(args.cfg_file, args.set_cfgs)

    device, rank, world = init_from_args(args)
    if args.fix_random_seed:
        set_random_seed(666)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS
    output_dir, ckpt_dir = run_dirs(cfg, args.extra_tag)
    logger = make_logger(output_dir, "train", rank)
    log_config_to_file(cfg, logger=logger)
    log_compat_notes(args, logger)

    dataset, loader, _ = build_cutmix_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                                 dist=world > 1, training=True, logger=logger,
                                                 workers=args.workers)
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device=device)
    state, schedule = create_train_state(bundle, cfg.OPTIMIZATION, len(loader) * epochs)
    if args.pretrained_model:
        ckpt_lib.load_params_only(args.pretrained_model, bundle)
    resume = args.ckpt or ckpt_lib.latest_checkpoint(ckpt_dir)
    start_epoch = ckpt_lib.load_checkpoint(resume, bundle, state) if resume else 0

    train_model(bundle, state, loader, start_epoch, epochs, ckpt_dir, schedule=schedule,
                logger=logger, ckpt_save_interval=args.ckpt_save_interval,
                max_ckpt_save_num=args.max_ckpt_save_num)
    logger.info("stage-1 training done")

    if args.skip_eval or "DATA_CONFIG_TEST" not in cfg:
        return None
    result, _ = evaluate_target_domain(cfg, bundle.module.state_dict(), batch_size, device,
                                       logger=logger, dist=world > 1)
    return result


if __name__ == "__main__":
    main()
