"""TODA stage 2, target-oriented MixUp training without the consistency
loss: ``python -m toda_tpu_torch.tools.stage2_mixup_train --cfg_file ...
--pseudo_info_path ...``.

Counterpart of ``tools/stage2_mixup_train.py``: the MixUp loader over the
labelled frames and the pseudo infos, the stage-1 weights through
``--pretrained_model`` (the optimizer starts afresh), ``train_model``, then
the target-domain evaluation unless ``--skip_eval``.
"""

import argparse

from ..datasets import build_mixup_dataloader
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


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--pseudo_info_path", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--pretrained_model", type=str, default=None)
    parser.add_argument("--fix_random_seed", action="store_true")
    parser.add_argument("--skip_eval", action="store_true",
                        help="skip the post-training target-domain eval")
    parser.add_argument("--repeat", type=int, default=0,
                        help="epoch-length multiplier over the labelled pool "
                             "(DATA_CONFIG.REPEAT)")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    add_common_train_args(parser)
    return parser.parse_args(argv)


def setup(args):
    """(cfg, device, rank, world, output_dir, ckpt_dir, logger) of a stage-2 run."""
    cfg = load_cfg(args.cfg_file, args.set_cfgs)
    if args.repeat:
        cfg.DATA_CONFIG.REPEAT = args.repeat
    device, rank, world = init_from_args(args)
    if args.fix_random_seed:
        set_random_seed(666)
    output_dir, ckpt_dir = run_dirs(cfg, args.extra_tag)
    logger = make_logger(output_dir, "train", rank)
    log_compat_notes(args, logger)
    return cfg, device, rank, world, output_dir, ckpt_dir, logger


def start_state(args, cfg, bundle, ckpt_dir, total_steps, logger):
    """(state, schedule, start epoch): the stage-1 weights, then a resume
    from ``--ckpt`` or the newest checkpoint of the run."""
    state, schedule = create_train_state(bundle, cfg.OPTIMIZATION, total_steps)
    if args.pretrained_model:
        ckpt_lib.load_params_only(args.pretrained_model, bundle)
        logger.info("transferred stage-1 weights from %s", args.pretrained_model)
    start_epoch = 0
    resume = args.ckpt or ckpt_lib.latest_checkpoint(ckpt_dir)
    if resume:
        start_epoch = ckpt_lib.load_checkpoint(resume, bundle, state)
        logger.info("resumed from %s (epoch %d)", resume, start_epoch)
    return state, schedule, start_epoch


def main(argv=None):
    """Returns the target-domain eval result, or None when skipped."""
    args = parse_args(argv)
    cfg, device, rank, world, output_dir, ckpt_dir, logger = setup(args)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS
    dataset, loader, _ = build_mixup_dataloader(
        cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size, pseudo_infos=args.pseudo_info_path,
        dist=world > 1, training=True, logger=logger, workers=args.workers)
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device=device)
    state, schedule, start_epoch = start_state(args, cfg, bundle, ckpt_dir,
                                               len(loader) * epochs, logger)
    train_model(bundle, state, loader, start_epoch, epochs, ckpt_dir, schedule=schedule,
                logger=logger, ckpt_save_interval=args.ckpt_save_interval,
                max_ckpt_save_num=args.max_ckpt_save_num)
    logger.info("stage-2 training done")
    if args.skip_eval or "DATA_CONFIG_TEST" not in cfg:
        return None
    result, _ = evaluate_target_domain(cfg, bundle.module.state_dict(), batch_size, device,
                                       logger=logger, dist=world > 1)
    return result


if __name__ == "__main__":
    main()
