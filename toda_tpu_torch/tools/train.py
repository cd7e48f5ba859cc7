"""Training entry point: ``python -m toda_tpu_torch.tools.train --cfg_file ...``.

Counterpart of ``tools/train.py``: the run directory
``output/<exp_group>/<tag>/<extra_tag>``, the config logged and copied
there, resume from the newest ``checkpoint_epoch_<n>.pth`` (or ``--ckpt``),
``--pretrained_model`` weights, training scalars under ``tensorboard/``, and
the evaluation of the last checkpoints / of the trained weights after
training. ``--batch_size`` is the global batch: a data-parallel run (see
``cli_args``) gives each process its share.
"""

import argparse
import shutil
from pathlib import Path

from ..config import log_config_to_file
from ..datasets import build_dataloader
from ..models import build_network
from ..runtime import checkpoint as ckpt_lib
from ..runtime.eval_utils import evaluate_target_domain
from ..runtime.train_utils import create_train_state, train_model
from ..utils.common_utils import set_random_seed
from ..utils.scalar_writer import create_scalar_writer
from .cli_args import (
    add_common_train_args,
    init_from_args,
    load_cfg,
    log_compat_notes,
    make_logger,
    run_dirs,
)


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description="toda_tpu_torch trainer")
    parser.add_argument("--cfg_file", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=None, help="global batch size")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--pretrained_model", type=str, default=None)
    parser.add_argument("--fix_random_seed", action="store_true")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    parser.add_argument("--eval_after_train", action="store_true")
    parser.add_argument("--num_epochs_to_eval", type=int, default=0,
                        help="also evaluate the last N saved checkpoints after training")
    add_common_train_args(parser)
    args = parser.parse_args(argv)
    return args, load_cfg(args.cfg_file, args.set_cfgs)


def main(argv=None):
    """Returns the eval result of the trained weights (--eval_after_train),
    else None."""
    args, cfg = parse_config(argv)
    device, rank, world = init_from_args(args)
    dist = world > 1
    if args.fix_random_seed:
        set_random_seed(666)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    if dist:
        if batch_size % world:
            raise ValueError(f"--batch_size {batch_size} (the global batch) does not divide "
                             f"by the world size {world}")
        batch_size //= world
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS

    output_dir, ckpt_dir = run_dirs(cfg, args.extra_tag)
    logger = make_logger(output_dir, "train", rank)
    logger.info("********** Start logging **********")
    log_compat_notes(args, logger)
    log_config_to_file(cfg, logger=logger)
    if rank == 0:
        shutil.copyfile(args.cfg_file, output_dir / Path(args.cfg_file).name)

    dataset, loader, _ = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                          dist=dist, training=True, logger=logger,
                                          workers=args.workers)
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device=device)
    state, schedule = create_train_state(bundle, cfg.OPTIMIZATION, len(loader) * epochs)
    start_epoch = 0
    if args.pretrained_model:
        ckpt_lib.load_params_only(args.pretrained_model, bundle)
        logger.info("loaded pretrained model from %s", args.pretrained_model)
    resume_from = args.ckpt or ckpt_lib.latest_checkpoint(ckpt_dir)
    if resume_from:
        start_epoch = ckpt_lib.load_checkpoint(resume_from, bundle, state)
        logger.info("resumed from %s (epoch %d)", resume_from, start_epoch)

    tb_log = create_scalar_writer(output_dir / "tensorboard") if rank == 0 else None
    logger.info("********** Start training (epochs %d->%d) **********", start_epoch, epochs)
    train_model(bundle, state, loader, start_epoch, epochs, ckpt_dir, schedule=schedule,
                logger=logger, ckpt_save_interval=args.ckpt_save_interval,
                max_ckpt_save_num=args.max_ckpt_save_num, tb_log=tb_log)
    if tb_log is not None:
        tb_log.flush()
    logger.info("********** Training done **********")

    for c in ckpt_lib.scan_dir_for_ckpts(ckpt_dir)[-args.num_epochs_to_eval:] \
            if args.num_epochs_to_eval > 0 else []:
        result, _ = evaluate_target_domain(cfg, ckpt_lib.load_weights(c, device), batch_size,
                                           device, logger=logger, dist=dist)
        logger.info("post-train eval of %s: %s", c.name, result)

    result = None
    if args.eval_after_train:
        result, _ = evaluate_target_domain(cfg, bundle.module.state_dict(), batch_size, device,
                                           logger=logger, dist=dist)
        if tb_log is not None:
            for k, v in result.items():
                tb_log.add_scalar(f"eval/{k}", float(v), epochs)
            tb_log.flush()
    return result


if __name__ == "__main__":
    main()
