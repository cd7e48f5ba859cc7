"""TODA stage 2, adversarial MixUp with the two-view consistency loss:
``python -m toda_tpu_torch.tools.stage2_mixup_train_cl --cfg_file ...
--pseudo_info_path ...``.

Counterpart of ``tools/stage2_mixup_train_cl.py``: the MixUp dataset over
the labelled frames and the pseudo infos, paired into (adv, org) views by
``CLPairDataset``; ``make_train_step_cl`` adds CL_CFG.WEIGHT x (centre + size)
consistency between the views mapped back to the scene's frame. The flags
and the set-up are ``stage2_mixup_train``'s. A checkpoint is saved after
every epoch.
"""

import time

from ..datasets import DataLoader, build_mixup_dataloader
from ..datasets.dataset_cl import CLPairDataset
from ..models import build_network
from ..parallel.mesh import data_parallel
from ..runtime import checkpoint as ckpt_lib
from ..runtime.eval_utils import evaluate_target_domain
from ..runtime.train_cl import make_train_step_cl
from .stage2_mixup_train import parse_args, setup, start_state


def main(argv=None):
    """Returns the target-domain eval result, or None when skipped."""
    args = parse_args(argv)
    cfg, device, rank, world, output_dir, ckpt_dir, logger = setup(args)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS
    base_ds, _, _ = build_mixup_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                                           pseudo_infos=args.pseudo_info_path, training=True,
                                           logger=logger)
    dataset = CLPairDataset(base_ds)
    loader = DataLoader(dataset, batch_size, training=True,
                        prefetch=args.workers if args.workers > 0 else 2, rank=rank,
                        world_size=world)
    bundle = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), dataset, device=device)
    state, _, start_epoch = start_state(args, cfg, bundle, ckpt_dir, len(loader) * epochs,
                                        logger)
    data_parallel(bundle.module)
    cl_cfg = cfg.MODEL.get("CL_CFG", {})
    step = make_train_step_cl(bundle, consistency_weight=float(cl_cfg.get("WEIGHT", 0.1)),
                              score_thresh=float(cl_cfg.get("SCORE_THRESH", 0.3)))
    total_its = len(loader) * epochs
    it = start_epoch * len(loader)
    for epoch in range(start_epoch, epochs):
        loader.set_epoch(epoch)
        t0 = time.time()
        for batch in loader:
            dataset.train_percent = it / max(total_its, 1)
            state, tb = step(state, batch)
            it += 1
        logger.info("epoch %d: loss %.4f (adv %.4f org %.4f cons %.4f/%.4f) %.1fs", epoch,
                    float(tb["loss"]), float(tb["loss_adv"]), float(tb["loss_org"]),
                    float(tb["consistency_center"]), float(tb["consistency_size"]),
                    time.time() - t0)
        ckpt_lib.save_checkpoint(ckpt_dir, bundle, state, epoch=epoch + 1,
                                 max_keep=args.max_ckpt_save_num)
    logger.info("stage-2 CL training done")
    if args.skip_eval or "DATA_CONFIG_TEST" not in cfg:
        return None
    result, _ = evaluate_target_domain(cfg, bundle.module.state_dict(), batch_size, device,
                                       logger=logger, dist=world > 1)
    return result


if __name__ == "__main__":
    main()
