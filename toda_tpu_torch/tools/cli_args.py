"""The flags the training-style CLIs share, and the run set-up they share.

Counterpart of ``tools/cli_args.py`` (:13-86): the reference's launch flags
(workers, launcher, tcp_port, local_rank, sync_bn, ...) mapped onto the
port's ``torch.distributed`` runtime (``parallel.mesh``), plus ``--device``:
the CLIs run on the card unless it names the CPU, and never fall back to
it. ``load_cfg``, ``run_dirs`` and ``make_logger`` are the set-up every CLI
repeats: a fresh config (rooted at the global ``cfg.ROOT_DIR``), the run
directory ``<ROOT_DIR>/output/<EXP_GROUP_PATH>/<TAG>/<extra_tag>`` and its
logger.
"""

import datetime
import os

from ..config import EDict, cfg, cfg_from_list, cfg_from_yaml_file
from ..parallel.mesh import init_dist_slurm, init_distributed
from ..utils.common_utils import create_logger, resolve_device


def add_device_arg(parser):
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: cuda; cpu runs the kernels' "
                             "plain versions)")
    return parser


def add_common_train_args(parser):
    parser.add_argument("--ckpt", type=str, default=None,
                        help="resume checkpoint (default: newest in the run dir)")
    parser.add_argument("--ckpt_save_interval", type=int, default=1)
    parser.add_argument("--max_ckpt_save_num", type=int, default=30)
    parser.add_argument("--workers", type=int, default=0,
                        help="loader prefetch depth (reference num_workers analog)")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of rank 0 for the process group")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--slurm", action="store_true",
                        help="derive the process group from SLURM_* env")
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm"], default="none",
                        help="reference launcher names: slurm -> SLURM_* env init; "
                             "pytorch -> MASTER_ADDR/PORT + RANK/WORLD_SIZE env (torchrun)")
    parser.add_argument("--sync_bn", action="store_true",
                        help="accepted for compatibility: data-parallel runs always take "
                             "BatchNorm statistics over the global batch")
    parser.add_argument("--merge_all_iters_to_one_epoch", action="store_true",
                        help="accepted for compatibility: the loader is never rebuilt "
                             "between epochs")
    parser.add_argument("--tcp_port", type=int, default=None,
                        help="compat: folded into --coordinator_address")
    parser.add_argument("--local_rank", "--local-rank", type=int, default=None,
                        help="compat: torch launchers inject this; the card comes from "
                             "LOCAL_RANK")
    return add_device_arg(parser)


def add_launcher_args(parser):
    """The launch flags of the evaluation-style CLIs (``tools/test.py``)."""
    parser.add_argument("--launcher", choices=["none", "pytorch", "slurm"], default="none")
    parser.add_argument("--tcp_port", type=int, default=None)
    parser.add_argument("--local_rank", "--local-rank", type=int, default=None)
    parser.set_defaults(coordinator_address=None, num_processes=None, process_id=None,
                        slurm=False)
    return add_device_arg(parser)


def resolve_launcher(args):
    """Map the reference launcher names onto the process-group inputs, as
    the JAX package's ``resolve_launcher`` does: slurm sets ``args.slurm``;
    pytorch reads torchrun's MASTER_ADDR, MASTER_PORT (or --tcp_port),
    WORLD_SIZE and RANK where the flags leave them unset."""
    if args.launcher == "slurm":
        args.slurm = True
    elif args.launcher == "pytorch" and args.coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = args.tcp_port or os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise RuntimeError(
                "--launcher pytorch requires the torchrun env (MASTER_ADDR + MASTER_PORT or "
                f"--tcp_port); found MASTER_ADDR={addr!r} "
                f"MASTER_PORT={os.environ.get('MASTER_PORT')!r}. Run under torchrun, or pass "
                "--coordinator_address, or drop --launcher for one process.")
        args.coordinator_address = f"{addr}:{port}"
        if args.num_processes is None and os.environ.get("WORLD_SIZE"):
            args.num_processes = int(os.environ["WORLD_SIZE"])
        if args.process_id is None and os.environ.get("RANK"):
            args.process_id = int(os.environ["RANK"])
    return args


def init_from_args(args):
    """Resolve the device and join the process group the flags name (none
    for one process). Returns (device, rank, world)."""
    resolve_launcher(args)
    device = resolve_device(args.device)
    if args.slurm:
        rank, world = init_dist_slurm(device=device)
    else:
        addr = args.coordinator_address
        rank, world = init_distributed(f"tcp://{addr}" if addr else None, args.num_processes,
                                       args.process_id, device)
    return device, rank, world


def log_compat_notes(args, logger):
    if getattr(args, "sync_bn", False):
        logger.info("--sync_bn: data-parallel runs always take global-batch BN statistics")
    if getattr(args, "merge_all_iters_to_one_epoch", False):
        logger.info("--merge_all_iters_to_one_epoch: no-op (the loader persists)")


def load_cfg(cfg_file, set_cfgs=None):
    """A fresh config from ``cfg_file`` (and ``--set`` pairs), with the
    global config's ROOT_DIR."""
    c = EDict()
    c.ROOT_DIR = cfg.ROOT_DIR
    c.LOCAL_RANK = cfg.LOCAL_RANK
    cfg_from_yaml_file(cfg_file, c)
    if set_cfgs:
        cfg_from_list(set_cfgs, c)
    return c


def run_dirs(c, extra_tag):
    """(output_dir, ckpt_dir) of a run, made."""
    output_dir = c.ROOT_DIR / "output" / c.EXP_GROUP_PATH / c.TAG / extra_tag
    ckpt_dir = output_dir / "ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    return output_dir, ckpt_dir


def make_logger(output_dir, kind, rank=0):
    return create_logger(
        output_dir / f"log_{kind}_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt", rank=rank)
