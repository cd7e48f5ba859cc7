"""Builds the port's CUDA sources (``toda_tpu_torch/csrc/*.cu``) with nvcc and
loads them with ctypes.

Each source becomes one shared library with a plain C interface under
``build/kernels/`` at the repository root, named by a digest of its source,
the headers beside it (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and an unchanged one is reused. All
missing libraries are compiled at once, one nvcc process per source. Nothing
is built when a module is imported: the first kernel launch (or an explicit
``build_all()``) does it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("gather.cu", "fused_conv.cu", "fused_conv_bwd.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs = {}
build_logs = {}  # source name -> nvcc output of the build made by this process


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def _target(name):
    # a source's library is rebuilt when it or any header beside it changes
    src = (CSRC / name).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(name).stem}-{digest}.so"


def build_all():
    """Compile every source whose library is missing (in parallel) and load
    all libraries. Raises with nvcc's output if any compile fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for name in SOURCES:
            so = _target(name)
            if name in _libs or so.exists():
                continue
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, so, tmp, proc))
        failed = []
        for name, so, tmp, proc in jobs:
            out, _ = proc.communicate()
            build_logs[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in SOURCES:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_target(name)))
        return dict(_libs)


def library(name):
    """The loaded ctypes library of one source, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_all()[name]
    return lib


def check(err, what):
    """Raise if a launcher returned a CUDA error code (0 is cudaSuccess)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
