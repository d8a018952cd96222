"""Build the port's CUDA sources into shared libraries, loaded with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and no PyTorch headers, so
``nvcc`` compiles it in seconds. Libraries go to ``kernels/`` of the
port's build cache (``utils/cache.py``: ``$D2R_TORCH_CACHE_DIR``, else
``build/`` beside the package), at first use, and are rebuilt when their
source is newer.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, List

from d2r_tpu_torch.utils import cache

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = cache.cache_dir("kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# every kernel source of the port, by the name its library is built under
SOURCES = {"fused_attention_fwd": "fused_attention_fwd.cu",
           "fused_attention_bwd": "fused_attention_bwd.cu",
           "flash_attention_fwd": "flash_attention_fwd.cu",
           "dropout": "dropout.cu",
           "adamw": "adamw.cu",
           "w8a16_linear": "w8a16_linear.cu",
           "quantize": "quantize.cu"}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; "
                           "the port's CUDA kernels are built with it")
    return path


def _paths(name: str):
    src = os.path.join(CSRC, SOURCES[name])
    return src, os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """Missing, or older than its source or any header of ``csrc``."""
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return os.path.getmtime(so) < max(os.path.getmtime(f) for f in [src, *headers])


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile the named sources (default: all) that are missing or stale,
    one ``nvcc`` process each, in parallel. Returns each library's ptxas
    report (registers, shared memory, spills); raises if any build fails."""
    names = list(SOURCES) if names is None else names
    cache.writable(BUILD_DIR)
    procs = {}
    for name in names:
        if not _stale(name):
            continue
        src, so = _paths(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, so)
    reports, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib
