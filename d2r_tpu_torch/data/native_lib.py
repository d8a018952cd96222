"""Build and load the repo's native C helpers (``native/*.c``) for the
port's data pipeline.

Libraries are compiled with ``cc`` into ``native/`` of the port's build
cache (``utils/cache.py``: ``$D2R_TORCH_CACHE_DIR``, else ``build/`` beside
the package), at first use, and rebuilt when their source is newer. The JAX
package builds the same sources into ``native/``; the port never writes
there. A library is compiled under a temporary name and renamed into place,
so a process never loads one that another is still writing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Sequence

from d2r_tpu_torch.utils import cache

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_SRC = os.path.join(_REPO, "native")
BUILD_DIR = cache.cache_dir("native")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build_library(name: str, source: str, libs: Sequence[str] = ()) -> Optional[ctypes.CDLL]:
    """``native/<source>`` compiled into ``lib<name>.so`` of
    :data:`BUILD_DIR` and loaded; None when the source is absent or ``cc``
    or the load fails (the callers then take their Python path). An
    unwritable :data:`BUILD_DIR` raises (``utils/cache.py``)."""
    src, so = os.path.join(NATIVE_SRC, source), library_path(name)
    stale = not os.path.exists(so) or (os.path.exists(src)
                                       and os.path.getmtime(so) < os.path.getmtime(src))
    if stale:
        cache.writable(BUILD_DIR)
    try:
        if stale:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["cc", "-O3", "-shared", "-fPIC", "-o", tmp, src, *libs],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        return ctypes.CDLL(so)
    except (OSError, subprocess.CalledProcessError):
        return None
