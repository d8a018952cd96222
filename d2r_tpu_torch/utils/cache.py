"""Where the port keeps what it builds (counterpart of
``d2r_tpu/utils/cache.py``).

The JAX package caches XLA's compiled programs on disk and honours
``JAX_COMPILATION_CACHE_DIR``. The port's compiled artifacts are the
``nvcc`` libraries of its kernels (``ops/kernels/build.py``) and the ``cc``
libraries of its data pipeline's C helpers (``data/native_lib.py``). Both
go under one directory: ``$D2R_TORCH_CACHE_DIR`` when it is set, read when
those modules are imported, else the git-ignored ``build/`` beside the
package; the kernels in ``kernels/``, the helpers in ``native/``. A location
that cannot be written raises, naming the variable, before anything is
built there.
"""

from __future__ import annotations

import os

ENV_VAR = "D2R_TORCH_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build")


def cache_dir(kind: str) -> str:
    """The directory of the port's built artifacts of ``kind`` ("kernels"
    or "native"): under ``$D2R_TORCH_CACHE_DIR``, else under ``build/``."""
    return os.path.join(os.environ.get(ENV_VAR) or DEFAULT_CACHE_DIR, kind)


def writable(path: str) -> str:
    """``path``, made if missing; raises ``RuntimeError`` naming
    :data:`ENV_VAR` when it cannot be made or written."""
    try:
        os.makedirs(path, exist_ok=True)
        if not os.access(path, os.W_OK):
            raise PermissionError(f"no write permission on {path}")
    except OSError as e:
        raise RuntimeError(f"cannot write the port's build cache at {path!r} ({e}); set "
                           f"{ENV_VAR} to a writable directory") from e
    return path
