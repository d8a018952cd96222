"""ctypes bridge to the native (C) image loader, ``native/imagedec.c``
(counterpart of ``d2r_tpu/data/native_image.py``).

Builds ``build/native/libd2rimage.so`` on first use (``cc`` with libjpeg and
libpng) and exposes :func:`native_load_image` with the contract of
``data/image.py``'s PIL path. Any native error returns None so callers fall
through to PIL, then the fallback image, then a grey frame. The C call runs
without the GIL, so the loader's threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from d2r_tpu_torch.data.native_lib import build_library, library_path
from d2r_tpu_torch.models.vit import CLIP_MEAN, CLIP_STD

_LIB_PATH = library_path("d2rimage")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _ensure_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = build_library("d2rimage", "imagedec.c", ["-ljpeg", "-lpng", "-lm"])
            if lib is None:
                _build_failed = True
                return None
            lib.d2r_load_image.restype = ctypes.c_int
            lib.d2r_load_image.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
            ]
            _lib = lib
    return _lib


def native_available() -> bool:
    return _ensure_lib() is not None


def native_load_image(path: str, image_size: int = 224,
                      raw_uint8: bool = False) -> Optional[np.ndarray]:
    """Decode and preprocess with the C library; None on any failure.

    ``raw_uint8``: resized and cropped RAW pixels, from the C resampler
    called with mean 0 and std 1/255 (float pixel values in [0, 255]) and
    rounded back to uint8; the C path resamples in float, so this costs at
    most 1 LSB against its float output.
    """
    lib = _ensure_lib()
    if lib is None:
        return None
    out = np.empty((3, image_size, image_size), dtype=np.float32)
    if raw_uint8:
        mean = np.zeros(3, dtype=np.float32)
        std = np.full(3, 1.0 / 255.0, dtype=np.float32)
    else:
        mean = np.array(CLIP_MEAN, dtype=np.float32)
        std = np.array(CLIP_STD, dtype=np.float32)
    rc = lib.d2r_load_image(
        path.encode("utf-8"), image_size,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    if raw_uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out
