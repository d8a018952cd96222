"""ctypes bridge to the native (C) WordPiece tokenizer, ``native/wordpiece.c``
(counterpart of ``d2r_tpu/data/native_text.py``).

Builds ``build/native/libd2rwordpiece.so`` on first use and exposes a
per-vocab-file handle whose :func:`native_encode` returns WordPiece ids for
ASCII text, the same ids as ``data/tokenizer.py``'s Python implementation
on that domain. Non-ASCII input returns None and callers take the Python
path. The C call runs without the GIL over an immutable hash table, so the
loader's threads tokenise in parallel.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional

from d2r_tpu_torch.data.native_lib import build_library, library_path

_LIB_PATH = library_path("d2rwordpiece")

_lock = threading.Lock()
_lib = None
_build_failed = False
_handles: Dict[str, int] = {}  # vocab path -> C handle (process lifetime)


def _ensure_lib():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = build_library("d2rwordpiece", "wordpiece.c")
            if lib is None:
                _build_failed = True
                return None
            lib.d2r_wp_load.restype = ctypes.c_void_p
            lib.d2r_wp_load.argtypes = [ctypes.c_char_p]
            lib.d2r_wp_encode.restype = ctypes.c_int
            lib.d2r_wp_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
            lib.d2r_wp_free.restype = None
            lib.d2r_wp_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def native_available() -> bool:
    return _ensure_lib() is not None


def load_native_vocab(vocab_path: str) -> Optional[int]:
    """C handle for ``vocab_path`` (cached for the process; vocabs are
    immutable assets). None when the library or the file is unusable."""
    lib = _ensure_lib()
    if lib is None:
        return None
    path = os.path.abspath(vocab_path)
    with _lock:
        if path not in _handles:
            _handles[path] = lib.d2r_wp_load(path.encode("utf-8")) or None
        return _handles[path]


def native_encode(handle: int, text: str, max_ids: int) -> Optional[List[int]]:
    """WordPiece ids (no [CLS]/[SEP]) for ASCII ``text``, truncated to
    ``max_ids``; None when the input needs the Python path (non-ASCII, or an
    embedded NUL that C string passing cannot represent)."""
    lib = _lib
    if lib is None or handle is None:
        return None
    if not text.isascii() or "\x00" in text:
        return None
    out = (ctypes.c_int32 * max(max_ids, 1))()
    n = lib.d2r_wp_encode(handle, text.encode("ascii"), out, max_ids)
    if n < 0:
        return None
    return list(out[:n])
