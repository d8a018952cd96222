"""Host-side CLIP image preprocessing (counterpart of
``d2r_tpu/data/image.py``).

Resize the shortest side to ``image_size`` (bicubic), center-crop, scale to
[0, 1], normalise with the CLIP mean/std. ANY exception while decoding
falls back to a designated fallback image (the reference's ``inf.png``);
if even that is missing, a mid-grey frame stands in, so the pipeline never
stalls on bad data. The chain is native C, then PIL, then the fallback
image, then grey.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from d2r_tpu_torch.models import vit

CLIP_MEAN = np.array(vit.CLIP_MEAN, dtype=np.float32)
CLIP_STD = np.array(vit.CLIP_STD, dtype=np.float32)


def _load_pil(path: str):
    from PIL import Image
    return Image.open(path).convert("RGB")


def preprocess_pil(image, image_size: int = 224,
                   raw_uint8: bool = False) -> np.ndarray:
    """PIL image -> (3, H, W): CLIP-normalised float32, or resized/cropped
    RAW uint8 when ``raw_uint8`` (pixel_transfer='uint8' mode — 4x fewer
    host->device bytes; the model normalises on device with the exact same
    fp32 op order, so the PIL path is bit-identical either way)."""
    from PIL import Image

    w, h = image.size
    scale = image_size / min(w, h)
    new_w, new_h = int(round(w * scale)), int(round(h * scale))
    image = image.resize((new_w, new_h), resample=Image.BICUBIC)
    left = (new_w - image_size) // 2
    top = (new_h - image_size) // 2
    image = image.crop((left, top, left + image_size, top + image_size))

    if raw_uint8:
        return np.asarray(image, dtype=np.uint8).transpose(2, 0, 1)
    arr = np.asarray(image, dtype=np.float32) / 255.0  # (H, W, 3)
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr.transpose(2, 0, 1)  # channel-first like the reference


def placeholder_pixels(image_size: int = 224,
                       raw_uint8: bool = False) -> np.ndarray:
    """Pixels for TEXT-ONLY samples (no image available, not a decode
    failure): float32 zeros are already-normalised zeros; the raw-uint8
    equivalent is the CLIP per-channel mean pixel, which device
    normalisation maps back to ~0 within one quantisation LSB — preserving
    the float32/uint8 pixel_transfer equivalence."""
    if raw_uint8:
        return np.broadcast_to(
            np.rint(CLIP_MEAN * 255.0).astype(np.uint8)[:, None, None],
            (3, image_size, image_size)).copy()
    return np.zeros((3, image_size, image_size), np.float32)


def gray_fallback(image_size: int = 224,
                  raw_uint8: bool = False) -> np.ndarray:
    """Synthetic mid-grey frame used when even the fallback file is absent."""
    if raw_uint8:
        return np.full((3, image_size, image_size), 128, dtype=np.uint8)
    arr = np.full((image_size, image_size, 3), 0.5, dtype=np.float32)
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr.transpose(2, 0, 1)


def decode_image_bytes(
    data: bytes,
    image_size: int = 224,
    fallback_path: Optional[str] = None,
    raw_uint8: bool = False,
) -> np.ndarray:
    """Serving-path twin of ``load_image``: decode + preprocess an in-memory
    request payload with the same bare-except fallback chain (corrupt bytes
    -> fallback image -> grey frame), so a bad upload degrades exactly like
    a corrupt file on disk does in training.
    """
    import io

    try:
        from PIL import Image
        img = Image.open(io.BytesIO(data)).convert("RGB")
        return preprocess_pil(img, image_size, raw_uint8=raw_uint8)
    except Exception:
        pass
    if fallback_path is not None and os.path.exists(fallback_path):
        try:
            return preprocess_pil(_load_pil(fallback_path), image_size,
                                  raw_uint8=raw_uint8)
        except Exception:
            pass
    return gray_fallback(image_size, raw_uint8=raw_uint8)


def load_image(
    path: str,
    image_size: int = 224,
    fallback_path: Optional[str] = None,
    use_native: bool = True,
    raw_uint8: bool = False,
) -> np.ndarray:
    """Decode + preprocess with the reference's bare-except fallback chain.

    Tries the GIL-free C loader first (``native/imagedec.c``, near-exact PIL
    semantics, float-precision resampling instead of PIL's fixed-point);
    any native failure falls through to PIL, then the fallback image, then a
    grey frame. ``raw_uint8`` emits resized/cropped uint8 pixels for
    device-side normalisation (see preprocess_pil).
    """
    if use_native:
        from d2r_tpu_torch.data.native_image import native_load_image
        out = native_load_image(path, image_size, raw_uint8=raw_uint8)
        if out is not None:
            return out
    try:
        return preprocess_pil(_load_pil(path), image_size, raw_uint8=raw_uint8)
    except Exception:
        pass
    if fallback_path is not None and os.path.exists(fallback_path):
        if use_native:
            from d2r_tpu_torch.data.native_image import native_load_image
            out = native_load_image(fallback_path, image_size,
                                    raw_uint8=raw_uint8)
            if out is not None:
                return out
        try:
            return preprocess_pil(_load_pil(fallback_path), image_size,
                                  raw_uint8=raw_uint8)
        except Exception:
            pass
    return gray_fallback(image_size, raw_uint8=raw_uint8)
