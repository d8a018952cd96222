"""Offline bulk scoring (counterpart of ``d2r_tpu/predict.py``):
checkpoint + JSON(L) of samples -> JSONL of predictions. The file-based twin
of the HTTP service (``server.py``) for batch jobs: it shares the training
tokenizer and image path (``data/dataset.py::encode_text``,
``data/image.py``) and the bucketed ``serve.Predictor``, so its
probabilities are the ones the HTTP service returns for the same inputs
in the same buckets.

Input formats (auto-detected):
  * JSONL: one ``{"id": ..., "text": ..., "image": optional filename or
    path}`` object per line;
  * a single JSON array of the same objects: the reference's MSD split
    format (``{id, text, emotion_label}``) is accepted as-is; ``id`` doubles
    as the image basename when ``--img_dir`` is given (``<id>.jpg``), and
    any label field is ignored.

Output: one JSONL line per input, in order:
  ``{"id": ..., "label": int, "probs": [...]}``

Run it as ``python -m d2r_tpu_torch.predict --load_path <best_model>
--input <file>`` (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Iterable, List, Optional

import numpy as np


def iter_samples(path: str) -> List[Dict]:
    """Read JSONL or a JSON array into a list of sample dicts."""
    # utf-8-sig: transparently strip a BOM; sniff the FIRST NON-WHITESPACE
    # character (however much whitespace precedes it) so '\n[' / ' [' array
    # files are not misparsed as JSONL.
    with open(path, "r", encoding="utf-8-sig") as f:
        first = ""
        while True:
            chunk = f.read(4096)
            stripped = chunk.lstrip()
            if stripped or not chunk:
                first = stripped[:1]
                break
        f.seek(0)
        if first == "[":
            samples = json.load(f)
            if not isinstance(samples, list):
                raise ValueError(f"{path}: JSON document is not an array")
            return samples
        out = []
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: bad JSON line: {e}") from e
        return out


def _resolve_image(sample: Dict, img_dir: Optional[str]) -> Optional[str]:
    """Image path for a sample: explicit 'image' field (absolute, or
    relative to --img_dir), else '<id>.jpg' under --img_dir (the reference's
    dataset convention, ref: processor/dataset.py:40-43)."""
    name = sample.get("image")
    if name:
        if os.path.isabs(name) or img_dir is None:
            return name
        return os.path.join(img_dir, name)
    if img_dir is not None and sample.get("id") is not None:
        return os.path.join(img_dir, f"{sample['id']}.jpg")
    return None


def score_samples(
    predictor,
    tokenizer,
    samples: Iterable[Dict],
    img_dir: Optional[str] = None,
    fallback_image: Optional[str] = None,
    raw_uint8: bool = True,
    chunk: int = 256,
) -> Iterable[Dict]:
    """Yield one result dict per sample, preserving order. Chunks the host
    preprocessing so arbitrarily large inputs stream with bounded memory;
    the Predictor further splits each chunk across its batch buckets."""
    from d2r_tpu_torch.data.dataset import encode_text
    from d2r_tpu_torch.data.image import decode_image_bytes, placeholder_pixels

    vc = predictor.cfg.vision_config()
    max_seq = predictor.seq_len
    samples = list(samples)
    for lo in range(0, len(samples), chunk):
        part = samples[lo:lo + chunk]
        ids_list, feats = [], {"input_ids": [], "attention_mask": [],
                               "token_type_ids": [], "pixel_values": []}
        for sample in part:
            text = sample.get("text")
            if not isinstance(text, str):
                raise ValueError(
                    f"sample {sample.get('id')!r} has no 'text' string")
            ids, mask, segs = encode_text(tokenizer, text, max_seq)
            img_path = _resolve_image(sample, img_dir)
            if img_path and os.path.exists(img_path):
                with open(img_path, "rb") as f:
                    pixels = decode_image_bytes(
                        f.read(), vc.image_size,
                        fallback_path=fallback_image, raw_uint8=raw_uint8)
            else:
                pixels = placeholder_pixels(vc.image_size, raw_uint8)
            ids_list.append(sample.get("id"))
            feats["input_ids"].append(ids)
            feats["attention_mask"].append(mask)
            feats["token_type_ids"].append(segs)
            feats["pixel_values"].append(pixels)
        out = predictor.predict(
            np.stack(feats["input_ids"]), np.stack(feats["attention_mask"]),
            np.stack(feats["token_type_ids"]), np.stack(feats["pixel_values"]))
        for i, sid in enumerate(ids_list):
            yield {"id": sid, "label": int(out["label"][i]),
                   "probs": [float(p) for p in out["probs"][i]]}


def main(argv=None) -> None:
    """``python -m d2r_tpu_torch.predict``: offline bulk scoring."""
    ap = argparse.ArgumentParser(
        description="Score a JSONL/JSON file of {id, text, image?} samples "
                    "with a d2r_tpu_torch checkpoint; writes JSONL predictions.")
    ap.add_argument("--load_path", required=True,
                    help="checkpoint dir (e.g. .../best_model, holding model.pth)")
    ap.add_argument("--input", required=True,
                    help="JSONL of {id,text,image?} or a JSON array "
                         "(the reference MSD split format works as-is)")
    ap.add_argument("--output", default="-",
                    help="output JSONL path ('-' = stdout)")
    ap.add_argument("--img_dir", default=None,
                    help="directory for relative image names / <id>.jpg")
    ap.add_argument("--fallback_image", default=None,
                    help="image used when a file exists but fails to decode "
                         "(the training inf.png convention)")
    ap.add_argument("--config_json", default=None)
    ap.add_argument("--vocab_file", default=None,
                    help="tokenizer assets (see the server's --vocab_file)")
    ap.add_argument("--batch_buckets", default="1,8,32")
    ap.add_argument("--quantize", default=None, choices=[None, "int8"])
    ap.add_argument("--chunk", type=int, default=256,
                    help="host-side preprocessing chunk (bounds memory)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from d2r_tpu_torch.config import resolve_device
    from d2r_tpu_torch.data.tokenizer import load_tokenizer
    from d2r_tpu_torch.serve import Predictor
    from d2r_tpu_torch.server import resolve_serve_config
    from d2r_tpu_torch.train.checkpoint import restore_model

    device = resolve_device(args.device)
    cfg = resolve_serve_config(args.load_path, config_json=args.config_json)
    tokenizer = load_tokenizer(args.vocab_file or cfg.bert_name,
                               vocab_size=cfg.text_config().vocab_size)
    predictor = Predictor(
        cfg, restore_model(args.load_path, cfg, device), device=device,
        quantize=args.quantize,
        batch_buckets=tuple(int(b) for b in args.batch_buckets.split(",")))

    samples = iter_samples(args.input)
    sink = sys.stdout if args.output == "-" else open(
        args.output, "w", encoding="utf-8")
    try:
        n = 0
        for rec in score_samples(
                predictor, tokenizer, samples, img_dir=args.img_dir,
                fallback_image=args.fallback_image, chunk=args.chunk):
            sink.write(json.dumps(rec) + "\n")
            n += 1
        print(json.dumps({"scored": n, "input": args.input,
                          "output": args.output}), file=sys.stderr)
    finally:
        if sink is not sys.stdout:
            sink.close()


if __name__ == "__main__":
    main()
