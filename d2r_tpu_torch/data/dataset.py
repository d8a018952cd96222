"""Host-side data pipeline (counterpart of ``d2r_tpu/data/dataset.py``).

JSON split files of ``{id, text, emotion_label}`` records, image file
``id + '.jpg'``, BERT tokenisation truncated to max_seq-2 then wrapped in
[CLS]/[SEP] and padded, CLIP image preprocessing with the corrupt-image
fallback, and the vestigial ``img_mask`` field. Batches are dicts of numpy
arrays, as the JAX package yields them; the trainer moves them to the device.

As in the JAX package: text pads to ``max_seq``, and the final partial batch
pads by wrapping around to the start of the epoch, with a ``valid`` mask, so
every batch has one shape; metrics count only valid rows. Decoding runs in a
thread pool with batch-ahead prefetch.

Given a SenticNet lexicon (``data/sentic.py``), each item also carries
``sentic_adj``, its (max_seq, max_seq) fp32 affective adjacency, which the
loader stacks. Not here: the multi-host ``process_shard`` (the port has no
multi-process trainer).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from d2r_tpu_torch.data.image import load_image, placeholder_pixels
from d2r_tpu_torch.data.sentic import batched_affective_adjacency
from d2r_tpu_torch.data.tokenizer import load_tokenizer


def encode_text(tokenizer, text: str, max_seq: int):
    """Tokenize exactly like training: truncate to max_seq-2, wrap in
    [CLS]/[SEP], pad with the tokenizer's PAD id (WordPiece's [PAD] is 0;
    RoBERTa's <pad> is 1, and padding with 0 would embed the <s> row at
    every pad slot, which the Router's pad-mean-pooling would then feed into
    the routing gates). Returns (input_ids, attention_mask, token_type_ids)
    int32 arrays of length ``max_seq``."""
    if hasattr(tokenizer, "encode_ids"):
        # single-call path (native C for ASCII text when built,
        # tokenizer.py::BertTokenizer.encode_ids): the same ids as the
        # tokenize->truncate->convert sequence below
        body = tokenizer.encode_ids(text, max_seq - 2)
    else:
        tokens = tokenizer.tokenize(text)
        if len(tokens) > max_seq - 2:
            tokens = tokens[: max_seq - 2]
        body = tokenizer.convert_tokens_to_ids(tokens)
    ids = [tokenizer.cls_token_id] + body + [tokenizer.sep_token_id]
    n = len(ids)
    input_ids = np.full(max_seq, getattr(tokenizer, "pad_token_id", 0),
                        np.int32)
    input_ids[:n] = ids
    attention_mask = np.zeros(max_seq, np.int32)
    attention_mask[:n] = 1
    token_type_ids = np.zeros(max_seq, np.int32)
    return input_ids, attention_mask, token_type_ids


class MSDProcessor:
    """Split-file loader and tokenizer owner."""

    def __init__(self, data_path: Dict[str, str], bert_name: str,
                 vocab_size: int = 30522, allow_hash_fallback: bool = True):
        self.data_path = data_path
        self.tokenizer = load_tokenizer(bert_name, vocab_size=vocab_size,
                                        allow_hash_fallback=allow_hash_fallback)

    def load_from_file(self, mode: str = "train") -> Dict[str, list]:
        with open(self.data_path[mode], encoding="utf-8") as f:
            records = json.load(f)
        texts, labels, imgs = [], [], []
        for sample in records:
            texts.append(sample["text"])
            labels.append(int(sample["emotion_label"]))
            imgs.append(str(sample["id"]) + ".jpg")
        assert len(texts) == len(labels) == len(imgs)
        return {"texts": texts, "labels": labels, "imgs": imgs}


class MSDDataset:
    """Per-item transform."""

    def __init__(
        self,
        processor: MSDProcessor,
        img_path: Optional[str],
        max_seq: int = 128,
        mode: str = "train",
        image_size: int = 224,
        num_vision_tokens: int = 50,
        sample_ratio: float = 1.0,
        pixel_transfer: str = "float32",
        cache_items: bool = False,
        sentic_lexicon: Optional[Dict[str, float]] = None,
    ):
        self.processor = processor
        self.tokenizer = processor.tokenizer
        self.img_path = img_path
        self.max_seq = max_seq
        self.image_size = image_size
        self.num_vision_tokens = num_vision_tokens
        self.sentic_lexicon = sentic_lexicon  # word -> polarity, or None
        # 'uint8' ships RAW resized pixels (4x fewer host->device bytes);
        # CLIPVisionEmbeddings normalises on device (models/vit.py).
        assert pixel_transfer in ("float32", "uint8"), pixel_transfer
        self.pixel_transfer = pixel_transfer
        self.data = processor.load_from_file(mode)
        if sample_ratio < 1.0:  # low-resource subsetting
            n = max(1, int(len(self.data["texts"]) * sample_ratio))
            self.data = {k: v[:n] for k, v in self.data.items()}
        # the reference's fallback image for undecodable files
        self.fallback = os.path.join(img_path, "inf.png") if img_path else None
        # --cache_items: memoise finished items. Every transform here is
        # deterministic per index (tokenise, decode+resize, sentic graph), so
        # epochs >= 2 skip all host work. Opt-in because pixels dominate the footprint
        # (~image_size^2*3 bytes/item raw-uint8, 4x that for float32
        # transfer); _cache_footprint() logs the projection after the first
        # item. Thread-safe under the loader's thread pool: worst case two
        # workers build the same item and one write wins (identical values).
        self._cache: Optional[Dict[int, Dict[str, np.ndarray]]] = (
            {} if cache_items else None)

    def __len__(self) -> int:
        return len(self.data["texts"])

    def cache_footprint_bytes(self) -> Optional[int]:
        """Projected full-cache size (None until one item is cached)."""
        if not self._cache:
            return None
        item = next(iter(self._cache.values()))
        per = sum(a.nbytes for a in item.values() if hasattr(a, "nbytes"))
        return per * len(self)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self._cache is not None:
            hit = self._cache.get(idx)
            if hit is not None:
                return hit
        item = self._build_item(idx)
        if self._cache is not None:
            first = not self._cache
            self._cache[idx] = item
            if first:
                import logging
                logging.getLogger(__name__).info(
                    "cache_items: projected full-cache footprint ~%.1f MiB "
                    "(%d items)",
                    (self.cache_footprint_bytes() or 0) / 2**20, len(self))
        return item

    def _build_item(self, idx: int) -> Dict[str, np.ndarray]:
        text = self.data["texts"][idx]
        label = self.data["labels"][idx]
        img = self.data["imgs"][idx]

        input_ids, attention_mask, token_type_ids = encode_text(
            self.tokenizer, text, self.max_seq)

        raw_u8 = self.pixel_transfer == "uint8"
        if self.img_path is not None:
            pixel_values = load_image(
                os.path.join(self.img_path, img),
                image_size=self.image_size,
                fallback_path=self.fallback,
                raw_uint8=raw_u8)
        else:
            # Text-only runs (img_path=None): see placeholder_pixels for why
            # the uint8 placeholder is the CLIP mean pixel, not raw zeros.
            pixel_values = placeholder_pixels(self.image_size, raw_u8)

        item = {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": token_type_ids,
            # vestigial, kept for the JAX package's batch layout
            "img_mask": np.ones(self.num_vision_tokens, np.int32),
            "labels": np.int32(label),
            "pixel_values": (pixel_values if raw_u8
                             else pixel_values.astype(np.float32)),
        }
        if self.sentic_lexicon is not None:
            item["sentic_adj"] = batched_affective_adjacency(
                [text], self.sentic_lexicon, self.max_seq)[0]
        return item


class DataLoader:
    """Batched iterator with threaded decode + one-batch-ahead prefetch.

    Yields dicts of stacked numpy arrays with a ``valid`` mask; the final
    partial batch wraps around so every batch has identical static shape.
    """

    def __init__(
        self,
        dataset: MSDDataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 8,
        seed: int = 2023,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def set_epoch(self, n: int) -> None:
        """Pin the shuffle stream: the NEXT ``__iter__`` shuffles with
        ``seed + n``. Each ``__iter__`` still increments the counter, but
        the trainer calls ``set_epoch(epoch)`` at the top of EVERY epoch
        (see Trainer.train), so epoch k always shuffles with ``seed + k``
        however many iterations ran before, which is also what makes
        auto-resume continue the exact order."""
        self._epoch = int(n)

    def _index_batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        batches = []
        for start in range(0, n, self.batch_size):
            idx = order[start: start + self.batch_size]
            if len(idx) < self.batch_size:
                pad = order[: self.batch_size - len(idx)]  # wrap-around pad
                valid = np.concatenate([np.ones(len(idx), bool),
                                        np.zeros(len(pad), bool)])
                idx = np.concatenate([idx, pad])
            else:
                valid = np.ones(self.batch_size, bool)
            batches.append((idx, valid))
        return batches

    PREFETCH_BATCHES = 2

    @staticmethod
    def _collate(item_futs, valid: np.ndarray) -> Dict[str, np.ndarray]:
        items = [f.result() for f in item_futs]
        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        batch["valid"] = valid
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._index_batches()
        self._epoch += 1
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            # item-level futures with a fixed batch-ahead window; workers only
            # ever run __getitem__, so no nested-pool deadlock is possible
            window: list = []
            it = iter(batches)
            def submit_next():
                try:
                    idx, valid = next(it)
                except StopIteration:
                    return False
                window.append(([pool.submit(self.dataset.__getitem__, int(i))
                                for i in idx], valid))
                return True

            for _ in range(self.PREFETCH_BATCHES):
                submit_next()
            while window:
                futs, valid = window.pop(0)
                submit_next()
                yield self._collate(futs, valid)


def synthetic_batch(
    batch_size: int,
    max_seq: int,
    image_size: int,
    num_classes: int = 3,
    vocab_size: int = 30522,
    num_vision_tokens: int = 50,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Deterministic fake batch for tests and benchmarks (no files needed)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, max_seq + 1, size=batch_size)
    input_ids = rng.integers(5, vocab_size, size=(batch_size, max_seq)).astype(np.int32)
    attention_mask = (np.arange(max_seq)[None, :] < lengths[:, None]).astype(np.int32)
    input_ids *= attention_mask
    input_ids[:, 0] = 2  # [CLS]
    return {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "token_type_ids": np.zeros((batch_size, max_seq), np.int32),
        "img_mask": np.ones((batch_size, num_vision_tokens), np.int32),
        "labels": rng.integers(0, num_classes, size=batch_size).astype(np.int32),
        "pixel_values": rng.normal(size=(batch_size, 3, image_size, image_size)
                                   ).astype(np.float32),
        "valid": np.ones(batch_size, bool),
    }


def write_fake_dataset(root: str, n: int = 8, image_size: int = 32,
                       seed: int = 0, corrupt_every: int = 0) -> Dict[str, str]:
    """Write a small on-disk dataset (JSON + JPEGs) for end-to-end runs.

    ``corrupt_every > 0`` writes every k-th image as garbage bytes to
    exercise the inf.png fallback path. Returns the data_path dict expected
    by MSDProcessor, plus ``img_dir``. The same files as the JAX package's
    ``write_fake_dataset`` for the same arguments.
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    words = ["happy", "sad", "great", "awful", "sunny", "rain", "love", "hate"]
    records = []
    for i in range(n):
        text = " ".join(rng.choice(words, size=rng.integers(3, 8)))
        records.append({"id": f"s{i}", "text": text,
                        "emotion_label": int(rng.integers(0, 3))})
        path = os.path.join(img_dir, f"s{i}.jpg")
        if corrupt_every and i % corrupt_every == 0:
            with open(path, "wb") as f:
                f.write(b"not an image")
        else:
            arr = rng.integers(0, 256, size=(image_size, image_size, 3)).astype(np.uint8)
            Image.fromarray(arr).save(path)
    # fallback image (the reference's inf.png)
    Image.fromarray(np.full((image_size, image_size, 3), 128, np.uint8)).save(
        os.path.join(img_dir, "inf.png"))

    paths = {}
    for mode in ("train", "dev", "test"):
        p = os.path.join(root, f"{mode}.json")
        with open(p, "w", encoding="utf-8") as f:
            json.dump(records, f)
        paths[mode] = p
    paths["img_dir"] = img_dir
    return paths
