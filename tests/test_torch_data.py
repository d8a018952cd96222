"""The port's data pipeline against the JAX package's, on the CPU.

- Tokenizers: on ASCII, accented and CJK text, WordPiece over a tmp
  ``vocab.txt`` (the native C path and the Python path), the hash fallback,
  and byte-level BPE over a tmp ``vocab.json`` + ``merges.txt`` give the
  JAX package's ids, and ``encode_text`` its arrays.
- ``write_fake_dataset`` writes the same files.
- ``DataLoader`` over one such dataset, with corrupt images: three shuffled
  epochs (pinned by ``set_epoch``), the wrapped last batch and its
  ``valid``, uint8 and float32 pixels, ``sample_ratio``, ``cache_items`` and
  the text-only path; every array equal bit for bit.
- ``synthetic_batch`` and the image fallbacks (PIL path, fallback file,
  grey frame, text-only placeholder) equal bit for bit.
"""

import json
import os
import random

import numpy as np
import pytest

from d2r_tpu.data import bpe as jbpe
from d2r_tpu.data import dataset as jdata
from d2r_tpu.data import image as jimage
from d2r_tpu.data import tokenizer as jtok
from d2r_tpu_torch.data import bpe as tbpe
from d2r_tpu_torch.data import dataset as tdata
from d2r_tpu_torch.data import image as timage
from d2r_tpu_torch.data import native_text as tnative_text
from d2r_tpu_torch.data import tokenizer as ttok

TEXTS = [
    "Hello, world! It's a sunny day...",
    "the   QUICK brown\tfox -- jumps over 12345 lazy dogs",
    "Café naïve résumé Ťhé déjà-vu",
    "我爱北京天安门 and 東京 too",
    "mixed 中文 with accents é and emoji \U0001f600!",
    "",
    "unaffable unwanted running runner",
]
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", ",", "world", "!",
         "it", "'", "s", "a", "sun", "##ny", "day", ".", "the", "quick", "brown", "fox",
         "-", "jump", "##s", "over", "123", "##45", "lazy", "dog", "cafe", "naive",
         "resume", "th", "##e", "deja", "v", "##u", "我", "爱", "北", "京", "and", "東",
         "too", "mixed", "中", "文", "with", "accent", "e", "un", "##aff", "##able",
         "##want", "##ed", "run", "##ning", "##ner"]
SPECIALS = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, "<mask>": 4}
MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("l", "l"), ("Ġ", "a"), ("i", "n"),
          ("Ġa", "nd"), ("n", "d"), ("e", "r"), ("Ġ", "w"), ("o", "r"), ("Ġw", "or"),
          ("1", "2"), ("12", "3"), ("'", "s"), ("!", "!"), (".", "."), ("Ġ", "Ġ")]


def _fuzz(n=60, seed=3):
    rng = random.Random(seed)
    words = TEXTS[0].split() + TEXTS[2].split() + TEXTS[3].split() + ["don't", "\U0001f600"]
    return TEXTS + [rng.choice(["", " "]).join(rng.choice(words) for _ in range(rng.randint(1, 9)))
                    for _ in range(n)]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("wp") / "vocab.txt"
    path.write_text("\n".join(WORDS) + "\n", encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module")
def bpe_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("bpe")
    vocab = dict(SPECIALS)
    for ch in jbpe.bytes_to_unicode().values():
        vocab.setdefault(ch, len(vocab))
    for a, b in MERGES:
        vocab.setdefault(a + b, len(vocab))
    (root / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (root / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES) + "\n", encoding="utf-8")
    return str(root)


def _ids(tok, texts, max_seq=24):
    out = []
    for t in texts:
        out.append(tok.encode_ids(t, max_seq - 2) if hasattr(tok, "encode_ids")
                   else tok.convert_tokens_to_ids(tok.tokenize(t)))
    return out


def test_wordpiece_native_and_python_paths_match_jax(vocab_file):
    jt = jtok.BertTokenizer.from_vocab_file(vocab_file)
    tt = ttok.BertTokenizer.from_vocab_file(vocab_file)
    assert tt._native_handle is not None          # the C path serves ASCII text
    texts = _fuzz()
    ref = _ids(jt, texts)
    assert _ids(tt, texts) == ref
    python_path = [tt.convert_tokens_to_ids(tt.tokenize(t))[:22] for t in texts]
    assert python_path == ref
    assert [tt.tokenize(t) for t in texts] == [jt.tokenize(t) for t in texts]
    ascii_ids = [tnative_text.native_encode(tt._native_handle, t, 22) for t in texts if t.isascii()]
    assert ascii_ids == [r for t, r in zip(texts, ref) if t.isascii()]
    assert any(1 in r for r in ref)                # [UNK] is reached


def test_hash_and_bpe_tokenizers_match_jax(bpe_dir):
    texts = _fuzz()
    jh, th = jtok.load_tokenizer("tiny-bert", vocab_size=128), ttok.load_tokenizer(
        "tiny-bert", vocab_size=128)
    assert isinstance(th, ttok.HashTokenizer)
    assert _ids(th, texts) == _ids(jh, texts)
    jb, tb = jtok.load_tokenizer(bpe_dir), ttok.load_tokenizer(bpe_dir)
    assert isinstance(tb, tbpe.RobertaBPETokenizer)
    assert [tb.tokenize(t) for t in texts] == [jb.tokenize(t) for t in texts]
    assert _ids(tb, texts) == _ids(jb, texts)
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer("tiny-bert", allow_hash_fallback=False)


@pytest.mark.parametrize("kind", ["wordpiece", "hash", "bpe"])
def test_encode_text_matches_jax(kind, vocab_file, bpe_dir):
    name = {"wordpiece": os.path.dirname(vocab_file), "hash": "tiny-bert", "bpe": bpe_dir}[kind]
    jt, tt = jtok.load_tokenizer(name, vocab_size=128), ttok.load_tokenizer(name, vocab_size=128)
    for text in _fuzz(20):
        for got, ref in zip(tdata.encode_text(tt, text, 16), jdata.encode_text(jt, text, 16)):
            assert got.dtype == ref.dtype and np.array_equal(got, ref), text


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    """One fabricated dataset (written by the JAX package) of 10 posts with
    40-pixel JPEGs, every third file corrupt."""
    root = tmp_path_factory.mktemp("fake")
    return jdata.write_fake_dataset(str(root), n=10, image_size=40, corrupt_every=3)


def test_write_fake_dataset_writes_the_jax_files(fake, tmp_path):
    ours = tdata.write_fake_dataset(str(tmp_path), n=10, image_size=40, corrupt_every=3)
    for key in ("train", "dev", "test"):
        assert open(ours[key], "rb").read() == open(fake[key], "rb").read()
    names = sorted(os.listdir(fake["img_dir"]))
    assert names == sorted(os.listdir(ours["img_dir"]))
    for name in names:
        a = open(os.path.join(fake["img_dir"], name), "rb").read()
        assert a == open(os.path.join(ours["img_dir"], name), "rb").read(), name


LOADERS = {
    "uint8": {},
    "float32": {"pixel_transfer": "float32"},
    "sample_ratio": {"sample_ratio": 0.75},
    "cache_items": {"cache_items": True},
    "text_only": {"img_path": None},
}


@pytest.mark.parametrize("case", list(LOADERS))
def test_loader_batches_equal_jax_bit_for_bit(case, fake):
    """Three shuffled epochs, batch 4 over 10 posts (7 with sample_ratio):
    the last batch of each epoch wraps around with valid=False rows."""
    kw = {"img_path": fake["img_dir"], "pixel_transfer": "uint8", **LOADERS[case]}
    loaders = []
    for pkg in (jdata, tdata):
        proc = pkg.MSDProcessor({k: fake[k] for k in ("train", "dev", "test")}, "tiny-bert",
                                vocab_size=128)
        ds = pkg.MSDDataset(proc, kw["img_path"], max_seq=16, mode="train", image_size=32,
                            num_vision_tokens=5, sample_ratio=kw.get("sample_ratio", 1.0),
                            pixel_transfer=kw["pixel_transfer"],
                            cache_items=kw.get("cache_items", False))
        loaders.append(pkg.DataLoader(ds, 4, shuffle=True, num_workers=3, seed=11))
    jl, tl = loaders
    assert len(tl) == len(jl)
    wrapped = 0
    for epoch in (1, 2, 3):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jbatches, tbatches = list(jl), list(tl)
        assert len(tbatches) == len(jbatches) == len(jl)
        for jb, tb in zip(jbatches, tbatches):
            assert set(tb) == set(jb)
            for key in jb:
                assert tb[key].dtype == jb[key].dtype, key
                assert np.array_equal(tb[key], jb[key]), (epoch, key)
            wrapped += int((~tb["valid"]).sum())
    assert wrapped > 0
    pixels = tbatches[0]["pixel_values"]
    assert pixels.dtype == (np.float32 if kw["pixel_transfer"] == "float32" else np.uint8)


def test_corrupt_images_take_the_fallback_chain(fake, tmp_path):
    """A corrupt file decodes to inf.png (128 everywhere); without inf.png,
    to the grey frame; both packages alike, native C and PIL paths."""
    corrupt = os.path.join(fake["img_dir"], "s0.jpg")
    good = os.path.join(fake["img_dir"], "s1.jpg")
    inf = os.path.join(fake["img_dir"], "inf.png")
    for raw in (True, False):
        for native in (True, False):
            for path, fb in ((corrupt, inf), (corrupt, None), (good, inf)):
                got = timage.load_image(path, 32, fb, use_native=native, raw_uint8=raw)
                ref = jimage.load_image(path, 32, fb, use_native=native, raw_uint8=raw)
                assert got.dtype == ref.dtype and np.array_equal(got, ref), (path, fb, raw, native)
        if raw:   # inf.png is the 128 frame, the grey frame's raw pixels
            assert np.array_equal(timage.load_image(corrupt, 32, inf, raw_uint8=True),
                                  timage.gray_fallback(32, True))
        assert np.array_equal(timage.placeholder_pixels(32, raw), jimage.placeholder_pixels(32, raw))
        data = open(good, "rb").read()
        assert np.array_equal(timage.decode_image_bytes(data, 32, raw_uint8=raw),
                              jimage.decode_image_bytes(data, 32, raw_uint8=raw))
        assert np.array_equal(timage.decode_image_bytes(b"junk", 32, raw_uint8=raw),
                              timage.gray_fallback(32, raw))
    assert (timage.load_image(good, 32, inf, raw_uint8=True) != 128).any()
    assert np.array_equal(timage.CLIP_MEAN, jimage.CLIP_MEAN)
    assert np.array_equal(timage.CLIP_STD, jimage.CLIP_STD)


def test_synthetic_batch_matches_jax():
    got = tdata.synthetic_batch(5, 16, 32, vocab_size=128, seed=4)
    ref = jdata.synthetic_batch(5, 16, 32, vocab_size=128, seed=4)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype and np.array_equal(got[key], ref[key]), key
