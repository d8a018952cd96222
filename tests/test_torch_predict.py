"""The port's bulk scorer (``d2r_tpu_torch/predict.py``) on the CPU: input
parsing and image resolution as in ``tests/test_predict_cli.py``,
``score_samples`` against the JAX package's over the same JSONL and JSON
array files on the same weights (probabilities within 1e-4, in order), and
``python -m d2r_tpu_torch.predict`` end to end, with and without int8."""

import functools
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from d2r_tpu.config import tiny_test_config as jax_tiny_config
from d2r_tpu.data.tokenizer import load_tokenizer as jax_load_tokenizer
from d2r_tpu.predict import score_samples as jax_score_samples
from d2r_tpu.serve import Predictor as JaxPredictor
from d2r_tpu_torch.config import tiny_test_config
from d2r_tpu_torch.data.tokenizer import load_tokenizer
from d2r_tpu_torch.predict import _resolve_image, iter_samples, main, score_samples
from d2r_tpu_torch.serve import Predictor
from d2r_tpu_torch.weights import from_jax_variables
from tests.test_torch_serve import tiny_checkpoint, tiny_tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- input parsing
def test_iter_samples_jsonl_and_array(tmp_path):
    rows = [{"id": "a", "text": "hi"}, {"id": "b", "text": "yo"}]
    jl = tmp_path / "in.jsonl"
    jl.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    arr = tmp_path / "in.json"
    arr.write_text(json.dumps(rows))
    assert iter_samples(str(jl)) == rows
    assert iter_samples(str(arr)) == rows


@pytest.mark.parametrize("raw", [
    b"\n  [{\"id\": \"a\", \"text\": \"hi\"}]",
    b" " * 8192 + b"\n[{\"id\": \"a\", \"text\": \"hi\"}]",
    b"\xef\xbb\xbf[{\"id\": \"a\", \"text\": \"hi\"}]",
    b"\xef\xbb\xbf{\"id\": \"a\", \"text\": \"hi\"}\n"],
    ids=["leading-whitespace", "deep-whitespace", "bom-array", "bom-jsonl"])
def test_iter_samples_sniffs_past_whitespace_and_bom(tmp_path, raw):
    p = tmp_path / "in.json"
    p.write_bytes(raw)
    assert iter_samples(str(p)) == [{"id": "a", "text": "hi"}]


def test_iter_samples_reports_bad_line(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"id": 1, "text": "x"}\nnot json\n')
    with pytest.raises(ValueError, match="bad.jsonl:2"):
        iter_samples(str(p))


def test_resolve_image_precedence(tmp_path):
    d = str(tmp_path)
    assert _resolve_image({"image": "/abs/x.png"}, d) == "/abs/x.png"
    assert _resolve_image({"image": "rel.png"}, d) == os.path.join(d, "rel.png")
    assert _resolve_image({"image": "rel.png"}, None) == "rel.png"
    assert _resolve_image({"id": "42"}, d) == os.path.join(d, "42.jpg")
    assert _resolve_image({"id": "42"}, None) is None


# ------------------------------------------------------------ scoring
ROWS = [
    {"id": "s1", "text": "a happy picture"},                           # <id>.jpg found
    {"id": "s2", "text": "text only sample"},                          # placeholder
    {"id": "s3", "text": "explicit missing image", "image": "nope.jpg"},
    {"id": "s4", "text": "a broken file", "image": "broken.jpg"},      # decode fallback
    {"id": "s5", "text": "reference format", "emotion_label": 2},      # label ignored
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    img_dir = root / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for name in ("s1", "s5"):
        Image.fromarray(rng.integers(0, 255, size=(40, 36, 3), dtype=np.uint8)).save(
            img_dir / f"{name}.jpg")
    (img_dir / "broken.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    (root / "in.jsonl").write_text("\n".join(json.dumps(r) for r in ROWS) + "\n")
    (root / "in.json").write_text(json.dumps(ROWS))
    return {"root": root, "img_dir": str(img_dir), "load": tiny_checkpoint(root / "ckpt")}


@functools.lru_cache(maxsize=None)
def _jax_predictor():
    return JaxPredictor(jax_tiny_config(), tiny_tree(), batch_buckets=(4,))


def _port_predictor(quantize=None):
    cfg = tiny_test_config()
    return Predictor(cfg, from_jax_variables(cfg, tiny_tree()), batch_buckets=(4,),
                     device="cpu", quantize=quantize)


@pytest.mark.parametrize("name", ["in.jsonl", "in.json"])
def test_score_samples_matches_jax(files, name):
    """Five samples in chunks of 3 (4 + 1 rows through bucket 4)."""
    samples = iter_samples(str(files["root"] / name))
    cfg, jcfg = tiny_test_config(), jax_tiny_config()
    got = list(score_samples(_port_predictor(), load_tokenizer(
        cfg.bert_name, vocab_size=cfg.text_config().vocab_size), samples,
        img_dir=files["img_dir"], chunk=3))
    ref = list(jax_score_samples(_jax_predictor(), jax_load_tokenizer(
        jcfg.bert_name, vocab_size=jcfg.text_config().vocab_size), samples,
        img_dir=files["img_dir"], chunk=3))
    assert [g["id"] for g in got] == [r["id"] for r in ref] == [r["id"] for r in ROWS]
    assert [g["label"] for g in got] == [r["label"] for r in ref]
    np.testing.assert_allclose([g["probs"] for g in got], [r["probs"] for r in ref],
                               atol=1e-4, rtol=0)


def test_score_samples_requires_text():
    with pytest.raises(ValueError, match="no 'text' string"):
        list(score_samples(_port_predictor(), load_tokenizer("tiny-bert"), [{"id": 1}]))


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_main_scores_a_file_like_score_samples(files, tmp_path, capsys, quantize):
    """``main`` with ``--device cpu`` writes one JSONL line a sample, in
    order, prints the ``scored`` line to stderr, and gives what
    ``score_samples`` gives on a Predictor built directly."""
    out = tmp_path / "out.jsonl"
    main(["--load_path", files["load"], "--input", str(files["root"] / "in.jsonl"),
          "--output", str(out), "--img_dir", files["img_dir"], "--batch_buckets", "4",
          "--device", "cpu"] + (["--quantize", quantize] if quantize else []))
    got = [json.loads(line) for line in out.read_text().splitlines()]
    assert json.loads(capsys.readouterr().err.strip().splitlines()[-1])["scored"] == len(ROWS)
    cfg = tiny_test_config()
    want = list(score_samples(_port_predictor(quantize), load_tokenizer(
        cfg.bert_name, vocab_size=cfg.text_config().vocab_size), ROWS,
        img_dir=files["img_dir"]))
    assert [g["id"] for g in got] == [w["id"] for w in want]
    assert [g["label"] for g in got] == [w["label"] for w in want]
    np.testing.assert_allclose([g["probs"] for g in got], [w["probs"] for w in want],
                               atol=1e-6, rtol=0)
