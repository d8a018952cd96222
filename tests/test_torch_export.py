"""The port's serving export (``d2r_tpu_torch/export.py``) and reference
checkpoint export (``d2r_tpu_torch/utils/export_torch.py``) on the CPU,
held to the JAX package's (``d2r_tpu/export.py``,
``d2r_tpu/utils/export_torch.py``) as ``tests/test_export.py`` holds those.

The CLI writes the module's one fp32 artifact (buckets (1, 4), float32
pixels, ``tiny_test_config``, the checkpoint of ``tiny_tree(0)``); the int8
test writes its own at bucket 4. Tolerances: the loaded program against
the live ``Predictor`` within 1e-6 with equal labels (the JAX package's
bound; the program runs the same ATen operations, and the largest
difference seen is 0); against the JAX package's artifact of the same tree
within 1e-4 in fp32 (``tests/test_torch_serve.py``'s bound for the two
predictors); int8 against dense within 0.05 (``tests/test_export.py``'s).

``torch.export.save`` and ``load`` of one tiny program take seconds on this
CPU (the JSON schema decode), so the tests share the artifact, one loaded
predictor and one loaded bucket-4 program.

On the CPU a program holds the plain attention; the programs exported on
the card, with K1 and K3 as custom ops, are tested in
``tests/test_torch_cuda.py``. Here the ops' fake implementations are run
under ``FakeTensorMode`` against the plain versions' outputs.
"""

import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from d2r_tpu.config import tiny_test_config as jax_tiny_config
from d2r_tpu.data.dataset import synthetic_batch
from d2r_tpu.export import export_predictor as jax_export_predictor
from d2r_tpu.export import load_exported as jax_load_exported
from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu.utils.export_torch import reference_state_dict as jax_reference_state_dict
from d2r_tpu_torch import export as texport
from d2r_tpu_torch.config import load_config_json, tiny_test_config
from d2r_tpu_torch.models.unimo import build_model
from d2r_tpu_torch.ops.kernels import flash_attention as tfl
from d2r_tpu_torch.ops.kernels import fused_attention as tfa
from d2r_tpu_torch.serve import Predictor
from d2r_tpu_torch.utils.export_torch import reference_state_dict
from d2r_tpu_torch.weights import from_jax_variables, to_jax_variables
from tests.test_torch_model import INPUTS, random_variables
from tests.test_torch_serve import tiny_checkpoint, tiny_tree

KEYS = ("input_ids", "attention_mask", "token_type_ids", "pixel_values")
BUCKETS = (1, 4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _request():
    cfg = tiny_test_config()
    b = synthetic_batch(4, cfg.max_seq, cfg.vision_config().image_size,
                        vocab_size=cfg.text_config().vocab_size, seed=3)
    return tuple(b[k][:3] for k in KEYS)      # 3 rows into the 4-bucket


def _model(seed=0):
    return from_jax_variables(tiny_test_config(), tiny_tree(seed))


def _live(seed=0, quantize=None):
    return Predictor(tiny_test_config(), _model(seed), batch_buckets=BUCKETS, device="cpu",
                     quantize=quantize)


def _main(argv):
    """``export.main(argv)``; the JSON line it prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        texport.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The module's fp32 artifact, written by the CLI from the checkpoint of
    ``tiny_tree(0)``; its self-check has held the reloaded bucket-1 program
    to the live forward. Returns (artifact dir, manifest, the CLI's JSON
    line)."""
    root = tmp_path_factory.mktemp("export")
    out = os.path.join(str(root), "out")
    line = _main(["--load_path", tiny_checkpoint(root), "--out_dir", out, "--device", "cpu",
                  "--batch_buckets", "1,4", "--pixel", "float32"])
    with open(os.path.join(out, "manifest.json")) as f:
        return out, json.load(f), line


@pytest.fixture(scope="module")
def loaded(artifact):
    """The artifact loaded with seed 0's weights; the first test that
    predicts reads its bucket-4 program from disk."""
    return texport.load_exported(artifact[0], _model(), device="cpu")


@pytest.fixture(scope="module")
def program4(loaded):
    """The bucket-4 program as ``torch.export.load`` read it for ``loaded``."""
    loaded._program(4)
    return loaded.programs[4]


def test_cli_prints_the_jax_keys(artifact):
    out_dir, _, line = artifact
    assert line == {"out_dir": out_dir, "buckets": [1, 4], "platforms": ["cpu"],
                    "quantize": None, "self_check": "ok"}


def test_exported_matches_predictor_through_bucket_plumbing(loaded):
    """3 rows into the 4-bucket: the exported program pads, strips and
    agrees with the live model."""
    assert loaded.model is None
    want, got = _live().predict(*_request()), loaded.predict(*_request())
    assert got["probs"].shape == (3, 3)
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-6, rtol=0)


def test_exported_matches_the_jax_artifact(loaded, tmp_path):
    """The same seeded Flax tree exported through both packages: the loaded
    artifacts agree within 1e-4 in fp32, labels equal."""
    jout = str(tmp_path / "jax")
    jax_export_predictor(jax_tiny_config(), tiny_tree(0), jout, batch_buckets=BUCKETS,
                         pixel_dtype=jnp.float32, self_check=False)
    want = jax_load_exported(jout, tiny_tree(0)).predict(*_request())
    got = loaded.predict(*_request())
    np.testing.assert_array_equal(got["label"], np.asarray(want["label"]))
    np.testing.assert_allclose(got["probs"], np.asarray(want["probs"], np.float32),
                               atol=1e-4, rtol=0)


def test_exported_rejects_wrong_pixel_dtype(loaded):
    ids, mask, tt, pix = _request()
    with pytest.raises(ValueError, match="pixel dtype"):
        loaded.predict(ids, mask, tt, pix.astype(np.uint8))


def _edited(artifact, tmp_path, **changes):
    """A copy of the artifact whose manifest has ``changes``."""
    out = str(tmp_path / "edited")
    shutil.copytree(artifact[0], out)
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump({**artifact[1], **changes}, f)
    return out


def test_exported_rejects_unknown_manifest_version(artifact, tmp_path):
    with pytest.raises(ValueError, match="manifest version"):
        texport.load_exported(_edited(artifact, tmp_path, version=999), _model(), device="cpu")


def test_cpu_loader_refuses_an_artifact_with_only_a_cuda_program(artifact, tmp_path):
    out = _edited(artifact, tmp_path, platforms=["cuda"],
                  files={b: {"cuda": f["cpu"]} for b, f in artifact[1]["files"].items()})
    with pytest.raises(ValueError, match=r"none for cpu"):
        texport.load_exported(out, _model(), device="cpu")


def test_exported_rejects_wrong_geometry_weights(program4):
    """The tensors of a model of another geometry (the router twice as
    wide) raise at call time instead of serving."""
    cfg = tiny_test_config(hid_router=2 * tiny_test_config().hid_router)
    wrong = Predictor(cfg, build_model(cfg, device="cpu"), batch_buckets=BUCKETS, device="cpu")
    with pytest.raises(Exception, match="shape"):
        program4.module()(wrong.tensors(), *wrong._padded(_request(), 4))


def test_manifest_contents(artifact):
    out_dir, manifest, _ = artifact
    assert set(manifest) == {"version", "seq_len", "batch_buckets", "num_classes",
                             "pixel_dtype", "pixel_shape", "platforms", "torch_version",
                             "quantize", "files"}
    assert manifest["version"] == 1 and manifest["seq_len"] == 16
    assert manifest["batch_buckets"] == [1, 4] and manifest["num_classes"] == 3
    assert manifest["pixel_dtype"] == "float32" and manifest["pixel_shape"] == [3, 32, 32]
    assert manifest["platforms"] == ["cpu"] and manifest["quantize"] is None
    assert manifest["torch_version"] == torch.__version__
    assert manifest["files"] == {"1": {"cpu": "fwd_b1.cpu.pt2"}, "4": {"cpu": "fwd_b4.cpu.pt2"}}
    for fname in ("fwd_b1.cpu.pt2", "fwd_b4.cpu.pt2"):
        assert os.path.getsize(os.path.join(out_dir, fname)) > 0
    assert load_config_json(os.path.join(out_dir, "config.json")) == tiny_test_config()


def test_weights_stay_out_of_the_artifact(program4):
    """Exported from seed 0's weights, run with seed 1's: the answers are
    seed 1's ``Predictor``'s. The saved program holds no tensor and no
    example inputs."""
    assert len(program4.state_dict) == 0 and len(program4.constants) == 0
    assert program4.example_inputs is None
    live = _live(1)
    with torch.inference_mode():
        got = program4.module()(live.tensors(), *live._padded(_request(), 4))[:3].numpy()
    want = live.predict(*_request())["probs"]
    assert not np.allclose(want, _live(0).predict(*_request())["probs"], atol=1e-3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_int8_artifact_equals_the_quantized_predictor(tmp_path):
    """The quantized artifact equals the quantized ``Predictor``, differs
    from the dense one and stays within 0.05 of it."""
    out = str(tmp_path / "int8")
    manifest = texport.export_predictor(tiny_test_config(), _model(), out, batch_buckets=(4,),
                                        pixel_dtype=np.float32, quantize="int8",
                                        self_check=False, platforms=("cpu",))
    assert manifest["quantize"] == "int8"
    loaded = texport.load_exported(out, _model(), device="cpu")
    assert loaded.quantize == "int8"
    got = loaded.predict(*_request())
    want = _live(quantize="int8").predict(*_request())
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-6, rtol=0)
    dense = _live().predict(*_request())
    assert not np.array_equal(got["probs"], dense["probs"])
    np.testing.assert_allclose(got["probs"], dense["probs"], atol=0.05, rtol=0)


def test_a_fresh_process_loads_and_serves_the_artifact(artifact, tmp_path):
    """A process that imports only ``d2r_tpu_torch.export`` (and the model
    it pairs the artifact with) registers the custom ops, loads and
    predicts."""
    out_dir = artifact[0]
    weights = str(tmp_path / "model.pt")
    torch.save(_model().state_dict(), weights)
    np.savez(str(tmp_path / "req.npz"), *_request())
    code = (
        "import numpy as np, torch\n"
        "from d2r_tpu_torch.export import load_exported\n"
        "from d2r_tpu_torch.config import load_config_json\n"
        "from d2r_tpu_torch.models.unimo import D2RClassifier\n"
        "torch.set_num_threads(1)\n"
        f"m = D2RClassifier(load_config_json({os.path.join(out_dir, 'config.json')!r}))\n"
        f"m.load_state_dict(torch.load({weights!r}))\n"
        f"p = load_exported({out_dir!r}, m, device='cpu')\n"
        f"r = np.load({str(tmp_path / 'req.npz')!r})\n"
        "out = p.predict(*(r[f'arr_{i}'][:1] for i in range(4)))\n"
        f"np.save({str(tmp_path / 'probs.npy')!r}, out['probs'])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(str(tmp_path / "probs.npy"))
    want = _live().predict(*(x[:1] for x in _request()))["probs"]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_cli_format_torch_writes_the_reference_state_dict(tmp_path):
    """``--format torch`` writes ``best_model.pth``: the JAX package's
    ``reference_state_dict`` of the same weights, bit for bit."""
    out = str(tmp_path / "out")
    line = _main(["--load_path", tiny_checkpoint(tmp_path), "--out_dir", out, "--device", "cpu",
                  "--format", "torch"])
    path = os.path.join(out, "best_model.pth")
    assert line == {"out_dir": out, "format": "torch", "file": path, "keys": line["keys"]}
    sd = torch.load(path, weights_only=True)
    want = jax_reference_state_dict(tiny_tree(0))
    assert len(sd) == line["keys"] == len(want)
    for k, v in want.items():
        assert torch.equal(sd[k], torch.from_numpy(np.array(v))), k


@pytest.mark.parametrize("scan_layers", [False, True], ids=["layers", "scanned"])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_reference_state_dict_equals_jax(scan_layers, alpha):
    """The port's key map of the port's model equals the JAX package's of
    the same Flax tree, key for key and bit for bit."""
    jcfg = jax_tiny_config(scan_layers=scan_layers, alpha=alpha)
    b = synthetic_batch(2, jcfg.max_seq, jcfg.vision_config().image_size,
                        vocab_size=jcfg.text_config().vocab_size, seed=0)
    tree = random_variables(JaxClassifier(jcfg), [jnp.asarray(b[k]) for k in INPUTS], seed=4)
    tree = {c: tree[c] for c in ("params", "batch_stats")}
    model = from_jax_variables(tiny_test_config(scan_layers=scan_layers, alpha=alpha), tree)
    got = reference_state_dict(to_jax_variables(model))
    want = jax_reference_state_dict(tree)
    assert list(got) == list(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _sites(dtype):
    """q, k, v as strided views of one QKV tensor and a padding bias at K1's
    three site geometries (BERT with bias, CLIP, IMRC) and K3's (CLIP-L)."""
    g = torch.Generator().manual_seed(0)
    out = []
    for name, b, l, h, d, with_bias in (("bert", 2, 64, 12, 64, True),
                                        ("clip", 2, 50, 12, 64, False),
                                        ("imrc", 2, 64, 16, 48, False),
                                        ("clip_l", 1, 257, 16, 64, True)):
        qkv = torch.randn((b, l, 3, h * d), generator=g).to(dtype)
        q, k, v = (qkv[:, :, i].view(b, l, h, d) for i in range(3))
        bias = (torch.randint(0, 2, (b, l), generator=g).float() - 1) * 1e4 if with_bias else None
        out.append((name, q, k, v, bias))
    return out


def _meta(t):
    return None if t is None else (tuple(t.shape), t.dtype, t.stride())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementations_match_the_plain_versions(dtype):
    """Each op's fake implementation, run under ``FakeTensorMode``, gives
    the plain version's shape and type with the kernels' contiguous strides
    (the kernels write contiguous outputs; the plain einsum returns a
    head-major view of the same shape)."""
    for name, q, k, v, bias in _sites(dtype):
        scale = q.shape[-1] ** -0.5
        if name == "clip_l":
            plain = (tfl.flash_attention_plain(q, k, v, bias, scale),)
        else:
            out = tfa.fused_attention_small_plain(q, k, v, bias, scale)
            plain = (out, *tfa.fused_attention_small_bwd_plain(q, k, v, bias, out, scale))
        want = [(tuple(t.shape), t.dtype, t.contiguous().stride()) for t in plain]
        with FakeTensorMode() as mode:
            fq, fk, fv, fo = (mode.from_tensor(t) for t in (q, k, v, plain[0]))
            fb = None if bias is None else mode.from_tensor(bias)
            if name == "clip_l":
                got = [torch.ops.d2r_torch.flash_attention_fwd(fq, fk, fv, fb, scale)]
            else:
                seed = mode.from_tensor(tfa.seed_tensor(7))
                got = [torch.ops.d2r_torch.fused_attention_fwd(fq, fk, fv, fb, scale, 0.1,
                                                               seed, 3)]
                got += torch.ops.d2r_torch.fused_attention_bwd(fq, fk, fv, fb, fo, scale, 0.1,
                                                               seed, 3, True)
            got = [_meta(t) for t in got]
        assert got == want, name
