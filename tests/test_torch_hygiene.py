"""Boundaries of the port: ``d2r_tpu_torch`` and ``chip_smoke.py`` import
nothing of JAX or of ``d2r_tpu``; the entry points refuse a missing GPU
instead of falling back to the CPU; the CUDA wrapper has no fallback path;
no library attention or ``torch.compile`` stands in for a kernel; and the
port reads the JAX package's config files."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "d2r_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "d2r_tpu")


def _sources():
    # chip_smoke.py and the GPU tests run where there is no JAX
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                        REPO / "tests" / "test_torch_cuda.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_import_leaves_jax_and_d2r_tpu_unloaded():
    code = (
        "import pkgutil, sys, d2r_tpu_torch\n"
        "for m in pkgutil.walk_packages(d2r_tpu_torch.__path__, 'd2r_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        f"bad = [n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len([n for n in sys.modules if n.startswith('d2r_tpu_torch.')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert int(p.stdout.split()[0]) >= 35, p.stdout   # every module was imported


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_neither_jax_nor_d2r_tpu(path):
    assert not (_imported_roots(path) & set(FORBIDDEN)), path


def test_no_library_attention_or_compile_in_the_port():
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("scaled_dot_product_attention", "compile"), (
                    f"{path}:{node.lineno} uses {node.attr}")


@pytest.mark.parametrize("wrapper", ["fused_attention.py", "flash_attention.py"])
def test_cuda_wrapper_has_no_fallback_except(wrapper):
    tree = ast.parse((PKG / "ops" / "kernels" / wrapper).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_entry_points_default_to_cuda_and_refuse_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a GPU")
    from d2r_tpu_torch.config import tiny_test_config
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.serve import Predictor
    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, build_model(cfg, device="cpu"))


def test_cli_defaults_to_cuda_and_refuses_a_missing_gpu(tmp_path):
    """Without --device the CLI asks for the card, and stops before it
    reads any data."""
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a GPU")
    from d2r_tpu_torch import cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--bert_name", "tiny-bert", "--vit_name", "tiny-vit",
                  "--train_json", str(tmp_path / "absent.json"),
                  "--save_path", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


SERVING_ENTRY_POINTS = {
    "server": ["--load_path", "absent/best_model"],
    "predict": ["--load_path", "absent/best_model", "--input", "absent.jsonl"]}


@pytest.mark.parametrize("entry", sorted(SERVING_ENTRY_POINTS))
def test_serving_entry_points_default_to_cuda_and_refuse_a_missing_gpu(entry):
    """``python -m d2r_tpu_torch.server`` and ``.predict`` without
    ``--device`` ask for the card, before they read a checkpoint."""
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a GPU")
    import importlib
    main = importlib.import_module(f"d2r_tpu_torch.{entry}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(SERVING_ENTRY_POINTS[entry])


@pytest.mark.parametrize("flag", ["--dp", "--tp"])
def test_multi_chip_serving_flags_are_refused(flag):
    from d2r_tpu_torch import server
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 9"):
        server.main(SERVING_ENTRY_POINTS["server"] + ["--device", "cpu", flag, "2"])


BROAD = {"Exception", "BaseException", "RuntimeError"}


def _broad(handler):
    types = (handler.type.elts if isinstance(handler.type, ast.Tuple)
             else [handler.type])
    return any(t is None or (isinstance(t, ast.Name) and t.id in BROAD) for t in types)


@pytest.mark.parametrize("module", ["serve.py", "quant.py", "server.py", "predict.py"])
def test_serving_path_swallows_no_device_error(module):
    """Every handler in the serving path that could catch a device error
    (bare, ``Exception``, ``BaseException``, ``RuntimeError``) re-raises it
    or passes the caught exception on (to a future, a 500 answer, a later
    raise); none drops it."""
    tree = ast.parse((PKG / module).read_text())
    for h in (n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)):
        if not _broad(h):
            continue
        body = [n for stmt in h.body for n in ast.walk(stmt)]
        passes_on = h.name is not None and any(
            isinstance(n, ast.Name) and n.id == h.name for n in body)
        assert passes_on or any(isinstance(n, ast.Raise) for n in body), (
            f"{module}:{h.lineno} catches a device error and drops it")


def test_native_bridges_build_under_build_not_native():
    """The JAX package builds the same C sources into native/; the port's
    libraries go to build/native/."""
    from d2r_tpu_torch.data import native_image, native_lib, native_text
    assert pathlib.Path(native_lib.BUILD_DIR) == REPO / "build" / "native"
    assert pathlib.Path(native_lib.NATIVE_SRC) == REPO / "native"
    for bridge in (native_image, native_text):
        assert pathlib.Path(bridge._LIB_PATH).parent == REPO / "build" / "native"


def test_wrapper_refuses_devices_without_a_kernel():
    from d2r_tpu_torch.ops.kernels.fused_attention import fused_attention_small
    q = torch.empty(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_attention_small(q, q, q, None, 0.5)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from d2r_tpu_torch.ops.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a GPU")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_config_reads_jax_config_json(tmp_path):
    from d2r_tpu.config import D2RConfig as JaxConfig
    from d2r_tpu.config import save_config_json
    from d2r_tpu_torch.config import D2RConfig, load_config_json
    jcfg = JaxConfig(DR_step=4, max_seq=64, compute_dtype="bfloat16", mesh_shape=(2, 4))
    save_config_json(jcfg, str(tmp_path / "config.json"))
    cfg = load_config_json(str(tmp_path / "config.json"))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.dtype is torch.bfloat16
    assert cfg.text_config() == D2RConfig().text_config()
    assert {f.name for f in dataclasses.fields(D2RConfig)} == {
        f.name for f in dataclasses.fields(JaxConfig)}


@pytest.mark.parametrize("override", [
    {"quant_train": "int8"}, {"pipeline_stages": 2}, {"use_sentic_graph": True},
    {"alpha": 0.5}, {"remat": True}])
def test_config_values_the_port_cannot_honour_raise(override):
    """The values still unported raise, naming their ROADMAP item; those
    ported since (CCR's ``alpha``, ``remat``, int8 ``quant_train`` and
    ``use_sentic_graph``, here with an adjacency) build a model whose
    train-mode forward and backward run."""
    from d2r_tpu.data.dataset import synthetic_batch
    from d2r_tpu_torch.config import tiny_test_config
    from d2r_tpu_torch.models.layers import DropoutRNG
    from d2r_tpu_torch.models.unimo import build_model
    cfg = tiny_test_config(**override)
    if not ({"alpha", "remat", "quant_train", "use_sentic_graph"} & set(override)):
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md Queue 1 item"):
            build_model(cfg, device="cpu")
        return
    model = build_model(cfg, device="cpu").train()
    b = synthetic_batch(2, cfg.max_seq, cfg.vision_config().image_size,
                        vocab_size=cfg.text_config().vocab_size)
    adj = torch.rand(2, cfg.max_seq, cfg.max_seq, generator=torch.Generator().manual_seed(0))
    loss, _, _ = model(*(torch.as_tensor(b[k]) for k in (
        "input_ids", "attention_mask", "token_type_ids", "labels", "pixel_values")),
        rng=DropoutRNG(0, "cpu"), sentic_adj=adj)
    loss.backward()
    assert torch.isfinite(loss)
