"""The off-path extras of the port against the JAX package's, on the CPU in
fp32: ``models/extras.py`` (each module's Flax variables loaded into the
port's through ``weights.from_jax_variables``, train mode with batch
statistics and their running updates, and eval mode), ``ops/losses_extra.py``
(values and gradients), plus ``utils/profiling.py`` and ``utils/cache.py``.
Inputs are made with numpy from a seed; tolerance atol 1e-5 (rtol 1e-5 for
losses), the same fp32 math in another order.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2r_tpu.models import extras as jx
from d2r_tpu.ops import losses_extra as jle
from d2r_tpu_torch.models import extras as tx
from d2r_tpu_torch.ops import losses_extra as tle
from d2r_tpu_torch.utils import cache, profiling
from d2r_tpu_torch.weights import from_jax_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the suite's other workers torch's
    default threads contend, and the tiny steps run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

TOL = 1e-5
REPO = pathlib.Path(__file__).resolve().parents[1]


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(port, ref, atol=TOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# (name, JAX module, port module, inputs, JAX call kwargs): the port module
# is built on the CPU, its parameters set from the JAX variables
CASES = {
    "se_layer": lambda: (jx.SELayer(4), tx.SELayer(4), [_x(3, 4, 6)], {}),
    "graph_reasoning": lambda: (jx.GraphReasoning(8), tx.GraphReasoning(8),
                                [_x(2, 5, 8, scale=0.5)], {}),
    "gated_query_att": lambda: (jx.GatedQueryAttLayer(8, 2), tx.GatedQueryAttLayer(8, 2),
                                [_x(2, 5, 8)], {}),
    "agsa": lambda: (jx.AGSA(2, 8, h=2), tx.AGSA(2, 8, h=2), [_x(3, 5, 8)], {}),
    "self_encoder": lambda: (jx.SelfEncoder(12, 8, 2), tx.SelfEncoder(12, 8, 2),
                             [_x(3, 5, 12)], {}),
    "variational_encoder": lambda: (jx.VariationalEncoder(3), tx.VariationalEncoder(10, 3),
                                    [_x(4, 10)], {}),
}
BATCH_NORM = ("agsa", "self_encoder")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(CASES))
def test_extra_matches_jax(name, train):
    jmod, tmod, inputs, kw = CASES[name]()
    args = [jnp.asarray(a) for a in inputs]
    bn = name in BATCH_NORM
    variables = jmod.init(jax.random.key(1), *args, **kw)
    port = from_jax_variables(tmod, _np(variables))
    if bn and train:
        want, mutated = jmod.apply(variables, *args, use_running_average=False,
                                   mutable=["batch_stats"])
    elif bn:
        want, mutated = jmod.apply(variables, *args, use_running_average=True), None
    else:
        want, mutated = jmod.apply(variables, *args), None
    port.train(train)
    with torch.no_grad():
        got = port(*[torch.from_numpy(a) for a in inputs])
    for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
        _close(g, w)
    if mutated is not None:     # the running statistics after the train-mode call
        port_stats = {k: v for k, v in port.state_dict().items() if "running" in k}
        assert len(port_stats) == len(jax.tree_util.tree_leaves(mutated))
        for key, value in port_stats.items():
            *path, leaf = key.split(".")
            node = mutated["batch_stats"]
            for p in path:
                node = node[p]
            _close(value, node["mean" if leaf == "running_mean" else "var"])


def test_ambiguity_learning_matches_jax_with_its_noise():
    """The JAX module's draws (``jax.random.split`` of its key, then
    ``normal``) fed to the port as the two noise tensors; a generator gives
    a draw of its own, finite, of the same shape."""
    jmod = jx.AmbiguityLearning(weight_js=0.5)
    text, image, weight_in = _x(4, 16, seed=1), _x(4, 12, seed=2), _x(4, 3, seed=3)
    key = jax.random.key(7)
    variables = jmod.init(jax.random.key(1), text, image, weight_in, rng=key)
    want = jmod.apply(variables, text, image, weight_in, rng=key)
    r1, r2 = jax.random.split(key)
    noise = [torch.from_numpy(np.array(jax.random.normal(r, (4, 2)))) for r in (r1, r2)]
    port = from_jax_variables(tx.AmbiguityLearning(16, 12, weight_js=0.5), _np(variables))
    args = [torch.from_numpy(a) for a in (text, image, weight_in)]
    with torch.no_grad():
        got = port(*args, noise=noise)
        drawn = port(*args, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL)
    assert drawn.shape == () and torch.isfinite(drawn)
    with pytest.raises(ValueError, match="torch.Generator"):
        port(*args)


def _loss_cases():
    e1, e2 = _x(6, 8, seed=4), _x(6, 8, seed=5)
    unit = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)
    feats = unit(_x(6, 2, 8, seed=6).reshape(12, 8)).reshape(6, 2, 8)
    labels = np.array([0, 1, 0, 2, 1, 0])
    return {
        "soft_contrastive": ((unit(e1), unit(e2)), dict(alpha=0.7, margin=0.2)),
        "soft_contrastive_max_violation": ((unit(e1), unit(e2)), dict(
            alpha=0.7, margin=0.2, max_violation=True, threshold_hetero=0.1,
            threshold_homo=0.1)),
        "diff": ((_x(6, 3, 4, seed=7), _x(6, 3, 4, seed=8)), {}),
        "labeled_js_div": ((_x(6, 3, seed=9), _x(6, 3, seed=10), np.array([1, 0, 1, 1, 0, 0])),
                           {}),
        "supcon_labels": ((feats,), dict(labels=labels)),
        "supcon_one_similarity": ((feats,), dict(labels=labels, contrast_mode="one",
                                                similarity=_x(6, seed=11) * 0.1)),
        "supcon_eye": ((feats,), dict(temperature=0.5)),
    }


LOSSES = {"soft_contrastive": "soft_contrastive_loss", "diff": "diff_loss",
          "labeled_js_div": "labeled_js_div", "supcon": "supcon_loss"}


@pytest.mark.parametrize("case", list(_loss_cases()))
def test_extra_loss_and_its_gradient_match_jax(case):
    args, kw = _loss_cases()[case]
    fn = LOSSES[next(k for k in LOSSES if case.startswith(k))]
    jfn, tfn = getattr(jle, fn), getattr(tle, fn)
    floats = [i for i, a in enumerate(args) if a.dtype == np.float32]
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}

    def jloss(*xs):
        full = list(map(jnp.asarray, args))
        for i, x in zip(floats, xs):
            full[i] = x
        return jfn(*full, **jkw)

    want, jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(floats))))(
        *[jnp.asarray(args[i]) for i in floats])
    targs = [torch.from_numpy(a).requires_grad_(a.dtype == np.float32) for a in args]
    got = tfn(*targs, **tkw)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=TOL, atol=TOL)
    for i, g in zip(floats, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(g), rtol=TOL, atol=TOL)


def test_profiling_traces_annotates_and_times(tmp_path):
    """``maybe_profile`` writes a Chrome trace holding an ``annotate`` span;
    without a directory it does nothing; ``StepTimer`` leaves the first
    steps out of its mean and percentiles, as the JAX package's."""
    with profiling.maybe_profile(str(tmp_path / "p")):
        with profiling.annotate("d2r_span"):
            torch.ones(8) @ torch.ones(8)
    text = (tmp_path / "p" / profiling.TRACE_FILE).read_text()
    assert '"d2r_span"' in text
    with profiling.maybe_profile(None):
        pass
    assert not (tmp_path / "none").exists()
    timer = profiling.StepTimer(skip_first=2)
    for _ in range(5):
        timer.start()
        timer.stop()
    assert len(timer._times) == 3 and timer.mean >= 0 and timer.percentile(50) >= 0
    assert np.isnan(profiling.StepTimer().mean)


def test_cache_variable_moves_the_build_directory(tmp_path):
    """``D2R_TORCH_CACHE_DIR`` moves the kernels' and the C helpers' build
    directories (read at import); unset, they are ``build/`` beside the
    package; a location that cannot be written raises naming the
    variable."""
    from d2r_tpu_torch.data import native_lib
    from d2r_tpu_torch.ops.kernels import build
    assert pathlib.Path(build.BUILD_DIR) == REPO / "build" / "kernels"
    assert pathlib.Path(native_lib.BUILD_DIR) == REPO / "build" / "native"
    code = ("from d2r_tpu_torch.ops.kernels import build; "
            "from d2r_tpu_torch.data import native_lib; "
            "build.build_all([]); print(build.BUILD_DIR); print(native_lib.BUILD_DIR)")
    env = dict(os.environ, **{cache.ENV_VAR: str(tmp_path / "c")})
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, check=True,
                         capture_output=True, text=True).stdout.split()
    assert out == [str(tmp_path / "c" / "kernels"), str(tmp_path / "c" / "native")]
    assert (tmp_path / "c" / "kernels").is_dir()
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(RuntimeError, match=cache.ENV_VAR):
        cache.writable(str(blocker / "kernels"))
