"""The port's int8 quantized training (``d2r_tpu_torch/ops/qdot.py``,
``--quant_train``) against the JAX package's ``d2r_tpu/ops/qdot.py``, on the
CPU.

- ``quant_dot`` against JAX's on the same numpy operands, fp32 and bf16:
  the forward and the ``int8_all`` backward bit for bit (the integer
  product is exact and the rest is the same elementwise arithmetic in the
  same order); the ``int8`` (straight-through) backward is a float product,
  bit for bit on operands whose every partial sum is exact, within 1e-6 of
  the largest value on random ones (the two libraries sum in different
  orders). Shapes cover m < 17, k and n not multiples of 8, and all-zero
  rows: ``int_mm``'s zero padding runs on the CPU too.
- JAX's own ``tests/test_qdot.py`` checks, on the port: exact on
  representable operands, the error bound, zero slices, STE = the exact
  product's backward, ``int8_all`` close to exact.
- The tiny model with ``quant_train`` ``int8`` and ``int8_all``: the towers,
  the poolers and the logits within 1e-4 of JAX's in fp32, and one train step's loss within 1e-4, from one Flax
  tree; every gradient within 1e-4 of the leaf's max with ``int8``. With
  ``int8_all`` the gradients themselves are quantized: a 1-ulp difference
  upstream (the float products of the two libraries sum in different
  orders) can move a gradient across a rounding boundary, which moves that
  element by a whole step of its slice's scale, amax / 127, and the steps
  below it with it; so they are held to two such steps, 2/127 of the leaf's
  max (measured: 6.7e-3 at most, in the first CLIP layer, the last the
  backward reaches). On the same inputs the quantized backward is bit-equal
  to JAX's (above). Mode ``none`` runs ``F.linear`` exactly, the code
  before quantization existed.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu.ops import qdot as jqdot
from d2r_tpu.train import optimizer as joptim
from d2r_tpu.train.state import TrainState as JaxTrainState
from d2r_tpu.train.state import make_train_step as jax_make_train_step
from d2r_tpu_torch.models.layers import QKVDense, TorchLinear
from d2r_tpu_torch.ops import qdot
from d2r_tpu_torch.train.state import create_train_state, make_train_step
from d2r_tpu_torch.weights import from_jax_variables
from test_torch_train import (
    GRAD_MODULES,
    INPUTS,
    TOTAL_STEPS,
    _batch,
    _configs,
    _jax_first_moment_grads,
    _port_grads,
    _random_tree,
)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (x shape, (K, N)): a BERT-like site, m < 17 with k, n multiples of 8, an
# odd shape on every axis, a 3-D activation
SHAPES = [((64, 96), (96, 128)), ((3, 5, 32), (32, 24)), ((5, 37), (37, 3)),
          ((2, 9, 20), (20, 13))]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset_jax_mode():
    """A JAX model traced with ``quant_train`` leaves ``d2r_tpu.ops.qdot.MODE``
    set for every later trace in the process (its module global; JAX's own
    ``tests/test_qdot.py`` resets it the same way)."""
    prev = jqdot.MODE
    yield
    jqdot.MODE = prev


def _operands(xshape, wshape, seed, zero_rows=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xshape).astype(np.float32)
    w = rng.standard_normal(wshape).astype(np.float32)
    g = rng.standard_normal(xshape[:-1] + wshape[1:]).astype(np.float32)
    if zero_rows:
        x.reshape(-1, xshape[-1])[1] = 0.0      # an all-zero activation row
        w[:, 0] = 0.0                          # an all-zero output feature
    return x, w, g


def _jax_quant(x, w, g, mode, jdt):
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    y, vjp = jax.vjp(lambda a, b: jqdot.quant_dot(a, b, mode), xj, wj)
    dx, dw = vjp(jnp.asarray(g, jdt))
    return [np.asarray(t.astype(jnp.float32)) for t in (y, dx, dw)]


def _port_quant(x, w, g, mode, tdt):
    xt = torch.tensor(x).to(tdt).requires_grad_()
    wt = torch.tensor(w.T.copy()).to(tdt).requires_grad_()    # (N, K)
    y = qdot.quant_dot(xt, wt, mode)
    y.backward(torch.tensor(g).to(tdt))
    return [t.detach().float().numpy() for t in (y, xt.grad, wt.grad.T)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: "x".join(map(str, s[0] + s[1][1:])))
@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_quant_dot_matches_jax(mode, shapes, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, g = _operands(*shapes, seed=len(shapes[0]) + shapes[1][0])
    want = _jax_quant(x, w, g, mode, jdt)
    got = _port_quant(x, w, g, mode, tdt)
    names = ("y", "dx", "dw")
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0], err_msg="forward")
    if mode == "int8_all":
        for n, a, b in zip(names[1:], got[1:], want[1:]):
            np.testing.assert_array_equal(a, b, err_msg=n)
    else:
        tol = 1e-6 if dtype == "float32" else 8e-3     # one rounding to bf16
        for n, a, b in zip(names[1:], got[1:], want[1:]):
            assert np.abs(a - b).max() <= tol * np.abs(b).max(), n


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ste_backward_matches_jax_bit_for_bit_on_exact_sums(dtype):
    """Operands on a grid of 1/8 with |values| <= 4: every product and
    partial sum of the float backward is exact in fp32, and its results in
    bf16, so both libraries' orders of summation give the same bits."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    x = rng.integers(-32, 33, (2, 7, 24)).astype(np.float32) / 8
    w = rng.integers(-32, 33, (24, 16)).astype(np.float32) / 8
    g = rng.integers(-1, 2, (2, 7, 16)).astype(np.float32)
    for a, b in zip(_port_quant(x, w, g, "int8", tdt)[1:], _jax_quant(x, w, g, "int8", jdt)[1:]):
        np.testing.assert_array_equal(a, b)


def test_int_mm_pads_to_the_library_shapes_exactly():
    """``int_mm`` gives the exact integer product at shapes ``_int_mm``
    refuses on the card (m <= 16, k and n not multiples of 8)."""
    rng = np.random.default_rng(0)
    for m, k, n in [(1, 1, 1), (5, 37, 3), (16, 8, 8), (17, 40, 9), (64, 96, 128)]:
        a = torch.tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8)
        b = torch.tensor(rng.integers(-127, 128, (n, k)), dtype=torch.int8)
        got = qdot.int_mm(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got, a.int() @ b.int().T)


# ---- JAX's tests/test_qdot.py, on the port --------------------------------

def _representable(shape, axis, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(-127, 128, shape).astype(np.float32)
    idx = [slice(None)] * len(shape)
    idx[axis] = 0
    k[tuple(idx)] = 127.0
    return torch.tensor(k * 0.03125)


def test_exact_on_representable_operands():
    x = _representable((3, 5, 32), -1, 0)
    w = _representable((24, 32), -1, 1)          # (N, K): 127 in every output row
    np.testing.assert_allclose(qdot.quant_dot(x, w).numpy(), (x @ w.T).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_error_bound_random():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(8, 16, 64, generator=gen)
    w = torch.randn(48, 64, generator=gen)
    got = qdot.quant_dot(x, w).double()
    want = (x @ w.T).double()
    assert torch.linalg.norm(got - want) / torch.linalg.norm(want) < 0.03


def test_zero_slices_do_not_nan():
    x = torch.zeros(4, 16, requires_grad=True)
    w = torch.zeros(8, 16)
    out = qdot.quant_dot(x, w, "int8")
    assert torch.equal(out, torch.zeros(4, 8))
    qdot.quant_dot(x, w, "int8_all").sum().backward()
    assert torch.isfinite(x.grad).all()


def test_ste_backward_matches_exact_dot():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 7, 32, generator=gen)
    w = torch.randn(16, 32, generator=gen)
    ct = torch.randn(4, 7, 16, generator=gen)

    def pull(f):
        a, b = x.clone().requires_grad_(), w.clone().requires_grad_()
        f(a, b).backward(ct)
        return a.grad, b.grad

    for q, e in zip(pull(lambda a, b: qdot.quant_dot(a, b, "int8")),
                    pull(lambda a, b: a @ b.T)):
        torch.testing.assert_close(q, e, rtol=1e-5, atol=1e-6)


def test_int8_all_backward_close_to_exact():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(16, 64, generator=gen)
    w = torch.randn(32, 64, generator=gen)
    ct = torch.randn(16, 32, generator=gen)
    grads = []
    for f in (lambda a, b: qdot.quant_dot(a, b, "int8_all"), lambda a, b: a @ b.T):
        a, b = x.clone().requires_grad_(), w.clone().requires_grad_()
        f(a, b).backward(ct)
        grads.append((a.grad.double(), b.grad.double()))
    for got, want in zip(*grads):
        assert torch.linalg.norm(got - want) / torch.linalg.norm(want) < 0.03


def test_unknown_mode_raises_like_jax():
    from d2r_tpu_torch.config import tiny_test_config
    for check in (lambda: qdot.check_mode("int4"),
                  lambda: tiny_test_config(quant_train="int4").check_supported()):
        with pytest.raises(ValueError, match="quant_train"):
            check()


def test_mode_none_is_the_plain_linear():
    """Mode ``none`` is ``F.linear`` bit for bit (the code before
    quantized training existed); a quantized mode differs."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 16, generator=gen)
    lin, qkv = TorchLinear(16, 8), QKVDense(16, 4)
    for m in (lin, qkv):
        m.init_params(gen)
    assert torch.equal(lin(x), F.linear(x, lin.weight, lin.bias))
    assert torch.equal(torch.cat(qkv(x), -1),
                       F.linear(x, qkv.weight, qkv.bias).view(2, 5, 3, 4).flatten(-2))
    qdot.set_quant_mode(lin, "int8")
    assert not torch.equal(lin(x), F.linear(x, lin.weight, lin.bias))


def test_model_sets_the_mode_of_every_projection():
    from d2r_tpu_torch.config import tiny_test_config
    from d2r_tpu_torch.models.unimo import D2RClassifier
    for mode in qdot.MODES:
        model = D2RClassifier(tiny_test_config(quant_train=mode))
        modes = {m.quant for m in model.modules() if isinstance(m, (TorchLinear, QKVDense))}
        assert modes == {mode}
    assert set(D2RClassifier(tiny_test_config()).state_dict()) == set(
        D2RClassifier(tiny_test_config(quant_train="int8")).state_dict())


# ---- the tiny model against JAX -------------------------------------------

@functools.lru_cache(maxsize=None)
def _tree():
    jcfg, _ = _configs(DR_step=3)
    return _random_tree(JaxClassifier(jcfg), _batch(jcfg), seed=7)


# the logits move little over this random tiny model's rows, so outputs
# upstream of them are held too
OUTPUTS = ("model/encoder_text_layers", "model/encoder_vision_layers", "model/self_text",
           "model/text_pool", "model/vision_pool", "fc")


def jax_outputs(jcfg, tree, batch, paths, **extra):
    """{module path: output} of JAX's eval forward of ``tree`` on ``batch``."""
    jmodel = JaxClassifier(jcfg)

    @jax.jit
    def run(v, *args):
        return jmodel.apply(v, *args, valid=jnp.asarray(batch["valid"]),
                            capture_intermediates=True, mutable=["intermediates"],
                            **{k: jnp.asarray(a) for k, a in extra.items()})

    _, state = run(jax.tree_util.tree_map(jnp.asarray, tree),
                   *[jnp.asarray(batch[k]) for k in INPUTS[:5]])
    out = {}
    for path in paths:
        node = state["intermediates"]
        for part in path.split("/"):
            node = node.get(part, {})
        if "__call__" in node:
            out[path] = np.asarray(node["__call__"][0])
    return out


def port_outputs(tcfg, tree, batch, paths, **extra):
    """The same of the port's model loaded from ``tree``."""
    model = from_jax_variables(tcfg, copy.deepcopy(tree))
    got = {}
    for path in paths:
        model.get_submodule(path.replace("/", ".")).register_forward_hook(
            lambda _m, _a, out, path=path: got.__setitem__(path, out.detach().numpy()))
    with torch.no_grad():
        model(*[torch.as_tensor(batch[k]) for k in INPUTS[:5]],
              valid=torch.as_tensor(batch["valid"]),
              **{k: torch.as_tensor(a) for k, a in extra.items()})
    return got


@functools.lru_cache(maxsize=None)
def _jax_int8_outputs():
    jcfg, _ = _configs(DR_step=3, quant_train="int8")
    return jax_outputs(jcfg, _tree(), _batch(jcfg), OUTPUTS)


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_quantized_model_matches_jax(mode):
    """The towers, the text branch's self-attention and the poolers and the
    logits within 1e-4; both modes share JAX's int8 forward."""
    _, tcfg = _configs(DR_step=3, quant_train=mode)
    b = _batch(tcfg)
    got, want = port_outputs(tcfg, _tree(), b, OUTPUTS), _jax_int8_outputs()
    assert set(got) == set(want) == set(OUTPUTS)
    for path in OUTPUTS:
        np.testing.assert_allclose(got[path], want[path], atol=1e-4, rtol=0, err_msg=path)
    _, plain = _configs(DR_step=3)
    plain_out = port_outputs(plain, _tree(), b, OUTPUTS)
    # the int8 products ran: the text tower's output moves
    assert np.abs(plain_out["model/encoder_text_layers"]
                  - got["model/encoder_text_layers"]).max() > 1e-3


@functools.lru_cache(maxsize=None)
def quant_step(mode):
    """One train step of JAX and of the port from ``_tree()`` with
    ``quant_train=mode``: (loss, step-1 grads) of each."""
    jcfg, tcfg = _configs(DR_step=3, quant_train=mode)
    return step_against_jax(jcfg, tcfg, _batch(jcfg), _tree())


def step_against_jax(jcfg, tcfg, batch, tree):
    """One train step of each package from ``tree`` on ``batch`` (numpy):
    ((JAX loss, grads), (port loss, grads)), grads keyed by Flax path."""
    jmodel = JaxClassifier(jcfg)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=jax.tree_util.tree_map(jnp.asarray, tree["params"]),
        tx=joptim.make_optimizer(jcfg, TOTAL_STEPS),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"]))
    jstate, m = jax_make_train_step(jmodel)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    jax_out = (float(m["loss"]), _jax_first_moment_grads(jstate.opt_state))
    state = create_train_state(tcfg, TOTAL_STEPS, device="cpu",
                               model=from_jax_variables(tcfg, copy.deepcopy(tree)))
    state, m = make_train_step()(state, batch, 1)
    return jax_out, (float(m["loss"]), _port_grads(state.model))


def assert_step_matches(jax_out, port_out, modules, rel=1e-4):
    """The loss within 1e-4, and every leaf under ``modules`` within ``rel``
    of its max |grad| (floored at 1e-4 of the model's largest), as
    ``tests/test_torch_train.py`` holds the plain step at 1e-4."""
    (jloss, jgrads), (ploss, pgrads) = jax_out, port_out
    assert abs(ploss - jloss) <= 1e-4, (ploss, jloss)
    assert set(jgrads) == set(pgrads)
    floor = 1e-4 * max(np.abs(g).max() for g in jgrads.values())
    for module in modules:
        keys = [k for k in jgrads if k == module or k.startswith(module + "/")]
        assert keys, module
        for key in keys:
            ref, got = jgrads[key], pgrads[key]
            tol = rel * max(np.abs(ref).max(), floor)
            assert np.abs(got - ref).max() <= tol, (key, np.abs(got - ref).max(), tol)


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_quantized_train_step_matches_jax(mode):
    assert_step_matches(*quant_step(mode), GRAD_MODULES, 1e-4 if mode == "int8" else 2 / 127)
