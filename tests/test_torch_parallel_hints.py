"""The two layout hints under a model axis (``cfg.seq_shard``,
``cfg.fabric_shard``) and int8 training under a model axis
(``cfg.quant_train``), on the CPU over gloo, against the port's one-process
step.

From one model (``test_torch_parallel_ranks.conditioned_model``) and one
wrap-padded global batch of 8 rows:

- ``seq_shard`` and ``fabric_shard`` at (1, 2) and (2, 2): the loss and the
  JS loss within rtol 2e-5 and the reduced gradients within atol 2e-5 of
  one process's (JAX's own tolerances, ``tests/test_tp_semantics.py:193-195,
  267-272``), the updated tensors within rtol 2e-4 / atol 2e-6; each rank's
  first text block sees 16/tp tokens under ``seq_shard`` (the vision tower's
  5 tokens do not divide 2: its blocks see all 5, the no-op of JAX's
  constraint), and the fabric's first layer sees 1/tp of the data row's
  rows under ``fabric_shard``; every replica bit-equal afterwards.
- A batch whose rows the model axis does not divide runs the fabric whole,
  and a sequence it does not divide runs whole.
- With dropout on, ``seq_shard`` at (1, 2) draws the masks of the unsharded
  (1, 2) step: the hidden dropout of a slice takes the whole tensor's bits.
- ``quant_train`` ``int8`` and ``int8_all`` at (1, 2): ``quant_dot`` split
  along K (row-parallel) and along N (column-parallel) equals one process's
  bits, forward and quantized backward; the step's gradients within 2/127
  of each leaf's max of one process's (``tests/test_torch_qdot.py``'s
  ``int8_all`` bound, with its floor of 1e-4 of the largest leaf's max),
  the loss within rtol 2e-5.
"""

import functools

import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from d2r_tpu_torch.parallel.launch import spawn

RTOL, GRAD_ATOL = 2e-5, 2e-5
HINTS = {"seq": dict(seq_shard=True), "fabric": dict(fabric_shard=True)}
QUANT = {"int8": dict(quant_train="int8"), "int8_all": dict(quant_train="int8_all")}
EXTRA = {"tp_dropout": dict(bert_name="tiny-bert"),
         "seq_dropout": dict(seq_shard=True, bert_name="tiny-bert")}
CASES = [((1, 2), v) for v in HINTS] + [((2, 2), v) for v in HINTS]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def one_process(name):
    ranks.register_presets()
    return ranks.layout_step({**HINTS, **QUANT}[name])[0]


@functools.lru_cache(maxsize=None)
def mesh_run(shape):
    variants = {**HINTS, **(QUANT if shape == (1, 2) else {}),
                **(EXTRA if shape == (1, 2) else {})}
    return spawn(ranks.layout_rank, int(np.prod(shape)), (shape, variants))


def _close_step(got, want, grad_check):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_allclose(got["js_loss"], want["js_loss"], rtol=RTOL)
    assert got["grads"].keys() == want["grads"].keys()
    for k, v in want["grads"].items():
        grad_check(got["grads"][k], v, k)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=ranks.STEP_RTOL,
                                   atol=ranks.STEP_ATOL, err_msg=k)


def _grads_atol(got, want, key):
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("shape,hint", CASES, ids=[f"{'x'.join(map(str, s))}-{h}"
                                                   for s, h in CASES])
def test_hint_matches_one_process(shape, hint):
    runs = mesh_run(shape)
    _close_step(runs[0][hint], one_process(hint), _grads_atol)
    tp, rows = shape[1], ranks.BATCH // shape[0]
    for r in runs:
        assert r[hint]["loss"] == runs[0][hint]["loss"]
        assert r[hint]["replicas"] == {"model": [], "data": []}
        assert r[hint]["text_len"] == (16 // tp if hint == "seq" else 16)
        assert r[hint]["vision_len"] == 5
        assert r[hint]["fabric_rows"] == (rows // tp if hint == "fabric" else rows)


def test_hints_are_no_ops_where_the_dimension_does_not_divide():
    """The fabric of a batch of 3 rows and a tower block of 5 tokens run
    whole under a model axis of 2 (the decisions alone; the runs above show
    the vision tower's 5 tokens whole)."""
    from d2r_tpu_torch.config import tiny_test_config
    from d2r_tpu_torch.models.bert import seq_shard_of
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.parallel.mesh import Mesh
    model = build_model(tiny_test_config(seq_shard=True, fabric_shard=True), device="cpu")
    mesh = Mesh(1, 2, 0, "cpu", fabric_group="fabric")
    for m in model.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    assert model.model._fabric_group(3) is None and model.model._fabric_group(4) == "fabric"
    tower = model.model.encoder_text_layers
    assert seq_shard_of(tower, torch.zeros(2, 5, 64)) is None
    assert seq_shard_of(tower, torch.zeros(2, 16, 64)).count == 2
    model.model.cfg = tiny_test_config()
    tower.seq_shard = False
    assert model.model._fabric_group(4) is None and seq_shard_of(tower, torch.zeros(2, 16, 64)) \
        is None


def test_seq_shard_draws_the_unsharded_masks():
    """Dropout on (tiny-bert, 0.1): the (1, 2) step with ``seq_shard``
    equals the (1, 2) step without, the sliced hidden dropouts drawing the
    whole tensors' bits (the attention sites draw per model rank either
    way)."""
    runs = mesh_run((1, 2))
    _close_step(runs[0]["seq_dropout"], runs[0]["tp_dropout"], _grads_atol)
    assert runs[0]["seq_dropout"]["text_len"] == 8


def test_sliced_hidden_dropout_masks_are_the_whole_tensor_rows():
    from d2r_tpu_torch.ops.kernels.dropout import hidden_dropout_plain
    from d2r_tpu_torch.ops.kernels.fused_attention import DropoutSeed, seed_tensor
    seed = DropoutSeed(seed_tensor(7), 3)
    x = torch.randn(3, 16, 12, generator=torch.Generator().manual_seed(0))
    whole = hidden_dropout_plain(x, 0.3, seed)
    for i in range(4):
        part = x[:, 4 * i:4 * (i + 1)].contiguous()
        got = hidden_dropout_plain(part, 0.3, seed, (4 * 12, 16 * 12, 4 * i * 12))
        assert torch.equal(got, whole[:, 4 * i:4 * (i + 1)])
    with pytest.raises(ValueError, match="multiples of 4"):
        hidden_dropout_plain(x[:, :3].contiguous(), 0.3, seed, (3 * 12 + 2, 16 * 12, 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_dot_under_the_model_axis_is_one_process_s_bits(dtype):
    got = spawn(ranks.qdot_rank, 2, (dtype,))
    for r in got:
        for mode, sides in r.items():
            for side, checks in sides.items():
                assert all(checks), (mode, side, checks)


@pytest.mark.parametrize("mode", list(QUANT))
def test_quant_train_under_the_model_axis_matches_one_process(mode):
    runs = mesh_run((1, 2))
    want = one_process(mode)
    # a leaf whose gradient is rounding noise (the cross-modal key biases,
    # to which a softmax is invariant) is held against the largest leaf, as
    # tests/test_torch_qdot.py does
    floor = 1e-4 * max(g.abs().max().item() for g in want["grads"].values())

    def within_two_steps(got, want, key):
        bound = 2 / 127 * max(want.abs().max().item(), floor)
        assert (got - want).abs().max().item() <= bound, key

    np.testing.assert_allclose(runs[0][mode]["loss"], want["loss"], rtol=RTOL)
    for k, v in want["grads"].items():
        within_two_steps(runs[0][mode]["grads"][k], v, k)
    for r in runs:
        assert r[mode]["replicas"] == {"model": [], "data": []}
