"""The port's mesh forward against the JAX package's one-device forward, and
dropout under a mesh, on the CPU over gloo.

One random Flax tree (numpy, seeded, at half the fan-in scale as
``tests/test_torch_model.py`` builds it) goes through JAX's train-mode
forward (``deterministic=True``, batch statistics, ``valid``) on one device,
and through the port's on meshes dp = 2, (1, 2) and (2, 2), each rank on its
rows (``tests/test_torch_parallel_ranks.py::forward_rank``): the loss and
the JS loss within rtol 2e-5, the logits (the ranks' rows joined) within
atol 2e-5, and the SAF BatchNorm running statistics within rtol 2e-5, the
tolerances of ``tests/test_dp_semantics.py`` and ``test_tp_semantics.py``.
Two batches: one with every row valid, and a wrap-padded one whose padding
the second data rank holds alone.

Dropout, on a (2, 2) mesh (tiny-bert, rate 0.1): the attention calls of the
two data ranks draw from different seeds, as do the two model ranks at the
head-sharded sites, whose kernels see 4/2 heads each; the masks those seeds
give differ; and the BERT blocks' outputs, activations that every model rank
of a data row holds whole, are bit-equal across its model ranks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from d2r_tpu.config import tiny_test_config as jax_tiny_config
from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu_torch.ops.kernels.fused_attention import dropout_keep_mask
from d2r_tpu_torch.parallel.launch import spawn
from d2r_tpu_torch.weights import from_jax_variables

INPUTS = ("input_ids", "attention_mask", "token_type_ids", "labels", "pixel_values")
MESHES = [(2,), (1, 2), (2, 2)]
RTOL, LOGITS_ATOL = 2e-5, 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_variables(model, args, seed=0):
    """A seeded Flax tree of ``model``: kernels at half the fan-in scale,
    LayerNorm scales near 1, positive BatchNorm variances, small biases."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel" or leaf.startswith("merge_kernel"):
            fan_in = (np.prod(s.shape[:3]) if len(s.shape) == 4
                      else s.shape[1 if leaf.startswith("merge") else 0])
            return 0.5 * n / np.sqrt(fan_in)
        if leaf == "scale":
            return 1.0 + 0.1 * n
        if leaf == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf == "class_embedding":
            return n
        return 0.1 * n

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(fill, shapes))


@functools.lru_cache(maxsize=None)
def reference():
    """(tree, batches, JAX results a batch, port mesh results by mesh)."""
    cfg = jax_tiny_config(batch_size=ranks.BATCH)
    batches = [ranks.global_batch(ranks.step_config("plain"), 4, valid)
               for valid in (None, ranks.PADDED)]
    model = JaxClassifier(cfg)
    variables = random_variables(model, [jnp.asarray(batches[0][k]) for k in INPUTS])

    @jax.jit
    def train_forward(v, inputs, valid):
        (loss, logits, aux), mutated = model.apply(
            v, *inputs, valid=valid, deterministic=True, use_running_average=False,
            mutable=["batch_stats"])
        return loss, logits, aux["js_loss"], mutated["batch_stats"]

    want = []
    for b in batches:
        loss, logits, js, stats = train_forward(
            variables, [jnp.asarray(b[k]) for k in INPUTS], jnp.asarray(b["valid"]))
        # the updated statistics under the port's names
        updated = from_jax_variables(ranks.step_config("plain"), {
            "params": variables["params"],
            "batch_stats": jax.tree_util.tree_map(np.asarray, stats)})
        want.append({"loss": float(loss), "js_loss": float(js), "logits": np.asarray(logits),
                     "running": {k: v for k, v in updated.state_dict().items()
                                 if "running" in k}})
    got = {shape: spawn(ranks.forward_rank, int(np.prod(shape)), (shape, variables, batches))
           for shape in MESHES}
    return want, got


@pytest.mark.parametrize("quantity", ["loss", "js_loss", "logits", "batch_stats"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_mesh_forward_matches_jax(shape, quantity):
    want, got = reference()
    tp = shape[1] if len(shape) > 1 else 1
    for i, w in enumerate(want):
        per_rank = [r[i] for r in got[shape]]
        if quantity in ("loss", "js_loss"):
            for r in per_rank:      # the global batch's on every rank
                np.testing.assert_allclose(r[quantity], w[quantity], rtol=RTOL)
        elif quantity == "logits":
            rows = torch.cat([r["logits"] for r in per_rank[::tp]]).numpy()
            np.testing.assert_allclose(rows, w["logits"], atol=LOGITS_ATOL)
            for r, first in zip(per_rank, [p for p in per_rank[::tp] for _ in range(tp)]):
                assert torch.equal(r["logits"], first["logits"])   # model ranks agree
        else:
            assert len(w["running"]) == 2 * 3 * 2      # a BatchNorm per GLAC cell
            for r in per_rank:
                for k, v in w["running"].items():
                    np.testing.assert_allclose(r["running"][k].numpy(), v.numpy(),
                                               rtol=RTOL, err_msg=k)


@functools.lru_cache(maxsize=None)
def dropout_run():
    return spawn(ranks.dropout_rank, 4, ((2, 2),))


def _bert_calls(run):
    """The BERT sites' attention calls (the ones with dropout)."""
    return [c for c in run["calls"] if c[2] > 0]


def test_dropout_seeds_differ_across_data_ranks():
    runs = dropout_run()
    for m in range(2):
        a, b = (_bert_calls(runs[d * 2 + m]) for d in range(2))
        assert len(a) == len(b) == 3     # 2 BERT layers + the extra text layer
        assert all(x[0] != y[0] for x, y in zip(a, b))


def test_dropout_seeds_differ_across_model_ranks_at_head_sharded_sites():
    runs = dropout_run()
    for d in range(2):
        a, b = (_bert_calls(runs[d * 2 + m]) for m in range(2))
        assert all(x[0] != y[0] for x, y in zip(a, b))
        assert {x[1] for x in a + b} == {2}       # 4 heads over 2 model ranks
        # the masks of the first site differ (K1's Philox bits from the seeds)
        masks = [dropout_keep_mask(x[0], 4, 2, 16, 16, 0.1, "cpu") for x in (a[0], b[0])]
        assert not torch.equal(*masks)
        assert 0.8 < float(masks[0].float().mean()) < 1.0


def test_dropout_masks_are_the_one_process_masks_at_global_coordinates():
    """Every rank takes the step's seed as it is, its rows and heads as the
    seed's offsets (data index x 4 rows, model index x 2 heads at the
    head-split BERT sites): its K1 masks are the one-process mask of the
    whole (8, 4) batch and heads, cut to its rows and heads."""
    runs = dropout_run()
    for r in runs:
        for (seed, heads, rate), first in zip(_bert_calls(r), _bert_calls(runs[0])):
            assert heads == 2 and int(seed.seed) == int(first[0].seed)
            assert (seed.site, seed.b0, seed.h0) == (first[0].site, 4 * r["data_index"],
                                                      2 * r["model_index"])
            whole = dropout_keep_mask(seed._replace(b0=0, h0=0), 8, 4, 16, 16, rate, "cpu")
            got = dropout_keep_mask(seed, 4, 2, 16, 16, rate, "cpu")
            assert torch.equal(got, whole[seed.b0:seed.b0 + 4, seed.h0:seed.h0 + 2])


def test_replicated_activations_are_bit_equal_across_model_ranks():
    runs = dropout_run()
    for d in range(2):
        a, b = (runs[d * 2 + m]["blocks"] for m in range(2))
        assert len(a) == len(b) == 2
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not torch.equal(a[0], runs[(1 - d) * 2]["blocks"][0])   # other rows
