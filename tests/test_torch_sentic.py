"""The port's SenticNet graph refinement (``d2r_tpu_torch/data/sentic.py``,
``models/graph.py``, ``use_sentic_graph``) against the JAX package's, on the
CPU.

- The lexicon: the port's asset is the JAX package's byte for byte (one
  sha256) and both loaders return equal dicts.
- The adjacency, per text and batched, bit for bit on texts with lexicon
  words, aspect words and more words than ``max_seq``; the dataset's
  ``sentic_adj`` item and loader batch bit for bit.
- ``GraphConvolution`` within 1e-6 in fp32, from one set of weights.
- The tiny model with ``use_sentic_graph`` from one Flax tree initialised
  WITH an adjacency (a tree initialised without one has no ``sentic_gcn``):
  the GCN's output, the text branch after it and the logits within 1e-4 in
  fp32, with an adjacency and without one (the GCN is skipped, as in JAX);
  one train step's loss within 1e-4 and every gradient,
  the GCN's included, within 1e-4 of the leaf's max; ``to_jax_variables``
  gives the tree back with ``sentic_gcn``, and strict coverage refuses a
  tree without it.
"""

import copy
import functools
import hashlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2r_tpu.data import dataset as jdata
from d2r_tpu.data import sentic as jsentic
from d2r_tpu.models.graph import GraphConvolution as JaxGCN
from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu_torch.data import dataset as tdata
from d2r_tpu_torch.data import sentic as tsentic
from d2r_tpu_torch.models.graph import GraphConvolution
from d2r_tpu_torch.weights import from_jax_variables, load_jax_variables, to_jax_variables
from test_torch_qdot import assert_step_matches, jax_outputs, port_outputs, step_against_jax
from test_torch_train import GRAD_MODULES, _batch, _configs, _flat, _random_tree

# lexicon words (positive and negative), a word missing from it, an aspect
TEXTS = ["happy day with a terrible storm", "abandon all hope", "zzzz qqqq",
         "love love love the great food but the service was awful and slow "
         "and the music was far too loud for a quiet evening out", ""]
ASPECTS = ["day", "hope", "", "food service", ""]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def lexicon():
    return tsentic.load_sentic_lexicon()


def test_lexicon_is_the_jax_asset_and_loads_equal():
    digests = [hashlib.sha256(open(p, "rb").read()).hexdigest()
               for p in (tsentic.DEFAULT_LEXICON_PATH, jsentic.DEFAULT_LEXICON_PATH)]
    assert digests[0] == digests[1]
    assert tsentic.DEFAULT_LEXICON_PATH != jsentic.DEFAULT_LEXICON_PATH
    lex = lexicon()
    assert len(lex) == 39891 and lex == jsentic.load_sentic_lexicon()
    words = [w for t in TEXTS for w in t.split()]
    assert {"happy", "terrible", "abandon", "love"} <= set(lex) and "zzzz" not in lex
    assert len(TEXTS[3].split()) > 16 and any(w in lex for w in words)


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_affective_adjacency_matches_jax(i):
    got = tsentic.affective_adjacency(TEXTS[i], ASPECTS[i], lexicon())
    want = jsentic.affective_adjacency(TEXTS[i], ASPECTS[i], lexicon())
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("aspects", [None, ASPECTS])
@pytest.mark.parametrize("max_seq", [4, 16, 32])
def test_batched_adjacency_matches_jax(max_seq, aspects):
    got = tsentic.batched_affective_adjacency(TEXTS, lexicon(), max_seq, aspects)
    want = jsentic.batched_affective_adjacency(TEXTS, lexicon(), max_seq, aspects)
    assert got.shape == (len(TEXTS), max_seq, max_seq)
    np.testing.assert_array_equal(got, want)


def test_dataset_sentic_adj_matches_jax(tmp_path):
    """The item and the loader's batch (``tests/test_sentic_model.py``'s
    recipe), with the full lexicon."""
    paths = jdata.write_fake_dataset(str(tmp_path), n=6, image_size=32)
    kw = dict(max_seq=8, mode="train", image_size=32, sentic_lexicon=lexicon())
    jds = jdata.MSDDataset(jdata.MSDProcessor(paths, "no-vocab", vocab_size=500),
                           paths["img_dir"], **kw)
    tds = tdata.MSDDataset(tdata.MSDProcessor(paths, "no-vocab", vocab_size=500),
                           paths["img_dir"], **kw)
    for i in range(len(tds)):
        assert tds[i]["sentic_adj"].shape == (8, 8)
        np.testing.assert_array_equal(tds[i]["sentic_adj"], jds[i]["sentic_adj"])
    jb = next(iter(jdata.DataLoader(jds, batch_size=4, num_workers=1)))
    tb = next(iter(tdata.DataLoader(tds, batch_size=4, num_workers=1)))
    assert tb["sentic_adj"].shape == (4, 8, 8)
    np.testing.assert_array_equal(tb["sentic_adj"], jb["sentic_adj"])


def test_graph_convolution_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 10, 24)).astype(np.float32)
    adj = tsentic.batched_affective_adjacency(TEXTS[:3], lexicon(), 10, ASPECTS[:3])
    jgcn = JaxGCN(16)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32) * 0.3,
        jax.eval_shape(jgcn.init, jax.random.key(0), jnp.asarray(x), jnp.asarray(adj)))
    want = np.asarray(jgcn.apply(params, jnp.asarray(x), jnp.asarray(adj)))
    gcn = GraphConvolution(24, 16)
    with torch.no_grad():
        gcn.weight.weight.copy_(torch.tensor(params["params"]["weight"]["kernel"].T))
        gcn.bias.copy_(torch.tensor(params["params"]["bias"]))
    got = gcn(torch.tensor(x), torch.tensor(adj)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert gcn.weight.bias is None


# ---- the tiny model -------------------------------------------------------

def _adj(cfg, n=4, seed=1):
    return np.random.RandomState(seed).uniform(
        0.0, 2.0, size=(n, cfg.max_seq, cfg.max_seq)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def sentic_tree():
    """A random Flax tree of the sentic model, its shapes from an init WITH
    an adjacency, as the JAX CLI's ``--dry_run`` builds it."""
    jcfg, _ = _configs(DR_step=3, use_sentic_graph=True)
    jmodel = JaxClassifier(jcfg)
    shim = types.SimpleNamespace(init=functools.partial(
        jmodel.init, sentic_adj=jnp.asarray(_adj(jcfg))))
    tree = _random_tree(shim, _batch(jcfg), seed=9)
    assert "sentic_gcn" in tree["params"]["model"]
    return tree


# outputs compared: the logits (and the fusion, whose merge biases this
# tree sets near 1) move little over this random tiny model's rows, so the
# GCN's own output and two that read it are held too
OUTPUTS = ("model/sentic_gcn", "model/self_text", "model/text_pool", "fc")


@functools.lru_cache(maxsize=None)
def jax_forward(with_adj):
    """{module path: output} of JAX's forward on the sentic tree."""
    jcfg, _ = _configs(DR_step=3, use_sentic_graph=True)
    extra = {"sentic_adj": _adj(jcfg)} if with_adj else {}
    return jax_outputs(jcfg, sentic_tree(), _batch(jcfg), OUTPUTS, **extra)


@pytest.mark.parametrize("with_adj", [True, False], ids=["adjacency", "skip"])
def test_sentic_model_matches_jax(with_adj):
    """The GCN's output, the text branch's self-attention and pool after it,
    and the logits within 1e-4; without an adjacency neither package runs
    the GCN."""
    _, tcfg = _configs(DR_step=3, use_sentic_graph=True)
    extra = {"sentic_adj": _adj(tcfg)} if with_adj else {}
    got = port_outputs(tcfg, sentic_tree(), _batch(tcfg), OUTPUTS, **extra)
    want = jax_forward(with_adj)
    assert set(got) == set(want) == set(OUTPUTS[int(not with_adj):])
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-4, rtol=0, err_msg=path)


def test_gcn_changes_the_text_branch_only_with_an_adjacency():
    for path in ("model/self_text", "model/text_pool"):
        a, b = (jax_forward(w)[path] for w in (True, False))
        assert np.abs(a - b).max() > 1e-2, path


def test_sentic_weights_round_trip_with_strict_coverage():
    _, tcfg = _configs(DR_step=3, use_sentic_graph=True)
    tree = sentic_tree()
    model = from_jax_variables(tcfg, copy.deepcopy(tree))
    back = to_jax_variables(model)
    gcn = back["params"]["model"]["sentic_gcn"]
    assert set(gcn) == {"weight", "bias"} and set(gcn["weight"]) == {"kernel"}
    want, got = _flat(tree), _flat(back)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    no_gcn = copy.deepcopy(tree)
    del no_gcn["params"]["model"]["sentic_gcn"]
    with pytest.raises(KeyError, match="sentic_gcn"):
        load_jax_variables(model, no_gcn)
    _, plain = _configs(DR_step=3)
    with pytest.raises(KeyError, match="sentic_gcn"):
        from_jax_variables(plain, copy.deepcopy(tree))


@functools.lru_cache(maxsize=None)
def sentic_step():
    jcfg, tcfg = _configs(DR_step=3, use_sentic_graph=True)
    b = dict(_batch(jcfg), sentic_adj=_adj(jcfg))
    return step_against_jax(jcfg, tcfg, b, sentic_tree())


def test_sentic_train_step_matches_jax():
    assert_step_matches(*sentic_step(), GRAD_MODULES + ["model/sentic_gcn"])
