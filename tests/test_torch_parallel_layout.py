"""The port's tensor-parallel layout and data sharding against the JAX
package's, with no processes.

- Each model rank's slice of every parameter (``parallel.mesh.shard_model``)
  equals, in the port's layout, the shard that JAX's ``make_param_shardings``
  puts on ``mesh.devices[d, m]`` of the 8-device CPU mesh, for meshes (2, 2)
  and (2, 4), on one tree: head-aligned QKV, vocabulary rows, the
  cross-modal projections, and whole leaves where the rules match nothing;
  on a ``scan_layers`` tree too (the rule shifted past the layer axis). A
  vocabulary that the model axis does not divide stays whole, as JAX leaves
  it.
- ``DataLoader(process_shard=...)`` yields JAX's batches bit for bit for
  ranks 0 and 1 of 2, the wrap-padded final batch included, and raises as
  JAX's does.
- The mesh of one process: a mesh larger than the world raises, naming the
  world and how to start the processes; the axis order and the rank ->
  (data, model) coordinates are JAX's row-major ones.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from d2r_tpu import config as jconfig
from d2r_tpu.data import dataset as jdata
from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu.parallel.mesh import make_mesh as jax_make_mesh
from d2r_tpu.parallel.mesh import make_param_shardings
from d2r_tpu.utils.weights import stack_tower_layers
from d2r_tpu_torch import config as tconfig
from d2r_tpu_torch.data import dataset as tdata
from d2r_tpu_torch.parallel.mesh import Mesh, make_mesh, param_partition_spec, shard_model
from d2r_tpu_torch.weights import _translate, flax_path, from_jax_variables

INPUTS = ("input_ids", "attention_mask", "token_type_ids", "labels", "pixel_values")


def _tree(cfg, seed=0):
    """A seeded Flax tree of ``cfg``'s JAX model (numpy leaves)."""
    b = jdata.synthetic_batch(2, cfg.max_seq, cfg.vision_config().image_size,
                              vocab_size=cfg.text_config().vocab_size, seed=0)
    shapes = jax.eval_shape(JaxClassifier(cfg).init, jax.random.key(0),
                            *[b[k] for k in INPUTS])
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _leaf(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _jax_shard(leaf, sharding, device):
    arr = jax.device_put(leaf, sharding)
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == device)


def _check_layout(jcfg, tcfg, shape, scanned=False):
    """Every rank's slices against JAX's shards (of the tree stacked into
    the scanned layout when ``scanned``); returns the split keys."""
    tree = _tree(jcfg)
    flax_tree = {c: stack_tower_layers(t) for c, t in tree.items()} if scanned else tree
    mesh = jax_make_mesh(shape, ("data", "model"))
    shardings = make_param_shardings(flax_tree["params"], mesh)
    split = set()
    for rank in range(shape[0] * shape[1]):
        d, m = divmod(rank, shape[1])
        model = shard_model(from_jax_variables(tcfg, flax_tree), Mesh(shape[0], shape[1], rank,
                                                                     "cpu"))
        for key, t in model.named_parameters():
            path = flax_path(model, key)
            if scanned and ("encoder_text_layers/layer_" in path
                            or "encoder_vision_layers/layer_" in path):
                tower, rest = path.split("/layer_", 1)
                index, rest = rest.split("/", 1)
                spath, pick = f"{tower}/layers_scanned/layer/{rest}", int(index)
            else:
                spath, pick = path, None
            shard = _jax_shard(_leaf(flax_tree["params"], spath),
                               _leaf(shardings, spath), mesh.devices[d, m])
            if pick is not None:
                shard = shard[pick]
            *prefix, name = key.split(".")
            module = model.get_submodule(".".join(prefix))
            want = _translate(module, spath.rsplit("/", 1)[1], shard)[1]
            np.testing.assert_array_equal(t.detach().numpy(), np.ascontiguousarray(want),
                                          err_msg=f"rank {rank} {key}")
            if name in getattr(module, "shards", {}):
                split.add(key)
    return split


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_rank_slices_equal_jax_shards(eight_devices, shape):
    split = _check_layout(jconfig.tiny_test_config(), tconfig.tiny_test_config(), shape)
    layer = "model.encoder_text_layers.layer_0."
    assert {layer + "attention_self.qkv.weight", layer + "attention_self.qkv.bias",
            layer + "attention_output.dense.weight", layer + "intermediate_dense.weight",
            layer + "output_dense.weight", "model.text_embeddings.word_embeddings.weight",
            "model.itr_module.dynamic_itr_l0.imrc.sa_qkv.weight",
            "model.itr_module.dynamic_itr_l0.glac.cma.query.weight",
            "model.encoder_vision_layers.layer_1.mlp_fc1.bias"} <= split
    assert not any(k.endswith("router.mlp_0.weight") or "LayerNorm" in k or
                   k.endswith("attention_output.dense.bias") for k in split)


def test_rank_slices_equal_jax_shards_scanned(eight_devices):
    split = _check_layout(jconfig.tiny_test_config(), tconfig.tiny_test_config(scan_layers=True),
                          (2, 2), scanned=True)
    assert "model.encoder_text_layers.layer_1.attention_self.qkv.weight" in split
    assert param_partition_spec("model/encoder_text_layers/layers_scanned/layer/"
                                "attention_self/qkv/kernel") == (None, None, None, "model")


def test_indivisible_vocabulary_stays_whole(eight_devices):
    """A 130-row vocabulary at tp = 4 (130 % 4 != 0): JAX replicates it, and
    so does the port; everything else still splits."""
    odd = lambda pkg: dataclasses.replace(pkg.tiny_test_config().text_config(), vocab_size=130)
    jconfig.register_text_preset("tiny-bert-vocab-130", lambda: odd(jconfig))
    tconfig.register_text_preset("tiny-bert-vocab-130", lambda: odd(tconfig))
    split = _check_layout(jconfig.tiny_test_config(bert_name="tiny-bert-vocab-130"),
                          tconfig.tiny_test_config(bert_name="tiny-bert-vocab-130"), (2, 4))
    assert "model.text_embeddings.word_embeddings.weight" not in split
    assert "model.encoder_text_layers.layer_0.attention_self.qkv.weight" in split
    sh = make_param_shardings(_tree(jconfig.tiny_test_config(bert_name="tiny-bert-vocab-130"))[
        "params"], jax_make_mesh((2, 4), ("data", "model")))
    assert sh["model"]["text_embeddings"]["word_embeddings"]["embedding"].spec == P()


def test_heads_that_do_not_split_evenly_raise():
    """tp = 8 divides tiny-bert's 64 features but not its 4 heads: the port
    refuses the layout rather than run attention on a split head."""
    model = from_jax_variables(tconfig.tiny_test_config(), _tree(jconfig.tiny_test_config()))
    with pytest.raises(NotImplementedError, match="whole heads"):
        shard_model(model, Mesh(1, 8, 0, "cpu"))


def _loaders(pkg, paths, batch_size, shard):
    proc = pkg.MSDProcessor({k: paths[k] for k in ("train", "dev", "test")}, "no-such-vocab",
                            vocab_size=128)
    ds = pkg.MSDDataset(proc, paths["img_dir"], max_seq=8, mode="train", image_size=32,
                        num_vision_tokens=5)
    return pkg.DataLoader(ds, batch_size, shuffle=True, num_workers=2, seed=7,
                          process_shard=shard)


def test_process_shard_batches_equal_jax(tmp_path):
    paths = jdata.write_fake_dataset(str(tmp_path / "ds"), n=10, image_size=32)
    full = list(_loaders(tdata, paths, 4, None))
    assert not full[-1]["valid"].all()           # the wrap-padded final batch
    for rank in range(2):
        got = list(_loaders(tdata, paths, 4, (rank, 2)))
        want = list(_loaders(jdata, paths, 4, (rank, 2)))
        assert len(got) == len(want) == len(full) == 3
        for g, w, f in zip(got, want, full):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                np.testing.assert_array_equal(g[k], f[k][rank * 2:(rank + 1) * 2], err_msg=k)
    for shard, match in (((0, 3), "divisible"), ((2, 2), "rank")):
        for pkg in (tdata, jdata):
            with pytest.raises(ValueError, match=match):
                _loaders(pkg, paths, 4, shard)


def test_one_process_mesh():
    mesh = make_mesh((-1,), ("data",))
    assert (mesh.shape, mesh.world, mesh.data_shard) == ({"data": 1}, 1, None)
    for shape, names in (((2,), ("data",)), ((1, 2), ("data", "model")),
                         ((-1, 4), ("data", "model"))):
        with pytest.raises(ValueError, match="the world has 1 process"):
            make_mesh(shape, names)
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((-1, 4), ("data",))
    # rank -> (data, model) in JAX's row-major order
    coords = [(Mesh(2, 4, r, "cpu").data_index, Mesh(2, 4, r, "cpu").model_index)
              for r in range(8)]
    grid = np.arange(8).reshape(2, 4)
    assert all(grid[d, m] == r for r, (d, m) in enumerate(coords))
    assert list(Mesh(2, 4, 5, "cpu").shape) == ["data", "model"]
    assert Mesh(3, 1, 2, "cpu").data_shard == (2, 3)
    assert torch.device("cpu") == Mesh(1, 1, 0, "cpu").collective_device
