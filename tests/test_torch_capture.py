"""The train step as one program, on the CPU: the pieces the captured step
is made of, held to references written out here.

- Seeds from device memory: a site's Philox key is splitmix64(seed + site)
  (``csrc/dropout_philox.cuh::site_key``), written out below in plain
  Python integers; ``dropout_keep_mask`` of a ``DropoutSeed`` and the
  hidden-dropout mask are those bits; two sites and two steps differ; the
  hidden dropout's backward regenerates its mask.
- The AdamW kernel's plain twin against a numpy transcription of the
  kernel's arithmetic (every operation rounded to fp32 in the kernel's
  order), bit for bit, with fp32 and bf16 first moments; the kernel's
  device table (pointers, sizes, groups, the block map) built on CPU
  tensors.
- The train state: resuming from a checkpoint of step k gives the masks,
  losses and parameters of the uninterrupted run at step k + 1 (dropout
  on); a checkpoint of the earlier format (per-parameter CPU step tensors,
  ``LambdaLR``'s scheduled lr in the groups and its state) restores the
  count and the base lrs.

The kernels themselves, and the captured step against the eager one, are
held on the card by ``tests/test_torch_cuda.py``.
"""

import copy

import numpy as np
import pytest
import torch

from d2r_tpu_torch import config as tconfig
from d2r_tpu_torch.models.layers import DropoutRNG, fold_in
from d2r_tpu_torch.ops.kernels import adamw as tadamw
from d2r_tpu_torch.ops.kernels import dropout as tdrop
from d2r_tpu_torch.ops.kernels import fused_attention as tfa
from d2r_tpu_torch.train import checkpoint as tckpt
from d2r_tpu_torch.train.state import create_train_state, make_train_step


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the suite's other workers torch's
    default threads contend, and the tiny steps run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

M32, M64 = (1 << 32) - 1, (1 << 64) - 1


def ref_splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def ref_philox(counter, key):
    """Philox4x32-10 in Python integers (Random123's philox4x32_R)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key & M32, key >> 32
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 & M32, (p0 >> 32) ^ c3 ^ k1, p0 & M32
    return c0, c1, c2, c3


def test_site_key_is_splitmix64_of_seed_plus_site():
    for seed, site in ((0, 0), (1, 0), (2 ** 64 - 1, 1), (0x1234_5678_9ABC_DEF0, 37)):
        assert tfa.site_key(seed, site) == ref_splitmix64((seed + site) & M64)
    # the seed buffer holds the uint64 as an int64 (two's complement)
    for seed in (0, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1):
        buf = tfa.seed_tensor(seed)
        assert buf.dtype == torch.int64 and buf.shape == (1,)
        assert tfa.dropout_key(tfa.DropoutSeed(buf, 5)) == ref_splitmix64((seed + 5) & M64)


@pytest.mark.parametrize("seed", [7, 2 ** 63 + 12345])
def test_keep_mask_of_a_device_seed_is_the_c_derivation(seed):
    """``dropout_keep_mask`` of a DropoutSeed: element (b, h, i, j) is word
    j % 4 of Philox at (j // 4, i, h, b) under splitmix64(seed + site)."""
    ds = tfa.DropoutSeed(tfa.seed_tensor(seed), 9)
    mask = tfa.dropout_keep_mask(ds, 2, 3, 5, 11, 0.3)
    key = ref_splitmix64((seed + 9) & M64)
    t = tfa.keep_threshold(0.3)
    for b in range(2):
        for h in range(3):
            for i in range(5):
                for j in range(11):
                    word = ref_philox((j // 4, i, h, b), key)[j % 4]
                    assert bool(mask[b, h, i, j]) == (word >= t), (b, h, i, j)


def test_two_sites_and_two_steps_draw_different_masks():
    step_seeds = [fold_in(fold_in(3, step), 0) for step in (0, 1)]
    masks = {(s, site): tfa.dropout_keep_mask(tfa.DropoutSeed(tfa.seed_tensor(s), site),
                                              4, 2, 16, 16, 0.1)
             for s in step_seeds for site in (0, 1)}
    values = list(masks.values())
    assert all(not torch.equal(a, b) for i, a in enumerate(values) for b in values[i + 1:])
    assert all(0.8 < float(m.float().mean()) < 1.0 for m in values)


def test_hidden_dropout_is_the_flat_philox_bits_and_its_own_backward():
    """Element e takes word e % 4 at counter (e // 4, 0, 0, 0) under the
    site's key; kept values are x * fp32(1/(1-rate)); the backward is the
    same function of the gradient."""
    seed = tfa.DropoutSeed(tfa.seed_tensor(2024), 3)
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).requires_grad_()
    y = tdrop.hidden_dropout(x, 0.25, seed)
    key = ref_splitmix64(2024 + 3)
    keep = [ref_philox((e // 4, 0, 0, 0), key)[e % 4] >= tfa.keep_threshold(0.25)
            for e in range(35)]
    inv = np.float32(1 / 0.75)
    want = np.where(np.array(keep).reshape(5, 7), x.detach().numpy() * inv, 0).astype(np.float32)
    assert y.detach().numpy().tobytes() == want.tobytes()
    g = torch.randn(5, 7)
    y.backward(g)
    assert torch.equal(x.grad, tdrop.hidden_dropout_plain(g, 0.25, seed))
    assert not torch.equal(tdrop.hidden_dropout(x, 0.25, seed._replace(site=4)), y)
    assert tdrop.hidden_dropout(x, 0.0, seed) is x


def test_dropout_rng_hands_out_sites_in_order_and_folds_the_model_index():
    """Sites in order; a model rank's heads enter as the head offset ``h0``
    and a data rank's rows as ``row0``, not folded into the ordinal, so the
    masks are keyed on global coordinates."""
    rng = DropoutRNG(11, "cpu", row0=6)
    a, b = rng.next_seed(), rng.next_seed(h0=2)
    assert (a.site, b.site) == (0, 1) and a.seed is b.seed
    assert (a.b0, a.h0, b.b0, b.h0) == (6, 0, 6, 2)
    assert int(rng.seed) == 11 and rng.site == 2
    whole = tfa.dropout_keep_mask(tfa.DropoutSeed(rng.seed, 1), 8, 4, 5, 9, 0.3)
    assert torch.equal(tfa.dropout_keep_mask(b, 2, 2, 5, 9, 0.3), whole[6:, 2:])


def _np_adamw(p, g, mu, nu, lr, count, hp, sch, bf16_mu):
    """The kernel's arithmetic (csrc/adamw.cu) in numpy fp32, operation by
    operation."""
    f = np.float32
    step = f(count)
    warm = step / f(sch.warm_div)
    decay = max(f(0), (f(sch.total) - step) / f(sch.decay_div))
    neg_lr = -(f(lr) * (warm if step < f(sch.warmup) else decay))
    tt = step + f(1)
    c1 = f(1) - f(np.power(f(hp.b1), tt))
    c2 = f(1) - f(np.power(f(hp.b2), tt))
    scaled = g * f(hp.omb1)
    if bf16_mu:
        prod = (torch.from_numpy(mu.astype(np.float32) * f(hp.b1_low)).to(torch.bfloat16)
                .float().numpy())
        m = scaled + prod
    else:
        m = mu * f(hp.b1) + scaled
    v = nu * f(hp.b2) + (g * g) * f(hp.omb2)
    den = np.sqrt(v / c2) + f(hp.eps)
    u = (m / c1) / den + p * f(hp.wd)
    return p + u * neg_lr, m, v


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_adamw_twin_is_the_kernels_arithmetic(mu_dtype):
    """Three steps of the twin (16 foreach passes) against the numpy
    transcription, bit for bit: fp32 first moments, and bf16 ones rounded
    where the kernel rounds them. The counts and lrs come from the device
    count through a fractional warmup."""
    rng = np.random.default_rng(0)
    hp, sch = tadamw.hyper((0.9, 0.999), 1e-8, 1e-2), tadamw.schedule(1.5, 4)
    sizes, lrs = ((1, 3, 1023), (7, 64)), (1e-3, 5e-2)
    arrays = [[(rng.standard_normal(n).astype(np.float32),
                rng.standard_normal(n).astype(np.float32),
                (rng.standard_normal(n) * 0.1).astype(np.float32),
                (rng.standard_normal(n) ** 2 * 0.01).astype(np.float32)) for n in group]
              for group in sizes]
    if mu_dtype == torch.bfloat16:   # start from bf16-representable moments
        arrays = [[(p, g, torch.from_numpy(mu).bfloat16().float().numpy(), nu)
                   for p, g, mu, nu in group] for group in arrays]
    groups = [([torch.from_numpy(a[0].copy()) for a in group],
               [torch.from_numpy(a[1].copy()) for a in group],
               [torch.from_numpy(a[2].copy()).to(mu_dtype) for a in group],
               [torch.from_numpy(a[3].copy()) for a in group], lr)
              for group, lr in zip(arrays, lrs)]
    count = torch.zeros(())
    for step in range(3):
        tadamw.adamw_plain(groups, count, hp, sch)
        for group, lr in zip(arrays, lrs):
            for i, (p, g, mu, nu) in enumerate(group):
                p, m, v = _np_adamw(p, g, mu, nu, lr, step, hp, sch,
                                    mu_dtype == torch.bfloat16)
                if mu_dtype == torch.bfloat16:
                    m = torch.from_numpy(m).bfloat16().float().numpy()
                group[i] = (p, g, m, v)
    assert float(count) == 3.0
    for (ps, _, mus, nus, _), group in zip(groups, arrays):
        for p, mu, nu, (rp, _, rm, rv) in zip(ps, mus, nus, group):
            assert p.numpy().tobytes() == rp.tobytes()
            assert mu.float().numpy().tobytes() == rm.tobytes()
            assert nu.numpy().tobytes() == rv.tobytes()


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_adamw_table_lists_every_tensor_and_chunk(mu_dtype):
    """The kernel's table: a row a tensor (pointers, numel, group, the
    elements from 0 that take the 16-byte body), every element in exactly
    one chunk, each starting at a multiple of 4, the largest first, and the
    claim counter at 0; a tensor cut from a flat buffer off alignment takes
    the scalar body whole, a ragged one its last numel % 4 elements. bf16
    first moments need 8-byte alignment, fp32 ones 16."""
    chunk = tadamw.CHUNK
    sizes = (1, 3 * chunk, 3 * chunk + 1, 3, 4099, 64)
    ts = [[torch.zeros(n, dtype=mu_dtype if k == 2 else torch.float32) for n in sizes]
          for k in range(4)]
    ts[0][4] = torch.zeros(4099 + 1)[1:]                                 # p 4 bytes off
    ts[2][5] = torch.zeros(68, dtype=mu_dtype)[2 if mu_dtype == torch.float32 else 4:]
    groups = [(ts[0][:3], ts[1][:3], ts[2][:3], ts[3][:3], 1e-3),
              (ts[0][3:], ts[1][3:], ts[2][3:], ts[3][3:], 5e-2)]
    table = tadamw.Table(groups, tadamw.table_key(groups), torch.device("cpu"), 5)
    words = table.data.numpy()
    rows = words[:table.chunks_at].reshape(-1, 7)
    assert [tuple(r[:4]) for r in rows] == [tuple(t.data_ptr() for t in x)
                                            for x in zip(*ts)]
    assert list(rows[:, 4]) == list(sizes) and list(rows[:, 5]) == [0, 0, 0, 1, 1, 1]
    # ragged tensors stop their vectors at numel - numel % 4; the p view 4
    # bytes off, and the fp32 mu view 8 bytes off, take no vectors
    mu_vector = 64 if mu_dtype == torch.bfloat16 else 0
    assert list(rows[:, 6]) == [0, 3 * chunk, 3 * chunk, 0, 0, mu_vector]
    assert table.scalar_elements == 1 + 1 + 3 + 4099 + (64 - mu_vector)
    chunks = words[table.chunks_at:table.next_at].reshape(-1, 3)
    assert len(chunks) == table.n_chunks == sum(-(-n // chunk) for n in sizes)
    assert all(start % 4 == 0 and 0 < n <= chunk for _, start, n in chunks)
    assert list(chunks[:, 2]) == sorted(chunks[:, 2], reverse=True)
    hits = [np.zeros(n, dtype=np.int64) for n in sizes]
    for t, start, n in chunks:
        hits[t][start:start + n] += 1
    assert all((h == 1).all() for h in hits) and table.elements == sum(sizes)
    assert table.next_at == len(words) - 1 and words[table.next_at] == 0
    assert table.blocks == 5 and table.base_lr.dtype == torch.float32
    assert table.base_lr.tolist() == [float(np.float32(1e-3)), float(np.float32(5e-2))]


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, 128, size=(4, 16)).astype(np.int32)
    mask = (np.arange(16)[None] < rng.integers(4, 17, size=(4, 1))).astype(np.int32)
    return dict(input_ids=ids * mask, attention_mask=mask, token_type_ids=np.zeros_like(ids),
                labels=rng.integers(0, 3, size=4).astype(np.int32),
                pixel_values=rng.standard_normal((4, 3, 32, 32)).astype(np.float32))


def test_resume_gives_the_masks_of_the_uninterrupted_run(tmp_path):
    """Dropout on (tiny-bert's 0.1 rates): three steps straight, against two
    steps, a checkpoint with the optimizer state, a fresh state restored
    from it and the third step: the third loss and every parameter equal
    bit for bit (the masks are functions of (seed, step, site) alone)."""
    cfg = tconfig.tiny_test_config(DR_step=3, warmup_ratio=0.4, lr=1e-3)
    batches = [_batch(cfg, s) for s in range(3)]
    step = make_train_step()
    straight = create_train_state(cfg, 6, device="cpu", seed=0)
    losses = [float(step(straight, b, 9)[1]["loss"]) for b in batches]
    first = create_train_state(cfg, 6, device="cpu", seed=0)
    for b in batches[:2]:
        step(first, b, 9)
    tckpt.save_checkpoint(str(tmp_path / "ck"), first, include_opt_state=True)
    resumed = create_train_state(cfg, 6, device="cpu", seed=5)
    tckpt.restore_checkpoint(str(tmp_path / "ck"), resumed)
    assert resumed.step == 2 and float(resumed.optimizer.count) == 2
    assert float(step(resumed, batches[2], 9)[1]["loss"]) == losses[2]
    for (n, p), q in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), n


def test_a_checkpoint_of_the_earlier_format_restores_count_and_base_lrs(tmp_path):
    """The earlier format: each parameter's ``step`` a CPU tensor, the
    groups' ``lr`` the scheduled value with the base under ``initial_lr``,
    and ``LambdaLR``'s state dict under ``scheduler``."""
    cfg = tconfig.tiny_test_config(DR_step=3, warmup_ratio=0.5, lr=1e-3)
    state = create_train_state(cfg, 4, device="cpu", seed=0)
    make_train_step()(state, _batch(cfg, 0), 1)
    old = copy.deepcopy(state.optimizer.state_dict())
    for st in old["state"].values():
        st["step"] = torch.tensor(1.0)
    for g in old["param_groups"]:
        g["initial_lr"], g["lr"] = g["lr"], g["lr"] * 0.5
    sched = {"base_lrs": [g["initial_lr"] for g in old["param_groups"]], "last_epoch": 1,
             "_step_count": 2, "_get_lr_called_within_step": False,
             "_last_lr": [g["lr"] for g in old["param_groups"]], "lr_lambdas": [None]}
    path = tmp_path / "old"
    path.mkdir()
    torch.save(state.model.state_dict(), path / tckpt.MODEL_FILE)
    torch.save({"optimizer": old, "scheduler": sched, "step": 1}, path / tckpt.TRAIN_STATE_FILE)
    fresh = create_train_state(cfg, 4, device="cpu", seed=3)
    tckpt.restore_checkpoint(str(path), fresh)
    assert fresh.step == 1 and float(fresh.optimizer.count) == 1.0
    assert [g["lr"] for g in fresh.optimizer.param_groups] == [
        g["lr"] for g in state.optimizer.param_groups]
    assert all("initial_lr" not in g for g in fresh.optimizer.param_groups)
    assert all(st["step"] is fresh.optimizer.count for st in fresh.optimizer.state.values())
    b = _batch(cfg, 1)
    make_train_step()(fresh, b, 1)
    make_train_step()(state, b, 1)
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)


def test_eval_step_stays_eager_where_the_state_does_not_capture():
    """On the CPU (``captures(state)`` false) ``make_eval_step`` runs the
    eager eval forward at every call: no captured program, no warm-up
    count, and every batch's outputs its own."""
    from d2r_tpu.data.dataset import synthetic_batch
    from d2r_tpu_torch.train.state import BATCH_KEYS, captures, make_eval_step
    cfg = tconfig.tiny_test_config()
    state = create_train_state(cfg, total_steps=4, device="cpu")
    assert not captures(state)
    step = make_eval_step()
    batches = [synthetic_batch(2, cfg.max_seq, cfg.vision_config().image_size,
                               vocab_size=cfg.text_config().vocab_size, seed=s) for s in range(3)]
    outs = [step(state, b) for b in batches]
    assert state.captured is None and not state.model.training
    with torch.no_grad():
        for b, out in zip(batches, outs):
            loss, logits, _ = state.model(**{k: torch.as_tensor(b[k]) for k in BATCH_KEYS})
            assert torch.equal(out["logits"], logits) and torch.equal(out["loss"], loss)
    assert not torch.equal(outs[0]["logits"], outs[1]["logits"])
