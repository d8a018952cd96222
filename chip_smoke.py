#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``d2r_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero without the final ``ok`` line:

1. The card's name and power limit (``nvidia-smi``), then the build of every
   CUDA kernel of the port from ``d2r_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel), with the build time and the ptxas report.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   of the main path (batch 32): K1 at the BERT (L=S=64, H=12, D=64, random
   padding bias), CLIP (50/50, H12, D64) and IMRC (64/64 and 50/50, H16,
   D48) sites, in fp32 (TF32 off; max abs error <= 1e-5) and bf16 (<= 2e-2,
   one bf16 ulp of outputs below 2 plus the rounding of p). q, k and v are
   strided views of one (B, L, 3, H*D) tensor, as the QKV projection gives
   them. Times from CUDA events (L2-warm, inputs under 50 MB), calls issued
   back to back from the host (``cuda_time_ms``): the kernel, its plain
   version and ``scaled_dot_product_attention`` as a yardstick. At the
   site of the ``kernels`` line the kernel and SDPA are also timed on the
   card alone, queued behind a sleep kernel (``device_time_ms``), since a
   call's host cost can exceed a fast kernel's time. Then K1 at the edges
   of its bf16 tensor-core tiling (``K1_EDGES``: D=40, L=7 against S=128
   with a bias, L=S=D=128, L=S=1, and two views that only element loads
   stage, D=37 and rows padded by 4; the 7-row shape with dropout too),
   fp32 and bf16, errors only.
3. K3 against its plain version the same way, at D2R-large's vision-site
   geometry (B=32, L=S=257, H=16, D=64, strided QKV views, no bias), three
   off-path shapes (L=200, S=333, D=48, B=4, H=8 with a padding bias;
   L=S=1024, H=16, D=128 at batch 2; L=S=300, H=4, D=256, the widest head,
   at batch 2 with a bias) and four edges of the bf16 tiling (L=17 against
   S=300 with a bias; S=1; D=37; rows padded by 4), max abs error <= 1e-5
   in fp32 and <= 4e-3 of max(1, max |ref|) in bf16 (one ulp of outputs in
   [0.5, 1)). In bf16 at most 1% of the outputs may differ from the plain
   version's at all, and the control, p rounded to bf16 once (K1's
   rounding, which K3 does not do), must exceed that share wherever S > 1;
   times against SDPA and the bound. Then K3's autograd backward (the plain twin)
   on the card against the CPU, fp32, B=2 at the 257-token site with a
   bias: within 1e-5 of max(1, max |grad|).
4. The main path at full width, D2R-base: ``D2RClassifier`` with
   ``D2RConfig(DR_step=4, max_seq=64, compute_dtype="bfloat16")``
   (BERT-base + CLIP ViT-B/32, 768 wide, 12+1 layers a tower), random
   weights from a seeded ``torch.Generator``, behind
   ``Predictor(batch_buckets=(1, 8, 32))``, which runs each bucket as one
   CUDA graph: warmup (each bucket's eager forward, then its capture), then
   requests of 1, 3, 8, 20 and 40 rows (uint8 pixels, made with numpy from
   a seed), which replay. Launch counts are set to 0 just before the warmup
   and read after it: a wrapper counts host calls, so K1 must be called
   2 x 34 times a bucket (the eager forward and the capture), K3 never;
   the requests call no wrapper. Then at every bucket the replayed
   probabilities against the eager forward's on the same buffers (equal
   bit for bit), forward ms (CUDA events) and predict ms (host clock),
   eager beside replay, ``latency_stats`` at bucket 8, and torch.profiler
   traces of 3 eager and 3 replayed forwards at buckets 1 and 32: kernels
   per forward (34 K1 kernels by name in each, K3 none), device busy time
   and idle share, K1's and K3's share, the top kernels.
5. The same model in fp32 (TF32 off), batch 2, on the CPU through the plain
   path and on the card through the kernel: logits within 1e-3.
6. Training at full width, ``bench.py``'s recipe: the same D2R-base, batch
   64, bf16 compute, fp32 parameters, AdamW at the reference's four groups
   (``d2r_tpu_torch.train.state``), on a batch made with numpy the way
   ``synthetic_batch`` makes it (PAD ids included): 3 warm-up steps and 10
   timed ones (CUDA events, median). Counts set to 0 before, read after: K1
   and K2 must each launch 34 times a step. The loss is finite, every
   parameter and every BatchNorm running buffer has moved, and the PAD
   embedding row got an exactly zero gradient (AdamW's decoupled weight
   decay still shrinks it, as in the reference). Then a torch.profiler
   trace of one step.
7. One train step of D2R-base in fp32 (TF32 off), batch 2, dropout off
   through a registered dropout-0 preset, two ill-conditioned spots of the
   random weights moved off (see the phase), on the CPU (plain path) and on the card (K1/K2):
   loss within 1e-4; the gradients of ``fc``, one BERT ``qkv``, one CLIP
   ``qkv``, one IMRC ``sa_qkv`` and one SAF BatchNorm within 1e-3 of each
   leaf's max |grad|; the updated parameters of those leaves and the
   BatchNorm running statistics agree too. Beside it, the same step on the
   card with every attention site through the plain versions: the kernels'
   own share of the difference.
8-11. Phases 4-7 again for D2R-large, the scaled recipe
   (``tools/perf_sweep.py`` "scaled_large": RoBERTa-large + CLIP ViT-L/14,
   ``embed_size=hid_IMRC=1024``, 16 IMRC heads, 24+1 layers a tower at
   widths 1024/4096/16 heads, ``DR_step=4``, ``max_seq=64``; here without
   the recipe's three knobs ``scan_layers``, ``remat`` and bf16 Adam
   moments, which phase 15 adds). Requests and batches take RoBERTa's
   ids: ``<s>`` = 0 first, ``<pad>`` = 1 past each length. Per forward, 29
   sites on K1 (24 + 1 RoBERTa layers, 4 text-branch IMRC cells, L=S=64) and
   29 on K3 (24 + 1 CLIP-L layers, 4 image-branch IMRC cells, L=S=257):
   serving must call each wrapper 2 x 29 times a bucket at warmup and the
   traces show 29 of each a replayed forward; training at
   batch 16 launches K1, K2 and K3 29 times a step, and the PAD row is row
   1. The fp32 train step card against CPU adds the image-branch IMRC
   ``sa_qkv`` (K3's path, as the CLIP-L ``qkv`` is) to the leaves.

12. The training entry point as a user runs it: ``d2r_tpu_torch.cli.main``
   at ``run.sh``'s recipe (``TRAINER_RECIPE``: D2R-base, batch 64, bf16) for
   two epochs on ``write_fake_dataset(n=512, image_size=256,
   corrupt_every=50)`` through the port's tokenizer, decoders, loader,
   trainer and checkpoints. The items that decode to the fallback frame
   must be exactly the corrupt files. Counts set to 0 before, read after:
   34 K1 and 34 K2 launches a train step and 34 K1 an eval batch; finite
   losses; the best model and ``config.json`` saved. The trainer's own
   samples/s and the shares of its epoch loop, step time (CUDA events a
   step: median, quartiles and extremes), host wait on the loader, eval and
   checkpoint-save times and bytes, and K1's and K2's card time a step from
   the run's ``--profile_dir`` trace. Then the restore probe:
   ``--only_test --load_path <best_model>`` gives the trained run's test
   loss bit for bit.

13. The HTTP service as a user runs it: ``server.build_service`` (the code
   of ``python -m d2r_tpu_torch.server``) on a D2R-base checkpoint (the
   phase-4 model, saved with ``save_checkpoint`` and ``save_config_json``
   under ``build/``, removed at the end), buckets 1/8/32, a 5 ms batching
   window, on an ephemeral port. 256 posts made with numpy from a seed
   (texts, 256-pixel JPEGs, every 50th corrupt): (a) 64 one at a time; (b)
   192 from 16 client threads, with (d) a /reload of the same checkpoint
   issued as (b) starts and one more client posting until it returns; a
   traced burst of 32 more (one graph launch a flush, 34 K1 kernels each);
   (c) one /predict_batch of 32 (bit-equal to ``Predictor.predict`` of the
   same rows); (e) a body over ``MAX_BODY_BYTES`` (413). Every answer but (e)
   is 200, with the label of and probabilities within 2e-2 of each post
   alone; /metrics counts exactly the requests sent and one reload. HTTP ms
   p50 / p95 / p99 at (a) and (b), posts/s and mean flush size at (b), and
   replay ms by bucket. Then (a), (b), (c) and (e) again on a service of
   its own with ``--quantize int8``, whose labels must agree with the
   unquantized service's wherever that one's top probability leads by more
   than 0.1.

Phase 2 also holds K1 with dropout (rate 0.1 at the BERT site, 0.5 at the
CLIP site, batch 64) against its plain version with the same seed (same
Philox bits, so the same tolerances), and K2 against its plain version at
the four site geometries, batch 64, fp32 and bf16, at rate 0 and, at the
BERT site, 0.1, with dbias from a bias that requires grad there; K2 runs
twice and must give the same bits. In bf16 at most ``K2_BF16_DIFF_SHARE``
(1%) of each of dq, dk and dv may differ from the plain version at all,
and a control, the plain version with pd and d(logits) left unrounded,
must exceed that share. Then K2 at ``K2_EDGES`` (K1's edge geometries),
fp32 and bf16, rate 0 and 0.1, with dbias wherever there is a bias, errors
and shares only. With v = 1, sum(dv) = sum(out) checks that K2 regenerates
K1's mask. Times: K2, its plain version, SDPA's backward through autograd
as the yardstick (at the bf16 sites on the card alone too), and K2's bound
(bytes of q, k, v, g, dq, dk, dv at 3.35 TB/s against 10*B*H*L*S*D
operations at the type's peak).

14. Fine-tuning from pretrained towers, D2R-base: ``bert.pt`` (BERT-base
   keys, 12 layers) and ``clip_vit.pt`` (CLIP ViT-B/32 vision keys) written
   from seeded tensors (``fabricate_pretrained``: the keys of the port's
   mapping tables, the shapes of the tensors they land in, plus one key of
   each whitelisted kind), loaded into a model on the card by
   ``load_pretrained_params``: every tower tensor equals the file's bit for
   bit (the q/k/v rows stacked, everything else as it is). Then the CLI at
   phase 12's recipe and dataset for one epoch with ``--pretrained_dir``
   (samples/s beside phase 12's), and again with ``--freeze_towers``, whose
   best model's towers equal the files bit for bit. 34 K1 and 34 K2 a
   train step, 34 K1 an eval batch.
15. D2R-large at ``scaled_large`` as written (``SCALED_KNOBS``:
   ``scan_layers``, ``remat``, ``adam_mu_dtype="bfloat16"``; batch 16,
   uint8 pixels): weights from fabricated RoBERTa-large and CLIP ViT-L/14
   files through the scanned path, checked as in 14; 3 warm-up and 10 timed
   steps (CUDA events), step ms, samples/s and peak memory, beside the same
   weights and batch without the three knobs. ``remat`` launches each tower
   layer's attention again in the backward: 53 K1 (29 + 24 RoBERTa layers),
   29 K2 and 53 K3 (29 + 24 CLIP-L layers) a step, against 29 each without.
   One step with ``remat`` against one without from the same weights and
   batch, dropout off and then on with one seed, and the same for
   ``remat_ffn_act`` at D2R-base (batch 64): losses and updated parameters
   within 1e-6 of each leaf's max |value|, the difference reported. Then
   the CLI for one epoch of 64 posts with all of the recipe's flags and
   ``--pretrained_dir``; eval batches launch 29 K1 and 29 K3.
16. Phase 5 at ``alpha=0.5`` (CCR): logits within 1e-3, and the CCR loss of
   each of the 16 cross-modal alignments that compute one (GLAC and CRCMC,
   4 routing layers, 2 branches), which the cells discard, within 1e-3 of
   max(1, |loss|).
17. SenticNet graph refinement, D2R-base at phase 6's recipe: 13 steps (3
   warm-up, 10 timed) with and without ``use_sentic_graph`` from the same
   weights and batch, the adjacency built by the port's
   ``batched_affective_adjacency`` from fabricated texts of lexicon words
   (:func:`sentic_texts`): step ms, samples/s, peak memory, 34 K1 and 34 K2
   a step in both, the GCN's weight gets a gradient. Phase 5 and phase 7
   with the graph (the GCN's weight and bias among the leaves). Then the
   CLI at ``run.sh``'s recipe with ``--use_sentic_graph`` for one epoch on
   phase 12's 512 posts, with the loader's wait a step.
18. int8 quantized training: ``quant_dot`` card against CPU on the same
   operands at a BERT FFN product and at an odd shape that takes the
   padding to ``_int_mm``'s shapes (:data:`QDOT_SHAPES`), fp32 and bf16:
   the forward bit for bit, the backwards in fp32 within
   :data:`QDOT_BWD_TOL`; the FFN product's time beside a bf16 ``F.linear``
   and ``_int_mm`` alone. Phase 5 with ``quant_train="int8"`` (within
   :data:`QUANT_LOGITS_TOL`, equal labels). 13 bf16 steps each with
   ``quant_train`` none, int8 and int8_all from the same weights and batch
   (34 K1 and 34 K2 a step), and one traced step of each: device time of
   ``_int_mm``, of the float products and of the rest, whose growth over
   ``none`` is the quantize passes.
19. The trainer extras through the CLI at ``run.sh``'s recipe, one epoch
   on :data:`EXTRAS_DATA`: ``--dry_run`` prints the JAX CLI's keys (one
   step: 34 K1, 34 K2); ``--auto_resume`` with and without
   ``--async_checkpoint`` (the thread's best model equal bit for bit to the
   resume slot written synchronously from the same state, the test pass
   after its reload equal to a restore probe's; the two runs' weights
   compared for the record); ``--prng_impl threefry2x32`` (the rbg run's
   losses bit for bit); :data:`EXTRAS_RUNS`; then ``debug_nans`` on a batch
   with NaN pixels raises ``FloatingPointError``.

It prints one ``kernels`` JSON line (K1, K2 and K3; ``launches`` counts the
wrappers' host calls in the serving and training runs of both
configurations, the HTTP phase, phases 14-15 and the main-path runs of
phases 17-19 (not their card-against-CPU checks), a graph capture
counting once and a replay not at all; ``ms``, ``plain_ms`` and
``library_ms`` back to back from the host, ``device_ms`` and
``library_device_ms`` the card alone), the card line, and last
``{"ok": true, "device": {...}}``. The full report also goes to
``chiprun_out/chip_smoke.json``.
"""

import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core fp32; dense bf16
BUCKETS = (1, 8, 32)
REQUESTS = (1, 3, 8, 20, 40)
# (name, L=S, H, D, key bias): the four K1 geometries of the main path
K1_SITES = (("bert", 64, 12, 64, True), ("clip", 50, 12, 64, False),
            ("imrc_text", 64, 16, 48, False), ("imrc_image", 50, 16, 48, False))
K1_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# K2: scaled by max(1, max |ref|), one bf16 ulp at |x| being 2^-8 |x|
K2_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# K3: in bf16 scaled by max(1, max |ref|) too, one ulp of outputs in
# [0.5, 1), below the 1e-3 to 4e-3 that rounding p to bf16 (K1's rounding,
# not K3's) gives at the CLIP-L site
K3_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
TRAIN_BATCH = 64
WARMUP_STEPS, TIMED_STEPS = 3, 10
# K3 in bf16: the largest share of outputs that may differ from the plain
# version's at all. The kernel's arithmetic (scale after the bf16 product,
# p = hi + lo into p.V), written out in tensor ops, differs from it in about
# 0.2% of the outputs at the 257-token site (one-ulp flips where the fp32
# result lies at a rounding midpoint); rounding p to bf16 once, K1's
# rounding, in about 40% (tests/test_torch_flash_attention.py). The max
# error alone cannot tell the two apart: both stay within K3_TOL.
K3_BF16_DIFF_SHARE = 0.01
# K2 in bf16: the largest share of the dq, dk and dv outputs that may
# differ from the plain version's at all. The tensor-core kernel keeps the
# JAX kernel's rounding points, so it differs only by fp32 summation order;
# the control, the plain version with pd and d(logits) left in fp32 (the
# roundings of fused_attention.py:136 and :151 dropped, ``k2_unrounded``),
# must exceed the share wherever S > 1 (with one key d(logits) is 0 and p
# is 1). Both stay within K2_TOL, so the max error alone cannot tell
# them apart (tests/test_torch_attention_bwd.py holds the plain version's
# rounding to JAX's interpret-mode kernel).
K2_BF16_DIFF_SHARE = 0.01
# (name, B, L, S, H, D, key bias, row pad): K3 at the main-path geometry of
# D2R-large (CLIP-L layers and image-branch IMRC cells, bucket 32), then
# three off-path shapes for the loop bounds, the bias and the widest head
K3_SHAPES = (("clip_l", 32, 257, 257, 16, 64, False, 0),
             ("ragged_bias", 4, 200, 333, 8, 48, True, 0),
             ("long_d128", 2, 1024, 1024, 16, 128, False, 0),
             ("wide_d256", 2, 300, 300, 4, 256, True, 0),
             # edges of the bf16 tiling: 17 rows (one warp with 1 live row
             # of 16, three warps with none), a single key, and two views
             # that 16-byte copies cannot stage (element loads): an odd D
             # (odd-width stores too) and rows 4 elements longer than the
             # three heads' fused width
             ("l17_bias", 3, 17, 300, 4, 64, True, 0),
             ("s1", 2, 100, 1, 4, 64, False, 0),
             ("d37_odd", 2, 70, 90, 4, 37, True, 0),
             ("row_pad", 4, 257, 257, 4, 64, False, 4))
# (name, B, L, S, H, D, key bias, row pad): K1 at the edges of its bf16
# tiling: D not a multiple of 16, 7 query rows against 128 keys, the largest
# tile, one key, and the two views that only element loads stage
K1_EDGES = (("d40", 4, 64, 64, 6, 40, True, 0), ("l7_s128", 4, 7, 128, 4, 64, True, 0),
            ("d128", 2, 128, 128, 4, 128, True, 0), ("l1_s1", 8, 1, 1, 4, 64, False, 0),
            ("d37_odd", 4, 50, 50, 4, 37, True, 0), ("row_pad", 4, 64, 64, 6, 64, True, 4))
# K2 at the same edges of its bf16 tiling: 7 queries by 128 keys (one warp
# with rows, seven more with keys only), the largest tile and shared memory
# (128 by 128 by 128), dbias wherever there is a bias
K2_EDGES = K1_EDGES
# The training entry point (phase 12): run.sh's recipe (MVSA-Single:
# batch 64, max_seq 64, DR_step 4, JS weights 0.9 / 0.3, lr 1e-5, warmup
# 0.2) in bf16, on a fabricated dataset of 512 posts with 256-pixel JPEGs,
# every 50th file corrupt, for two epochs
TRAINER_RECIPE = ["--batch_size", "64", "--max_seq", "64", "--DR_step", "4",
                  "--compute_dtype", "bfloat16", "--weight_js_1", "0.9",
                  "--weight_js_2", "0.3", "--weight_diff", "0", "--lr", "1e-5",
                  "--warmup_ratio", "0.2"]
TRAINER_DATA = {"n": 512, "image_size": 256, "corrupt_every": 50}
TRAINER_EPOCHS = 2
# train steps a dispatch: one, so that CUDA events time each step; the first
# (warm-up) and the second (traced by --profile_dir) are left out of the
# step statistics, which leaves 14 of the 16 steps
TRAINER_DISPATCH = 1
# The HTTP service (phase 13): 256 posts, the first 64 sent one at a time,
# the other 192 from 16 client threads; a traced burst of 32 more; buckets
# 1/8/32 and a 5 ms batching window
SERVE_POSTS, SERVE_SEQUENTIAL, SERVE_TRACED = 256, 64, 32
SERVE_CLIENTS = 16
SERVE_MAX_WAIT_MS = 5
# D2R-large at tools/perf_sweep.py's "scaled_large" recipe as written
# (perf_sweep.py:88-92): its three knobs, batch 16, uint8 pixels; DR_step 4
# and max_seq 64 as the sweep runs every variant (perf_sweep.py:17-18, :129)
SCALED_KNOBS = dict(scan_layers=True, remat=True, adam_mu_dtype="bfloat16")
SCALED_BATCH = 16
# the recipe's CLI run: one short epoch, 64 posts a split
SCALED_CLI_DATA = {"n": 64, "image_size": 256, "corrupt_every": 50}
# the CCR weight of the alpha card-vs-CPU check
CCR_ALPHA = 0.5
# int8 quantized training (phase 18): fp32 logits card against CPU. The
# integer products are exact on both, but a quantized activation's code
# can flip where the float work before it rounds differently (one step of
# the row's scale, amax / 127), so the bound is 1e-2 with equal labels
QUANT_LOGITS_TOL = 1e-2
# quant_dot card against CPU: a BERT FFN product (batch 64 x 64 tokens =
# 4096 rows, 768 -> 3072) and an odd one that takes the padding to
# _int_mm's shapes; the backwards in fp32 within 1e-5 of the largest value
QDOT_SHAPES = (("bert_ffn", 4096, 768, 3072), ("odd", 5, 37, 3))
QDOT_BWD_TOL = 1e-5
# the trainer extras through the CLI (phase 19): run.sh's recipe for one
# epoch on a small fabricated dataset (two train steps, one dev and one
# test batch of 64 each)
EXTRAS_DATA = {"n": 128, "image_size": 256, "corrupt_every": 50}
# --prng_impl threefry2x32 against rbg through the CLI: two CLI runs on the
# card need not repeat bit for bit (the best models of two rbg runs differed
# by up to 1.86e-9 on an H100; ROADMAP.md Queue 3), so their losses are held
# within 1e-6 of max(1, |loss|)
PRNG_RUN_TOL = 1e-6
# the CLI's configurations of phases 17-19 beside the recipe's defaults
EXTRAS_RUNS = (("int8", ["--quant_train", "int8"]),
               ("int8_all", ["--quant_train", "int8_all"]),
               ("sentic_int8", ["--use_sentic_graph", "--quant_train", "int8"]),
               ("sentic_int8_all", ["--use_sentic_graph", "--quant_train", "int8_all"]),
               ("debug_nans", ["--debug_nans"]))
# The two configurations driven at full width, with their attention sites a
# forward: K1 at L, S <= 128 (K2 their backward in training), K3 at the
# 257-token vision sites. D2R-base is the serving and bench recipe
# (tools/serve_bench.py:66-67, bench.py): BERT-base + CLIP ViT-B/32, 13 BERT
# + 13 CLIP + 8 IMRC sites. D2R-large is the scaled recipe
# (tools/perf_sweep.py:88-92, "scaled_large"): RoBERTa-large + CLIP ViT-L/14,
# 25 RoBERTa + 4 text-branch IMRC sites on K1, 25 CLIP-L + 4 image-branch
# IMRC sites on K3; phases 8-11 run it without the recipe's three knobs
# (scan_layers, remat, bf16 Adam moments), phase 15 with them.
MODELS = {
    "base": {"label": "D2R-base", "suffix": "", "tag": "", "k1": 34, "k3": 0,
             "train_batch": TRAIN_BATCH, "cfg": dict(DR_step=4, max_seq=64)},
    "large": {"label": "D2R-large", "suffix": "_large", "tag": " large", "k1": 29, "k3": 29,
              "train_batch": 16,
              "cfg": dict(bert_name="roberta-large", vit_name="clip-vit-large-patch14",
                          embed_size=1024, num_head_IMRC=16, hid_IMRC=1024, DR_step=4,
                          max_seq=64)},
}


def model_config(key, **overrides):
    from d2r_tpu_torch.config import D2RConfig
    return D2RConfig(**{**MODELS[key]["cfg"], **overrides})


def log(msg):
    print(msg, flush=True)


def memory_gb():
    """The card's memory after a phase: allocated and reserved by this
    process now, and the peak allocated since the last reset (phases that
    report their own peak reset it)."""
    import torch
    return {"allocated": torch.cuda.memory_allocated() / 1e9,
            "reserved": torch.cuda.memory_reserved() / 1e9,
            "peak_allocated": torch.cuda.max_memory_allocated() / 1e9}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters=50, warmup=5):
    """ms a call of ``fn`` from CUDA events around ``iters`` calls issued
    back to back from the host: what a caller pays. Where the host's cost of
    issuing a call (the wrapper's checks, ctypes, autograd) exceeds the
    card's time, this is the host's time. Every ``ms``, ``plain_ms`` and
    ``library_ms`` of the report."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters=50, warmup=5):
    """ms of card time a call of ``fn``: the ``iters`` calls are queued
    behind a sleep kernel that outlasts the host's issuing of them (twice
    the warm-up's time a call, at most 1 s), so the card runs them back to
    back and the events time the card alone. Only for calls that issue few
    kernels (the launch queue must hold them all)."""
    import torch
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / warmup
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * iters * host_s, 1.0) * 2e9))  # cycles; clocks <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(kernel, library, iters=50):
    """``device_ms`` of the kernel's wrapper and ``library_device_ms`` of
    the library call, at the sites of the ``kernels`` line."""
    return {"device_ms": device_time_ms(kernel, iters),
            "library_device_ms": device_time_ms(library, iters)}


def device_note(r):
    """The card-time readings of a row, where it has them, for its log line."""
    if "device_ms" not in r:
        return ""
    return (f"; card time alone: kernel {r['device_ms'] * 1e3:.2f} us, "
            f"library {r['library_device_ms'] * 1e3:.2f} us")


def phase_build(report):
    from d2r_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(build.SOURCES)} kernel source(s) in {report['build_s']:.1f} s")
    for name, out in reports.items():
        for line in out.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "smem")):
                log(f"[build] {name}: {line.strip()}")


def k1_inputs(b, l, h, d, with_bias, dtype, seed):
    """q, k, v as strided views of one (B, L, 3, H*D) tensor, plus a padding
    bias made the way padding_key_bias makes it."""
    import torch
    from d2r_tpu_torch.ops.attention import padding_key_bias
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, l, 3, h * d), generator=g, device="cuda").to(dtype)
    q, k, v = (qkv[:, :, i].view(b, l, h, d) for i in range(3))
    bias = None
    if with_bias:
        lengths = torch.randint(4, l + 1, (b, 1), generator=g, device="cuda")
        mask = (torch.arange(l, device="cuda")[None, :] < lengths).int()
        bias = padding_key_bias(mask)
    return q, k, v, bias


def k1_bound(b, l, s, h, d, dtype_name, with_bias):
    item = 4 if dtype_name == "float32" else 2
    nbytes = (2 * b * l * h * d + 2 * b * s * h * d) * item + (b * s * 4 if with_bias else 0)
    ops = 4 * b * h * l * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(report):
    import torch
    import torch.nn.functional as F
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, failures = [], []
    b = 32
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for i, (site, l, h, d, with_bias) in enumerate(K1_SITES):
            q, k, v, bias = k1_inputs(b, l, h, d, with_bias, dtype, seed=100 + i)
            scale = d ** -0.5
            out = fa.fused_attention_small(q, k, v, bias, scale)
            torch.cuda.synchronize()
            ref = fa.fused_attention_small_plain(q, k, v, bias, scale)
            err = (out.float() - ref.float()).abs().max().item()
            if not (err <= K1_TOL[dtype_name] and torch.isfinite(out).all().item()):
                failures.append(f"K1 {site} {dtype_name}: max abs err {err}")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None if bias is None else bias.to(dtype)[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)
            bound_ms, bound_by = k1_bound(b, l, l, h, d, dtype_name, with_bias)
            kernel = lambda: fa.fused_attention_small(q, k, v, bias, scale)
            rows.append({
                "site": site, "dtype": dtype_name, "B": b, "L": l, "S": l, "H": h, "D": d,
                "max_abs_err": err,
                # an independent cross-check, not a pass criterion
                "sdpa_max_abs_diff": (out.float() - sdpa().transpose(1, 2).float()).abs().max().item(),
                "ms": cuda_time_ms(kernel),
                "plain_ms": cuda_time_ms(lambda: fa.fused_attention_small_plain(q, k, v, bias, scale)),
                "library_ms": cuda_time_ms(sdpa),
                "bound_ms": bound_ms, "bound_by": bound_by})
            r = rows[-1]
            if (site, dtype_name) == ("bert", "bfloat16"):   # the kernels line's site
                r.update(device_times(kernel, sdpa))
            log(f"[K1] {site:10s} {dtype_name:8s} B{b} L=S={l} H{h} D{d}: err {err:.3g} "
                f"(vs sdpa {r['sdpa_max_abs_diff']:.3g}) "
                f"kernel {r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
                f"sdpa {r['library_ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({bound_by})"
                + device_note(r))
    report["k1_sites"] = rows
    report["k1_edges"] = k1_edge_checks(failures)
    report["k1_dropout"] = k1_dropout_checks(failures)
    report["k2_sites"] = k2_checks(failures)
    report["dropout_identity"] = dropout_identity(failures)
    if failures:
        raise AssertionError("; ".join(failures))


def k1_edge_checks(failures):
    """K1 against its plain version at ``K1_EDGES``, fp32 and bf16, and with
    dropout (rate 0.1, the same seed on both sides) at 7 rows by 128 keys."""
    import torch
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    rows = []
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for i, (site, b, l, s, h, d, with_bias, pad) in enumerate(K1_EDGES):
            q, k, v, bias = k3_inputs(b, l, s, h, d, with_bias, dtype, seed=700 + i, row_pad=pad)
            for rate in ((0.0, 0.1) if site == "l7_s128" else (0.0,)):
                seed = 2 ** 33 + i if rate else None
                out = fa.fused_attention_small(q, k, v, bias, d ** -0.5, rate, seed)
                torch.cuda.synchronize()
                ref = fa.fused_attention_small_plain(q, k, v, bias, d ** -0.5, rate, seed)
                err = (out.float() - ref.float()).abs().max().item()
                if not (err <= K1_TOL[dtype_name] and torch.isfinite(out).all().item()):
                    failures.append(f"K1 edge {site} {dtype_name} rate {rate}: max abs err {err}")
                rows.append({"site": site, "dtype": dtype_name, "B": b, "L": l, "S": s, "H": h,
                             "D": d, "bias": with_bias, "row_pad": pad, "rate": rate,
                             "max_abs_err": err})
                log(f"[K1 edge] {site:8s} {dtype_name:8s} B{b} L{l} S{s} H{h} D{d} "
                    f"row pad {pad} rate {rate}: err {err:.3g}")
    return rows


def k1_dropout_checks(failures):
    """K1 with dropout against its plain version (same seed, same bits), at
    the training batch: rate 0.1 at the BERT site, 0.5 at the CLIP site."""
    import torch
    import torch.nn.functional as F
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    rows, b = [], TRAIN_BATCH
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for (site, l, h, d, with_bias), rate in ((K1_SITES[0], 0.1), (K1_SITES[1], 0.5)):
            q, k, v, bias = k1_inputs(b, l, h, d, with_bias, dtype, seed=200)
            scale, seed = d ** -0.5, 2 ** 40 + 17
            run = lambda: fa.fused_attention_small(q, k, v, bias, scale, rate, seed)
            out = run()
            torch.cuda.synchronize()
            ref = fa.fused_attention_small_plain(q, k, v, bias, scale, rate, seed)
            err = (out.float() - ref.float()).abs().max().item()
            kept = fa.dropout_keep_mask(seed, b, h, l, l, rate, "cuda").float().mean().item()
            if not (err <= K1_TOL[dtype_name] and torch.isfinite(out).all().item()):
                failures.append(f"K1 dropout {site} {dtype_name}: max abs err {err}")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None if bias is None else bias.to(dtype)[:, None, None, :]
            bound_ms, bound_by = k1_bound(b, l, l, h, d, dtype_name, with_bias)
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                          dropout_p=rate, scale=scale)
            rows.append({
                "site": site, "dtype": dtype_name, "B": b, "L": l, "H": h, "D": d,
                "rate": rate, "max_abs_err": err, "ms": cuda_time_ms(run),
                "plain_ms": cuda_time_ms(lambda: fa.fused_attention_small_plain(
                    q, k, v, bias, scale, rate, seed)),
                "library_ms": cuda_time_ms(sdpa),
                "bound_ms": bound_ms, "bound_by": bound_by})
            r = rows[-1]
            if (site, dtype_name) == ("bert", "bfloat16"):   # the training path's site
                r.update(device_times(run, sdpa))
            log(f"[K1 dropout] {site:5s} {dtype_name:8s} B{b} rate {rate}: err {err:.3g}, "
                f"keep share {kept:.4f}, kernel {r['ms'] * 1e3:.2f} us, plain "
                f"{r['plain_ms'] * 1e3:.2f} us, sdpa {r['library_ms'] * 1e3:.2f} us, "
                f"bound {bound_ms * 1e3:.2f} us" + device_note(r))
    return rows


def k2_bound(b, l, s, h, d, dtype_name):
    item = 4 if dtype_name == "float32" else 2
    nbytes = (4 * b * l * h * d + 3 * b * s * h * d) * item   # q, g, dq; k, v, dk, dv
    ops = 10 * b * h * l * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k2_unrounded(q, k, v, bias, g, scale, rate, seed):
    """The control of the bf16 share check: K2's plain version on fp32
    copies of the inputs, so that pd and d(logits) stay fp32 before their
    products, with dq, dk, dv rounded once to the inputs' type."""
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    out = fa.fused_attention_small_bwd_plain(q.float(), k.float(), v.float(), bias, g.float(),
                                             scale, rate, seed)
    return [x.to(q.dtype) for x in out[:3]]


def k2_compare(q, k, v, bias, g, scale, rate, seed, need_dbias):
    """K2 twice against its plain version: the errors of dq, dk, dv (and
    dbias when asked) and, in bf16, the shares of outputs that differ from
    the plain version at all, the kernel's and the unrounded control's.
    Returns (errs, shares, ok)."""
    import torch
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    run = lambda: fa.fused_attention_small_bwd(q, k, v, bias, g, scale, rate, seed,
                                               need_dbias=need_dbias)
    before = fa.fused_attention_small_bwd.launches
    got, again = run(), run()
    torch.cuda.synchronize()
    ref = fa.fused_attention_small_bwd_plain(q, k, v, bias, g, scale, rate, seed)
    dtype_name = str(q.dtype).split(".")[-1]
    errs, shares = {}, {}
    ok = fa.fused_attention_small_bwd.launches == before + 2
    for name, x, y, z in zip(("dq", "dk", "dv"), got, again, ref):
        errs[name] = (x.float() - z.float()).abs().max().item()
        tol = K2_TOL[dtype_name] * max(1.0, z.float().abs().max().item())
        ok = ok and errs[name] <= tol and torch.equal(x, y) and torch.isfinite(x).all().item()
    if need_dbias:
        errs["dbias"] = (got[3] - ref[3]).abs().max().item()
        ok = ok and errs["dbias"] <= 1e-4 * max(1.0, ref[3].abs().max().item())
    if q.dtype == torch.bfloat16:
        control = k2_unrounded(q, k, v, bias, g, scale, rate, seed)
        for name, x, c, z in zip(("dq", "dk", "dv"), got, control, ref):
            shares[name] = (x != z).float().mean().item()
            shares[name + "_control"] = (c != z).float().mean().item()
            ok = ok and shares[name] <= K2_BF16_DIFF_SHARE and (
                k.shape[1] == 1 or shares[name + "_control"] > K2_BF16_DIFF_SHARE)
    return errs, shares, ok


def share_note(shares):
    """The bf16 shares of a K2 check, for its log line."""
    if not shares:
        return ""
    return ("; differs from plain in " + ", ".join(
        f"{n} {shares[n]:.3g} (control {shares[n + '_control']:.3g})" for n in ("dq", "dk", "dv")))


def k2_checks(failures):
    """K2 against its plain version at the four site geometries, batch 64,
    fp32 and bf16, rate 0 and (BERT) 0.1; dbias at the BERT site; the same
    bits on a second run; in bf16 the share of outputs that differ, against
    the unrounded control. Times against SDPA's backward, the bf16 sites on
    the card alone too. Then ``K2_EDGES``, errors and shares only."""
    import torch
    import torch.nn.functional as F
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    rows, b = [], TRAIN_BATCH
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        cases = [(site, 0.0) for site in K1_SITES] + [(K1_SITES[0], 0.1)]
        for i, ((site, l, h, d, with_bias), rate) in enumerate(cases):
            q, k, v, bias = k1_inputs(b, l, h, d, with_bias, dtype, seed=300 + i)
            g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(i),
                            device="cuda").to(dtype)
            scale, seed = d ** -0.5, (12345 if rate else None)
            need_dbias = with_bias
            errs, shares, ok = k2_compare(q, k, v, bias, g, scale, rate, seed, need_dbias)
            if not ok:
                failures.append(f"K2 {site} {dtype_name} rate {rate}: errs {errs}, "
                                f"shares {shares}")
            run = lambda: fa.fused_attention_small_bwd(q, k, v, bias, g, scale, rate, seed,
                                                       need_dbias=need_dbias)
            qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            mask = None if bias is None else bias.to(dtype)[:, None, None, :]
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 dropout_p=rate, scale=scale)
            gt = g.transpose(1, 2).contiguous()
            sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)
            bound_ms, bound_by = k2_bound(b, l, l, h, d, dtype_name)
            rows.append({
                "site": site, "dtype": dtype_name, "B": b, "L": l, "H": h, "D": d,
                "rate": rate, "dbias": need_dbias, "max_abs_err": max(errs.values()),
                "errs": errs, **({"diff_shares": shares} if shares else {}),
                "ms": cuda_time_ms(run),
                "plain_ms": cuda_time_ms(lambda: fa.fused_attention_small_bwd_plain(
                    q, k, v, bias, g, scale, rate, seed)),
                "library_ms": cuda_time_ms(sdpa_bwd),
                "bound_ms": bound_ms, "bound_by": bound_by})
            r = rows[-1]
            if dtype_name == "bfloat16":   # the kernels line's site is BERT at rate 0.1
                r.update(device_times(run, sdpa_bwd))
            log(f"[K2] {site:10s} {dtype_name:8s} B{b} rate {rate}: errs "
                f"{ {k_: float(f'{v_:.3g}') for k_, v_ in errs.items()} }{share_note(shares)}, "
                f"kernel {r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
                f"sdpa bwd {r['library_ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
                f"({bound_by})" + device_note(r))
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for i, (site, b, l, s, h, d, with_bias, pad) in enumerate(K2_EDGES):
            q, k, v, bias = k3_inputs(b, l, s, h, d, with_bias, dtype, seed=800 + i, row_pad=pad)
            g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(900 + i),
                            device="cuda").to(dtype)
            for rate in (0.0, 0.1):
                seed = 2 ** 35 + i if rate else None
                errs, shares, ok = k2_compare(q, k, v, bias, g, d ** -0.5, rate, seed, with_bias)
                if not ok:
                    failures.append(f"K2 edge {site} {dtype_name} rate {rate}: errs {errs}, "
                                    f"shares {shares}")
                rows.append({"site": "edge_" + site, "dtype": dtype_name, "B": b, "L": l,
                             "S": s, "H": h, "D": d, "rate": rate, "dbias": with_bias,
                             "row_pad": pad, "max_abs_err": max(errs.values()), "errs": errs,
                             **({"diff_shares": shares} if shares else {})})
                log(f"[K2 edge] {site:8s} {dtype_name:8s} B{b} L{l} S{s} H{h} D{d} row pad {pad} "
                    f"rate {rate}: errs { {k_: float(f'{v_:.3g}') for k_, v_ in errs.items()} }"
                    f"{share_note(shares)}")
    return rows


def dropout_identity(failures):
    """With v = 1: sum(dv) = sum(out) only if K2 drew K1's mask."""
    import torch
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    q, k, _, bias = k1_inputs(8, 64, 12, 64, True, torch.float32, seed=400)
    v = torch.ones_like(q).requires_grad_()
    out = fa.fused_attention_small(q, k, v, bias, 0.125, 0.5, 1234)
    out.sum().backward()
    a, b = v.grad.sum().item(), out.sum().item()
    log(f"[K1/K2 dropout identity] sum(dv) {a:.6f}, sum(out) {b:.6f}")
    if not abs(a - b) <= 1e-3 * abs(b):
        failures.append(f"dropout identity: sum(dv) {a} != sum(out) {b}")
    return {"sum_dv": a, "sum_out": b}


def k3_inputs(b, l, s, h, d, with_bias, dtype, seed, row_pad=0):
    """q, k, v for K3 (and K1's edges). At L = S they are strided views of
    one (B, L, 3*H*D + row_pad) tensor, as the QKV projection gives them
    when row_pad is 0; otherwise q is a view of a (B, L, 2*H*D + row_pad)
    tensor and k, v of one (B, S, 2*H*D + row_pad), strided all the same.
    The bias is a random padding bias."""
    import torch
    from d2r_tpu_torch.ops.attention import padding_key_bias
    g = torch.Generator(device="cuda").manual_seed(seed)
    hd = h * d
    view = lambda x, i, n: x[:, :, i * hd:(i + 1) * hd].view(b, n, h, d)
    if l == s:
        qkv = torch.randn((b, l, 3 * hd + row_pad), generator=g, device="cuda").to(dtype)
        q, k, v = (view(qkv, i, l) for i in range(3))
    else:
        qx = torch.randn((b, l, 2 * hd + row_pad), generator=g, device="cuda").to(dtype)
        kv = torch.randn((b, s, 2 * hd + row_pad), generator=g, device="cuda").to(dtype)
        q = view(qx, 0, l)
        k, v = (view(kv, i, s) for i in range(2))
    bias = None
    if with_bias:
        lengths = torch.randint(4, s + 1, (b, 1), generator=g, device="cuda")
        bias = padding_key_bias((torch.arange(s, device="cuda")[None, :] < lengths).int())
    return q, k, v, bias


def phase_k3(report):
    """K3 against its plain version on the card at the main-path geometry
    (CLIP-L and image-branch IMRC sites, batch 32), three off-path shapes
    and the edges of the bf16 tiling, fp32 (TF32 off) and bf16 (error
    scaled by max(1, max |ref|), and the share of outputs that differ at
    all, against a control that rounds p once); times against SDPA and the
    bound; the autograd backward (the plain twin) on the card against the
    CPU."""
    import torch
    import torch.nn.functional as F
    from d2r_tpu_torch.ops.kernels import flash_attention as fl
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, failures = [], []
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for i, (site, b, l, s, h, d, with_bias, pad) in enumerate(K3_SHAPES):
            q, k, v, bias = k3_inputs(b, l, s, h, d, with_bias, dtype, seed=500 + i, row_pad=pad)
            scale = d ** -0.5
            before = fl.flash_attention.launches
            out = fl.flash_attention(q, k, v, bias, scale)
            torch.cuda.synchronize()
            ref = fl.flash_attention_plain(q, k, v, bias, scale)
            err = (out.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            size = max(1.0, ref_max) if dtype == torch.bfloat16 else 1.0
            if not (err <= K3_TOL[dtype_name] * size and torch.isfinite(out).all().item()
                    and fl.flash_attention.launches == before + 1):
                failures.append(f"K3 {site} {dtype_name}: max abs err {err} "
                                f"(max |ref| {ref_max})")
            rounding = {}
            if dtype == torch.bfloat16:
                # the control is K1's plain version: p rounded to bf16 once;
                # with one key p = 1 is exact, so it cannot differ there
                once = fa.fused_attention_small_plain(q, k, v, bias, scale)
                rounding = {"diff_share": (out != ref).float().mean().item(),
                            "control_diff_share": (once != ref).float().mean().item(),
                            "mean_abs_err": (out.float() - ref.float()).abs().mean().item()}
                if not (rounding["diff_share"] <= K3_BF16_DIFF_SHARE
                        and (s == 1 or rounding["control_diff_share"] > K3_BF16_DIFF_SHARE)):
                    failures.append(f"K3 {site} bf16 rounding: {rounding}")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None if bias is None else bias.to(dtype)[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)
            kernel = lambda: fl.flash_attention(q, k, v, bias, scale)
            bound_ms, bound_by = k1_bound(b, l, s, h, d, dtype_name, with_bias)
            rows.append({
                "site": site, "dtype": dtype_name, "B": b, "L": l, "S": s, "H": h, "D": d,
                "bias": with_bias, "row_pad": pad, "max_abs_err": err, "max_abs_ref": ref_max,
                **rounding,
                "sdpa_max_abs_diff": (out.float() - sdpa().transpose(1, 2).float()).abs().max().item(),
                "ms": cuda_time_ms(kernel, iters=20),
                "plain_ms": cuda_time_ms(lambda: fl.flash_attention_plain(q, k, v, bias, scale),
                                         iters=20),
                "library_ms": cuda_time_ms(sdpa, iters=20),
                "bound_ms": bound_ms, "bound_by": bound_by})
            r = rows[-1]
            if (site, dtype_name) == ("clip_l", "bfloat16"):   # the kernels line's site
                r.update(device_times(kernel, sdpa, iters=20))
            share = (f"; differs from plain in {rounding['diff_share']:.3g} of outputs "
                     f"(p rounded once: {rounding['control_diff_share']:.3g}), mean abs err "
                     f"{rounding['mean_abs_err']:.3g}" if rounding else "")
            log(f"[K3] {site:11s} {dtype_name:8s} B{b} L{l} S{s} H{h} D{d} row pad {pad}: "
                f"err {err:.3g} (max |ref| {ref_max:.3g}; vs sdpa {r['sdpa_max_abs_diff']:.3g})"
                f"{share}; kernel {r['ms'] * 1e3:.2f} us, "
                f"plain {r['plain_ms'] * 1e3:.2f} us, sdpa {r['library_ms'] * 1e3:.2f} us, "
                f"bound {bound_ms * 1e3:.2f} us ({bound_by})" + device_note(r))
    report["k3_sites"] = rows

    # backward: the plain twin through autograd, card against CPU (fp32)
    _, b, l, s, h, d, _, _ = K3_SHAPES[0]
    q, k, v, bias = k3_inputs(2, l, s, h, d, True, torch.float32, seed=600)
    g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(601),
                    device="cuda")
    errs = {}
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [x.detach().to(dev).contiguous().requires_grad_() for x in (q, k, v)]
        out = fl.flash_attention(*leaves, bias.to(dev), d ** -0.5)
        out.backward(g.to(dev))
        grads.append([x.grad.cpu() for x in leaves])
    for name, got, ref in zip(("dq", "dk", "dv"), *grads):
        errs[name] = (got - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    report["k3_backward_card_vs_cpu"] = errs
    log(f"[K3 backward] fp32 B2 L=S={l}, bias: card against CPU, error / max(1, max |ref|): "
        f"{ {n: float(f'{e:.3g}') for n, e in errs.items()} }")
    if not max(errs.values()) <= 1e-5:
        failures.append(f"K3 backward card vs CPU: {errs}")
    if failures:
        raise AssertionError("; ".join(failures))


def special_ids(tc):
    """(first-token id, PAD id) of the text tower's vocabulary: RoBERTa's
    ``<s>`` = 0 and ``<pad>`` = 1; for BERT the ``[CLS]`` = 2 and PAD 0 that
    ``d2r_tpu/data/dataset.py::synthetic_batch`` draws."""
    return (0 if tc.position_style == "roberta" else 2), tc.pad_token_id


def make_requests(cfg, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    tc, vc = cfg.text_config(), cfg.vision_config()
    first, pad = special_ids(tc)
    out = []
    for n in REQUESTS:
        lengths = rng.integers(4, cfg.max_seq + 1, size=n)
        mask = (np.arange(cfg.max_seq)[None, :] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(5, tc.vocab_size, size=(n, cfg.max_seq)).astype(np.int32)
        ids = np.where(mask == 1, ids, pad).astype(np.int32)
        ids[:, 0] = first
        pixels = rng.integers(0, 256, size=(n, 3, vc.image_size, vc.image_size)).astype(np.uint8)
        out.append((ids, mask, np.zeros_like(ids), pixels))
    return out


def counters():
    """The launch counters of the kernels whose launches a forward makes."""
    from d2r_tpu_torch.ops.kernels import flash_attention as fl
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    return {"k1": fa.fused_attention_small, "k2": fa.fused_attention_small_bwd,
            "k3": fl.flash_attention}


def zero_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def phase_main_path(report, key="base"):
    """Serving at full width through ``Predictor``: warmup (one CUDA graph a
    bucket: an eager forward, then its capture), requests (replays), the
    launch counts at capture, replay against eager at every bucket, forward
    and predict ms eager beside replay, ``latency_stats`` at bucket 8, and
    profiles of eager and replayed forwards at buckets 1 and 32."""
    import numpy as np
    import torch
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.serve import Predictor, latency_stats

    spec = MODELS[key]
    tag = f"[main{spec['tag']}]"
    cfg = model_config(key, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    pred = Predictor(cfg, model, batch_buckets=BUCKETS, device="cuda")
    params = sum(p.numel() for p in model.parameters())
    log(f"{tag} {spec['label']} bf16 built in {time.perf_counter() - t0:.1f} s "
        f"({params / 1e6:.1f} M parameters)")
    requests = make_requests(cfg)

    # the main path: warmup captures every bucket (each capture runs the
    # eager forward once, then records it: two host calls a site), then the
    # requests replay graphs and call no wrapper
    zero_counts()
    t0 = time.perf_counter()
    pred.warmup()
    warm_s = time.perf_counter() - t0
    launches = read_counts()
    log(f"{tag} warmup of buckets {BUCKETS} (eager forward + capture each): {warm_s:.1f} s; "
        f"host calls K1 {launches['k1']}, K3 {launches['k3']}")
    for name in ("k1", "k3"):
        want = 2 * spec[name] * len(BUCKETS)
        assert launches[name] == want, (
            f"{name.upper()} called {launches[name]} times at warmup, expected 2 x "
            f"{spec[name]} x {len(BUCKETS)} (eager + capture a bucket)")
    for ids, mask, tt, pixels in requests:
        n = ids.shape[0]
        out = pred.predict(ids, mask, tt, pixels)
        probs = out["probs"]
        assert probs.shape == (n, cfg.num_classes), probs.shape
        assert out["label"].shape == (n,), out["label"].shape
        assert np.isfinite(probs).all(), "non-finite probabilities"
        assert np.abs(probs.sum(-1) - 1.0).max() <= 1e-3, probs.sum(-1)
        log(f"{tag} request of {n:2d} rows: labels {np.bincount(out['label'], minlength=3).tolist()}, "
            f"max prob {probs.max():.4f}")
    assert read_counts() == launches, ("a replay called a kernel wrapper", read_counts())
    assert sorted(pred.graphs) == [(b, np.dtype(np.uint8)) for b in BUCKETS], list(pred.graphs)

    # replay against eager on the same static buffers, and the timings
    ids, mask, tt, pixels = requests[-1]
    latency, equal = {}, {}
    for b in BUCKETS:
        g = pred.graph(b)
        rows = (ids[:b], mask[:b], tt[:b], pixels[:b])
        pred._stage(g, rows)
        replayed = pred._replay(g, b)
        eager = pred._forward(*g.inputs).cpu().numpy()
        equal[b] = {"bit_equal": bool(np.array_equal(replayed, eager)),
                    "max_abs_diff": float(np.abs(replayed - eager).max())}
        timed = {}
        for mode, fn in (("eager", lambda: pred._forward(*g.inputs)),
                         ("replay", g.graph.replay)):
            ms = []
            for _ in range(7):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            timed[mode] = ms
        e2e = {"eager": [], "replay": []}
        for _ in range(5):
            t0 = time.perf_counter()   # the eager predict: pad, copy, forward, download
            pred._forward(*pred._padded(rows, b)).cpu().numpy()
            e2e["eager"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            pred.predict(*rows)
            e2e["replay"].append((time.perf_counter() - t0) * 1e3)
        latency[b] = {f"{m}_forward_ms_median": float(np.median(timed[m])) for m in timed}
        latency[b].update({f"{m}_predict_ms_median": float(np.median(e2e[m])) for m in e2e})
        latency[b].update({"forward_ms": timed, "predict_ms": e2e})
        log(f"{tag} bucket {b:2d}: replay {'==' if equal[b]['bit_equal'] else '!='} eager "
            f"(max abs diff {equal[b]['max_abs_diff']:.3g}); forward eager "
            f"{latency[b]['eager_forward_ms_median']:.2f} / replay "
            f"{latency[b]['replay_forward_ms_median']:.2f} ms (CUDA events, median of 7); "
            f"predict eager {latency[b]['eager_predict_ms_median']:.2f} / replay "
            f"{latency[b]['replay_predict_ms_median']:.2f} ms (host clock, median of 5)")
    stats8 = {}
    batch8 = dict(zip(("input_ids", "attention_mask", "token_type_ids", "pixel_values"),
                      (x[:8] for x in requests[-1])))
    for resident in (False, True):
        st = latency_stats(pred, batch8, iters=20, warmup=3, device_resident=resident)
        stats8["device_resident" if resident else "predict"] = {k: v * 1e3 for k, v in st.items()}
    log(f"{tag} latency_stats, bucket 8 (ms): " + json.dumps(stats8))
    result = report["main" + spec["suffix"]] = {
        "config": spec["label"], "parameters": params, "warmup_s": warm_s,
        "k1_launches": launches["k1"], "k3_launches": launches["k3"],
        "replay_vs_eager": equal, "latency": latency, "latency_stats_b8_ms": stats8}

    for b in (1, BUCKETS[-1]):
        g = pred.graph(b)
        for mode, fn in (("eager", lambda: pred._forward(*g.inputs)), ("replay", g.graph.replay)):
            result[f"profile_{mode}_b{b}"] = prof = device_profile(fn, 3, "forward")
            log(f"[profile{spec['tag']}] {mode} bucket {b:2d}: " + json.dumps(prof))
            for name in ("k1", "k3"):
                got = prof.get(f"{name}_kernels_per_forward")
                assert got == spec[name], (
                    f"{mode} bucket {b}: {got} {name.upper()} kernels a forward in the "
                    f"trace, expected {spec[name]}")
    bad = [b for b in BUCKETS if not equal[b]["bit_equal"]]
    assert not bad, f"replay differs from eager at buckets {bad}: {equal}"
    return launches


def busy_time(spans):
    """The length of the union of sorted (start, end) spans."""
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def device_profile(fn, n, unit):
    """Device busy share and kernel time by name over ``n`` back-to-back
    calls of ``fn``, from torch.profiler's CUDA kernel events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans, by_name, calls = [], {}, {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
                and not getattr(e, "is_user_annotation", False)):   # e.g. Optimizer.step
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            calls[e.name] = calls.get(e.name, 0) + 1
    if not spans:
        return {"device_time": "not measured (no CUDA events in the trace)"}
    spans.sort()
    busy = busy_time(spans)
    window = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    count = lambda key: sum(c for k, c in calls.items() if key in k) / n
    k1 = sum(v for k, v in by_name.items() if "fused_attention_fwd" in k)
    k2 = sum(v for k, v in by_name.items() if "fused_attention_bwd" in k)
    k3 = sum(v for k, v in by_name.items() if "flash_attention_fwd" in k)
    return {f"{unit}s": n, f"kernels_per_{unit}": len(spans) / n,
            f"window_ms_per_{unit}": window / n / 1e3,
            f"device_busy_ms_per_{unit}": busy / n / 1e3,
            "device_idle_share": 1.0 - busy / window,
            f"k1_ms_per_{unit}": k1 / n / 1e3, f"k2_ms_per_{unit}": k2 / n / 1e3,
            f"k3_ms_per_{unit}": k3 / n / 1e3,
            f"k1_kernels_per_{unit}": count("fused_attention_fwd"),
            f"k2_kernels_per_{unit}": count("fused_attention_bwd"),
            f"k3_kernels_per_{unit}": count("flash_attention_fwd"),
            f"top_kernels_ms_per_{unit}": {k[:60]: v / n / 1e3 for k, v in top}}


def phase_card_vs_cpu(report, key="base", alpha=0.0, sentic=False, quant="none"):
    """The model in fp32 (TF32 off), batch 2, on the CPU through the plain
    versions and on the card through the kernels: logits within 1e-3. At
    ``alpha != 0`` also the CCR loss of every cross-modal alignment, which
    the cells discard: within 1e-3 of max(1, |loss|). ``sentic``: the model
    with ``use_sentic_graph`` on :func:`sentic_adjacency`'s adjacency.
    ``quant``: ``quant_train`` (int8 products through ``torch._int_mm`` on
    both devices), logits within ``QUANT_LOGITS_TOL`` and equal labels."""
    import copy
    import numpy as np
    import torch
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.models.xmodules import CrossModalAlignment

    spec = MODELS[key]
    name = ("card_vs_cpu" + spec["suffix"] + ("_alpha" if alpha else "")
            + ("_sentic" if sentic else "") + ("_" + quant if quant != "none" else ""))
    tol = QUANT_LOGITS_TOL if quant != "none" else 1e-3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config(key, compute_dtype="float32", alpha=alpha, use_sentic_graph=sentic,
                       quant_train=quant)
    cpu_model = build_model(cfg, device="cpu", seed=1)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    ccr = {"cpu": {}, "gpu": {}}
    for side, model in (("cpu", cpu_model), ("gpu", gpu_model)):
        for mod_name, m in model.named_modules():
            if isinstance(m, CrossModalAlignment) and m.with_loss:
                m.register_forward_hook(lambda _m, _a, out, d=ccr[side], n=mod_name:
                                        d.__setitem__(n, out[1].item()))
    ids, mask, tt, pixels = (x[:2] for x in make_requests(cfg, seed=7)[1])
    args = [torch.from_numpy(x) for x in (ids, mask, tt, np.zeros(2, np.int64), pixels)]
    extra = {"sentic_adj": torch.from_numpy(sentic_adjacency(2, cfg.max_seq))} if sentic else {}
    with torch.inference_mode():
        _, cpu_logits, cpu_aux = cpu_model(*args, **extra)
        zero_counts()
        _, gpu_logits, gpu_aux = gpu_model(*(a.cuda() for a in args),
                                           **{k: v.cuda() for k, v in extra.items()})
        launched = read_counts()
    err = (gpu_logits.cpu() - cpu_logits).abs().max().item()
    labels_equal = bool(torch.equal(gpu_logits.cpu().argmax(-1), cpu_logits.argmax(-1)))
    js_err = abs(gpu_aux["js_loss"].item() - cpu_aux["js_loss"].item())
    ccr_err = max((abs(ccr["gpu"][n] - v) / max(1.0, abs(v)) for n, v in ccr["cpu"].items()),
                  default=0.0)
    report[name] = {
        "alpha": alpha, "sentic": sentic, "quant_train": quant, "tolerance": tol,
        "labels_equal": labels_equal, "logits_max_abs_err": err, "js_loss_abs_err": js_err,
        "ccr_losses": len(ccr["cpu"]), "ccr_loss_max_err_over_max_1_abs": ccr_err,
        "ccr_loss_range": [min(ccr["cpu"].values(), default=0.0),
                           max(ccr["cpu"].values(), default=0.0)],
        "k1_launches": launched["k1"], "k3_launches": launched["k3"]}
    log(f"[cpu-vs-card{spec['tag']}{' alpha ' + str(alpha) if alpha else ''}"
        f"{' sentic' if sentic else ''}{' ' + quant if quant != 'none' else ''}] fp32 "
        f"{spec['label']} batch 2: logits max abs err {err:.3g} (tolerance {tol:g}), labels "
        f"{'equal' if labels_equal else 'DIFFER'}, js_loss err {js_err:.3g}, "
        + (f"{len(ccr['cpu'])} CCR losses in {report[name]['ccr_loss_range']}, max err "
           f"{ccr_err:.3g} of max(1, |loss|), " if alpha else "")
        + f"K1 / K3 launches on the card {launched['k1']} / {launched['k3']}")
    assert (launched["k1"], launched["k3"]) == (spec["k1"], spec["k3"]), launched
    assert torch.isfinite(cpu_logits).all() and err <= tol, err
    assert labels_equal or quant == "none", "int8 labels differ between the card and the CPU"
    # GLAC and CRCMC of each of the DR_step routing layers of both branches
    # compute one
    assert len(ccr["cpu"]) == (2 * cfg.DR_step * 2 if alpha else 0), ccr["cpu"]
    assert set(ccr["gpu"]) == set(ccr["cpu"]) and ccr_err <= 1e-3, ccr_err


def synthetic_batch(batch_size, max_seq, image_size, vocab_size, seed, num_classes=3,
                    first_id=2, pad_id=0):
    """``d2r_tpu/data/dataset.py::synthetic_batch``'s draws, in its order:
    random lengths (ids past them are ``pad_id``), ``first_id`` first,
    random labels, normal pixels. The JAX function pads with 0 and starts
    with 2 whatever the tokenizer; RoBERTa batches here take ``<s>`` = 0 and
    ``<pad>`` = 1 instead (:func:`special_ids`)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, max_seq + 1, size=batch_size)
    input_ids = rng.integers(5, vocab_size, size=(batch_size, max_seq)).astype(np.int32)
    attention_mask = (np.arange(max_seq)[None, :] < lengths[:, None]).astype(np.int32)
    input_ids = np.where(attention_mask == 1, input_ids, pad_id).astype(np.int32)
    input_ids[:, 0] = first_id
    return {"input_ids": input_ids, "attention_mask": attention_mask,
            "token_type_ids": np.zeros((batch_size, max_seq), np.int32),
            "labels": rng.integers(0, num_classes, size=batch_size).astype(np.int32),
            "pixel_values": rng.normal(size=(batch_size, 3, image_size, image_size)
                                       ).astype(np.float32)}


def model_batch(cfg, batch_size, seed):
    """:func:`synthetic_batch` with the special ids of ``cfg``'s text tower."""
    tc = cfg.text_config()
    first, pad = special_ids(tc)
    return synthetic_batch(batch_size, cfg.max_seq, cfg.vision_config().image_size,
                           tc.vocab_size, seed, first_id=first, pad_id=pad)


def phase_train(report, key="base"):
    """Training at full width on the card (bf16 compute, fp32 parameters,
    4-group AdamW): warm-up, timed steps, the launch counts, what moved, one
    profiled step."""
    import torch
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    from d2r_tpu_torch.train.state import create_train_state, make_train_step

    spec = MODELS[key]
    tag, batch_size = f"[train{spec['tag']}]", spec["train_batch"]
    cfg = model_config(key, batch_size=batch_size, compute_dtype="bfloat16")
    pad = cfg.text_config().pad_token_id
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(cfg, total_steps=1000, device="cuda", seed=0)
    model = state.model
    batch = {k: torch.from_numpy(v).cuda() for k, v in model_batch(cfg, batch_size, 0).items()}
    initial = {n: p.detach().clone() for n, p in model.named_parameters()}
    initial.update({n: b.detach().clone() for n, b in model.named_buffers() if "running" in n})
    log(f"{tag} {spec['label']}, batch {batch_size}, bf16 compute, fp32 parameters: state "
        f"built in {time.perf_counter() - t0:.1f} s; "
        f"{int((batch['input_ids'] == pad).sum())} PAD ids (id {pad}) in the batch")
    step = make_train_step()

    zero_counts()
    t0 = time.perf_counter()
    state, timed = timed_steps(state, batch)
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps, losses, med = timed["steps"], timed["losses"], timed["step_ms_median"]
    out = {"config": spec["label"], "batch": batch_size, "steps": steps,
           "k1_launches": launches["k1"], "k2_launches": launches["k2"],
           "k3_launches": launches["k3"], **timed, "wall_s": wall,
           "g_copies": fa.fused_attention_small_bwd.g_copies,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    report["train" + spec["suffix"]] = out
    log(f"{tag} {steps} steps: K1 {launches['k1']}, K2 {launches['k2']} and K3 "
        f"{launches['k3']} launches; losses {[round(x, 4) for x in losses]}")
    log(f"{tag} step {med:.2f} ms (CUDA events, median of {TIMED_STEPS}), "
        f"{out['samples_per_s']:.1f} samples/s, peak memory {out['peak_mem_gb']:.1f} GB")
    for name, per_step in (("k1", spec["k1"]), ("k2", spec["k1"]), ("k3", spec["k3"])):
        assert launches[name] == per_step * steps, (
            f"{name.upper()} launched {launches[name]}, expected {per_step} x {steps}")
    assert all(math.isfinite(x) for x in losses), losses

    still = [n for n, p in list(model.named_parameters()) + list(model.named_buffers())
             if n in initial and torch.equal(p, initial[n])]
    pad_grad = model.model.text_embeddings.word_embeddings.weight.grad[pad]
    out["unchanged"] = still
    out["pad_row_grad_max"] = pad_grad.abs().max().item()
    log(f"{tag} unchanged parameters and BatchNorm buffers: {still}; PAD row {pad} grad "
        f"max |g| {out['pad_row_grad_max']}")
    assert not still, f"did not move: {still}"
    assert out["pad_row_grad_max"] == 0.0

    out["profile"] = prof = device_profile(lambda: step(state, batch, 1), 1, "step")
    log(f"[profile{spec['tag']}] train step: " + json.dumps(prof))
    return launches


def phase_train_card_vs_cpu(report, key="base", sentic=False):
    """One fp32 train step, batch 2, dropout off, on the CPU (plain path)
    and on the card (the kernels). ``sentic``: the model with
    ``use_sentic_graph`` on :func:`sentic_adjacency`'s adjacency, the GCN's
    weight among the compared leaves."""
    import copy
    import dataclasses
    import torch
    from d2r_tpu_torch import config as tconfig
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.models.xmodules import CrossModalAlignment
    from d2r_tpu_torch.ops import attention as tattn
    from d2r_tpu_torch.ops.kernels import flash_attention as fl
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    from d2r_tpu_torch.train.state import create_train_state, make_train_step

    spec = MODELS[key]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = model_config(key)
    tc = dataclasses.replace(base.text_config(), hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    name = f"{base.bert_name}-dropout-0"
    tconfig.register_text_preset(name, lambda: tc)
    cfg = model_config(key, compute_dtype="float32", warmup_ratio=0.0, bert_name=name,
                       use_sentic_graph=sentic)
    cpu_model = build_model(cfg, device="cpu", seed=1)
    # Two spots where the model itself turns fp32 rounding into gradient
    # noise, moved off for this check. BLOCK fusion's merge biases go to
    # [1, ~1.1], keeping the fused products z off 0, where the signed square
    # root's derivative 1/(2 sqrt|z|) is unbounded (tests/test_torch_train.py).
    # The cross-modal alignments' query and key weights shrink 10x: at the
    # full fan-in init their 100x-temperature softmaxes are near one-hot and
    # meet near-ties. Without this, the fabric's gradients are too noisy for
    # a 1e-3 comparison between any two devices, with or without the kernels.
    with torch.no_grad():
        fusion = cpu_model.model.block_fusion
        for bias in (fusion.merge_bias0, fusion.merge_bias1):
            bias.abs_().add_(1.0)
        for m in cpu_model.modules():
            if isinstance(m, CrossModalAlignment):
                m.query.weight.mul_(0.1)
                m.key.weight.mul_(0.1)
    gpu = create_train_state(cfg, 100, device="cuda", model=copy.deepcopy(cpu_model))
    plain = create_train_state(cfg, 100, device="cuda", model=copy.deepcopy(cpu_model))
    cpu = create_train_state(cfg, 100, device="cpu", model=cpu_model)
    batch = model_batch(cfg, 2, seed=7)
    if sentic:
        batch["sentic_adj"] = sentic_adjacency(2, cfg.max_seq)
    step = make_train_step()
    zero_counts()
    gpu, gm = step(gpu, batch, 0)
    torch.cuda.synchronize()
    counts = read_counts()
    launched = (counts["k1"], counts["k2"], counts["k3"])
    t0 = time.perf_counter()
    cpu, cm = step(cpu, batch, 0)
    cpu_s = time.perf_counter() - t0
    # the kernels' own share of the difference: the same step on the card
    # with every attention site through the plain versions (autograd)
    dispatch = (tattn.fused_attention_small, tattn.flash_attention)
    tattn.fused_attention_small = (lambda q, k, v, bias, scale, rate=0.0, seed=None:
                                   fa.fused_attention_small_plain(q, k, v, bias, scale, rate, seed))
    tattn.flash_attention = fl.flash_attention_plain
    try:
        plain, _ = step(plain, batch, 0)
    finally:
        tattn.fused_attention_small, tattn.flash_attention = dispatch
    pp = dict(plain.model.named_parameters())
    loss_err = abs(gm["loss"].item() - cm["loss"].item())
    leaves = ("fc.weight", "model.encoder_text_layers.layer_0.attention_self.qkv.weight",
              "model.encoder_vision_layers.layer_0.self_attn.qkv.weight",
              "model.itr_module.dynamic_itr_l0.imrc.sa_qkv.weight",
              "model.itr_module.dynamic_itr_l0.glac.saf.bn.weight")
    if spec["k3"]:   # the image-branch IMRC cell: K3's path at D2R-large
        leaves += ("model.Reversed_itr_module.dynamic_itr_l0.imrc.sa_qkv.weight",)
    if sentic:
        leaves += ("model.sentic_gcn.weight.weight", "model.sentic_gcn.bias")
    gp, cp = dict(gpu.model.named_parameters()), dict(cpu.model.named_parameters())
    out = {"config": spec["label"], "loss_abs_err": loss_err, "launches": launched,
           "cpu_step_s": cpu_s, "leaves": {}}
    ok = loss_err <= 1e-4 and launched == (spec["k1"], spec["k1"], spec["k3"])
    for name in leaves:
        ref, got = cp[name].grad, gp[name].grad.cpu()
        rel = ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
        plain_rel = ((got - pp[name].grad.cpu()).abs().max()
                     / ref.abs().max().clamp_min(1e-30)).item()
        # one Adam step moves an element by at most lr * (1 + wd |p|); where
        # the two gradients differ in sign (|g| within rounding of 0) the
        # updates differ by up to twice that
        lr = next(g["lr"] for g in cpu.optimizer.param_groups if any(p is cp[name] for p in g["params"]))
        dp = (gp[name].detach().cpu() - cp[name].detach()).abs()
        moved = (dp > 1e-3 * lr).float().mean().item()
        out["leaves"][name] = {"grad_rel_err": rel, "kernels_vs_plain_on_card_rel_err": plain_rel,
                               "param_max_abs_diff": dp.max().item(),
                               "param_share_beyond_1e-3_lr": moved, "lr": lr}
        ok = ok and rel <= 1e-3 and dp.max().item() <= 2.5 * lr and moved <= 0.01
    gb, cb = dict(gpu.model.named_buffers()), dict(cpu.model.named_buffers())
    out["running_stats_max_abs_err"] = max(
        (gb[n].cpu() - cb[n]).abs().max().item() for n in cb if "running" in n)
    ok = ok and out["running_stats_max_abs_err"] <= 1e-4
    report["train_card_vs_cpu" + spec["suffix"] + ("_sentic" if sentic else "")] = out
    log(f"[train cpu-vs-card{spec['tag']}{' sentic' if sentic else ''}] fp32 {spec['label']} batch 2, dropout off: loss err "
        f"{loss_err:.3g}, launches K1/K2/K3 {launched}, running stats err "
        f"{out['running_stats_max_abs_err']:.3g}, CPU step {cpu_s:.1f} s")
    for name, r in out["leaves"].items():
        log(f"[train cpu-vs-card{spec['tag']}]   {name}: grad rel err {r['grad_rel_err']:.3g} "
            f"(card, kernels against plain attention: "
            f"{r['kernels_vs_plain_on_card_rel_err']:.3g}), "
            f"param max diff {r['param_max_abs_diff']:.3g} (lr {r['lr']:.3g}), "
            f"share beyond 1e-3 lr {r['param_share_beyond_1e-3_lr']:.2e}")
    assert ok, "train step card against CPU out of tolerance"


def trace_kernel_ms(path):
    """ms of K1 and K2 in a torch.profiler chrome trace, and the device busy
    ms (the union of its kernels' spans)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel" and e.get("dur", 0) > 0]
    k1 = sum(e["dur"] for e in events if "fused_attention_fwd" in e["name"]) / 1e3
    k2 = sum(e["dur"] for e in events if "fused_attention_bwd" in e["name"]) / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    return {"k1_ms": k1, "k2_ms": k2, "busy_ms": busy_time(spans) / 1e3,
            "window_ms": (spans[-1][1] - spans[0][0]) / 1e3, "kernels": len(events)}


def phase_train_cli(report):
    """The training entry point as a user runs it: ``d2r_tpu_torch.cli.main``
    on a fabricated dataset (``TRAINER_DATA``, corrupt images included),
    D2R-base at ``run.sh``'s recipe for ``TRAINER_EPOCHS`` epochs; then the
    restore probe, ``--only_test --load_path <best_model>``, whose test loss
    must equal the trained run's bit for bit. Launch counts: 34 K1 and 34 K2
    a train step, 34 K1 an eval batch. ``--steps_per_dispatch`` is
    ``TRAINER_DISPATCH``; the step statistics leave out the dispatch that
    warms up (the first) and the one ``--profile_dir`` traces (the
    second)."""
    import logging
    import shutil
    import numpy as np
    from d2r_tpu_torch import cli
    from d2r_tpu_torch.data import native_image, native_text
    from d2r_tpu_torch.data.dataset import MSDDataset, MSDProcessor, write_fake_dataset

    root = os.path.join("build", "chip_smoke_train_cli")
    shutil.rmtree(root, ignore_errors=True)
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    logging.getLogger("d2r_tpu_torch").addHandler(handler)
    try:
        t0 = time.perf_counter()
        paths = write_fake_dataset(os.path.join(root, "data"), **TRAINER_DATA)
        write_s = time.perf_counter() - t0
        cfg = cli.config_from_args(cli.build_arg_parser().parse_args(TRAINER_RECIPE))
        vc = cfg.vision_config()
        # which decoder served: corrupt files decode to the fallback image
        # (a constant 128 frame) or the grey frame (128 too); every other
        # image is random noise
        ds = MSDDataset(MSDProcessor({k: paths[k] for k in ("train", "dev", "test")},
                                     cfg.bert_name, vocab_size=cfg.text_config().vocab_size),
                        paths["img_dir"], max_seq=cfg.max_seq, mode="train",
                        image_size=vc.image_size, num_vision_tokens=vc.num_tokens,
                        pixel_transfer=cfg.pixel_transfer)
        t0 = time.perf_counter()
        fallback = sum(bool((ds[i]["pixel_values"] == 128).all()) for i in range(len(ds)))
        corrupt = len(range(0, TRAINER_DATA["n"], TRAINER_DATA["corrupt_every"]))
        decode = {"native_image": native_image.native_available(),
                  "native_text": native_text.native_available(),
                  "fallback_items": fallback, "corrupt_files": corrupt,
                  "decode_s": time.perf_counter() - t0, "write_s": write_s}
        log(f"[train_cli] {TRAINER_DATA['n']} samples written in {write_s:.1f} s; native "
            f"decoder {'built' if decode['native_image'] else 'NOT built (PIL serves)'}; "
            f"{fallback} items decoded to the fallback frame, {corrupt} files corrupt")
        assert fallback == corrupt, decode

        out = os.path.join(root, "output")
        flags = TRAINER_RECIPE + [
            "--num_epochs", str(TRAINER_EPOCHS), "--train_json", paths["train"],
            "--dev_json", paths["dev"], "--test_json", paths["test"],
            "--img_dir", paths["img_dir"], "--steps_per_dispatch", str(TRAINER_DISPATCH)]
        run = lambda name, extra: flags + ["--save_path", os.path.join(out, name),
                                           "--metrics_jsonl", os.path.join(out, name + ".jsonl"),
                                           *extra]
        records = lambda name: [json.loads(line) for line in open(os.path.join(out, name + ".jsonl"))]

        zero_counts()
        t0 = time.perf_counter()
        cli.main(run("train", ["--profile_dir", os.path.join(out, "profile")]))
        train_s = time.perf_counter() - t0
        launches = read_counts()
        rec = records("train")
        summary = next(r for r in rec if r["kind"] == "summary")
        test = next(r for r in rec if r["kind"] == "test")
        dev = [r for r in rec if r["kind"] == "dev"]
        steps = summary["steps"]
        batches = math.ceil(TRAINER_DATA["n"] / cfg.batch_size)   # a split, a pass
        eval_batches = batches * (len(dev) + 1)
        best = os.path.join(out, "train", "best_model")
        prof = trace_kernel_ms(os.path.join(out, "profile", "trace.json"))
        timed = summary["step_ms"][2:]   # neither the first nor the traced dispatch
        quartiles = [float(x) for x in np.percentile(timed, [0, 25, 50, 75, 100])]
        # the epoch loop's time by part: the dispatches' CUDA-event spans,
        # the dev evaluations, the best-model saves, and the host's other
        # work (waits on the loader, stacking and copies, the trace export)
        loop_s = summary["elapsed_s"]
        parts = {"dispatches": sum(summary["step_ms"]) * TRAINER_DISPATCH / 1e3,
                 "dev_evals": sum(summary["eval_ms"]) / 1e3,
                 "saves": sum(summary["checkpoint_save_ms"]) / 1e3}
        parts["rest"] = loop_s - sum(parts.values())
        result = {
            "decode": decode, "steps": steps, "eval_batches": eval_batches, "wall_s": train_s,
            "k1_launches": launches["k1"], "k2_launches": launches["k2"],
            "samples_per_sec": summary["samples_per_sec"], "loop_s": loop_s,
            "loop_share": {k: v / loop_s for k, v in parts.items()},
            "step_ms": summary["step_ms"], "step_ms_median": quartiles[2],
            "step_ms_min_q1_median_q3_max": quartiles, "steps_timed": len(timed),
            "loader_wait_ms_median": float(np.median(summary["loader_wait_ms"])),
            "loader_wait_ms": summary["loader_wait_ms"], "dev_eval_ms": summary["eval_ms"],
            "checkpoint_save_ms": summary["checkpoint_save_ms"],
            "checkpoint_bytes": summary["checkpoint_bytes"],
            "train_losses": [r["loss"] for r in rec if r["kind"] == "train_window"],
            "dev": dev, "test": test,
            "profiled_dispatch": {**prof, "k1_ms_per_step": prof["k1_ms"] / TRAINER_DISPATCH,
                                  "k2_ms_per_step": prof["k2_ms"] / TRAINER_DISPATCH}}
        report["train_cli"] = result
        log(f"[train_cli] D2R-base, run.sh recipe, {TRAINER_EPOCHS} epochs: {steps} steps, "
            f"{eval_batches} eval batches, K1 {launches['k1']}, K2 {launches['k2']} launches; "
            f"{train_s:.1f} s")
        log(f"[train_cli] trainer's samples/s {summary['samples_per_sec']:.2f} over a "
            f"{loop_s:.2f} s epoch loop: " + ", ".join(
                f"{k} {v:.2f} s ({v / loop_s:.1%})" for k, v in parts.items()))
        log(f"[train_cli] step ms (CUDA events, {TRAINER_DISPATCH} step(s) a dispatch; "
            f"{len(timed)} of {len(summary['step_ms'])} dispatches, the warm-up and the "
            f"traced one left out): median {quartiles[2]:.2f}, min / q1 / q3 / max "
            f"{quartiles[0]:.2f} / {quartiles[1]:.2f} / {quartiles[3]:.2f} / "
            f"{quartiles[4]:.2f}; all {[round(x, 2) for x in summary['step_ms']]}")
        bare = report.get("train", {}).get("step_ms_median")
        if bare:   # phase 6's bare train_step at the same batch, in this run
            result["step_ms_median_over_phase6"] = quartiles[2] / bare
            log(f"[train_cli] median step / phase 6's bare step {bare:.2f} ms: "
                f"{quartiles[2] / bare:.3f}")
        log(f"[train_cli] host wait on the loader a step: median "
            f"{result['loader_wait_ms_median']:.2f} ms, max {max(summary['loader_wait_ms']):.2f}")
        log(f"[train_cli] dev eval ms {[round(x, 1) for x in summary['eval_ms']]}; checkpoint "
            f"save ms {[round(x, 1) for x in summary['checkpoint_save_ms']]}, bytes "
            f"{summary['checkpoint_bytes']}")
        log(f"[train_cli] traced dispatch ({TRAINER_DISPATCH} step(s)): K1 "
            f"{prof['k1_ms'] / TRAINER_DISPATCH:.3f} ms and K2 "
            f"{prof['k2_ms'] / TRAINER_DISPATCH:.3f} ms a step, device busy "
            f"{prof['busy_ms'] / TRAINER_DISPATCH:.2f} ms a step in a "
            f"{prof['window_ms'] / TRAINER_DISPATCH:.2f} ms window")
        log(f"[train_cli] losses by window {[round(x, 4) for x in result['train_losses']]}; "
            f"dev F1 {[round(r['f_score'], 4) for r in dev]}; test loss {test['loss']!r}")
        assert launches["k2"] == 34 * steps, launches
        assert launches["k1"] == 34 * (steps + eval_batches), launches
        assert all(math.isfinite(x) for x in result["train_losses"] + [test["loss"]])
        assert any(m.startswith("Save best model") for m in messages), "no best model saved"
        assert os.path.exists(os.path.join(out, "train", "config.json"))
        assert os.path.exists(os.path.join(best, "model.pth"))

        # the restore probe: a freshly built model in the same process loads
        # best_model and tests
        zero_counts()
        cli.main(run("probe", ["--only_test", "--load_path", best]))
        probe_launches = read_counts()
        probe = next(r for r in records("probe") if r["kind"] == "test")
        result["restore_probe"] = {"test_loss": probe["loss"], "launches": probe_launches}
        log(f"[train_cli] restore probe: test loss {probe['loss']!r} (trained run "
            f"{test['loss']!r}), K1 {probe_launches['k1']}, K2 {probe_launches['k2']}")
        assert probe_launches == {"k1": 34 * batches, "k2": 0, "k3": 0}, probe_launches
        assert probe["loss"] == test["loss"] and probe["f_score"] == test["f_score"]
        return {n: launches[n] + probe_launches[n] for n in launches}
    finally:
        logging.getLogger("d2r_tpu_torch").removeHandler(handler)
        shutil.rmtree(root, ignore_errors=True)


def make_posts(n, image_size, corrupt_every, seed=0):
    """``n`` posts made with numpy from ``seed``: a text of 3-40 words and a
    JPEG of ``image_size`` pixels (PIL, random noise), every
    ``corrupt_every``-th image bytes that decode to nothing."""
    import base64
    import io
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    words = ("good bad happy sad sunny rain love hate great awful the a day night photo "
             "friends #fun @you !! ... so not very what a").split()
    posts = []
    for i in range(n):
        text = " ".join(rng.choice(words, size=int(rng.integers(3, 41))))
        if i % corrupt_every == 0:
            img = b"\xff\xd8 not a jpeg " + rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
        else:
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (image_size, image_size, 3), dtype=np.uint8)
                            ).save(buf, "JPEG")
            img = buf.getvalue()
        posts.append({"text": text, "image_b64": base64.b64encode(img).decode()})
    return posts


def http_post(url, payload, timeout=120):
    """(status, body, ms) of one POST with a JSON body."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    return status, body, (time.perf_counter() - t0) * 1e3


def percentiles(ms):
    xs = sorted(ms)
    pick = lambda q: xs[min(int(q * len(xs)), len(xs) - 1)]
    return {"p50": pick(0.5), "p95": pick(0.95), "p99": pick(0.99), "max": xs[-1],
            "count": len(xs)}


def run_clients(url, posts, indices, clients, answers):
    """POST ``posts[i]`` for every i of ``indices`` to ``url/predict`` from
    ``clients`` threads; the answers go to ``answers[i]`` as (status, body,
    ms). Returns the wall seconds."""
    import threading
    shares = [indices[c::clients] for c in range(clients)]

    def client(mine):
        for i in mine:
            answers[i] = http_post(url + "/predict", posts[i])

    threads = [threading.Thread(target=client, args=(mine,)) for mine in shares]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads), "a client thread hung"
    return time.perf_counter() - t0


def get_json(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def replay_kernels(prof, tmp_dir):
    """From a torch.profiler trace: the ``cudaGraphLaunch`` calls, and the
    K1 kernels and all kernels each of them ran (a graph's kernels carry its
    launch's correlation id)."""
    from collections import Counter
    path = os.path.join(tmp_dir, "serve_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    launches = [e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaGraphLaunch"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = Counter(e["args"].get("correlation") for e in kernels
                 if "fused_attention_fwd" in e["name"])
    every = Counter(e["args"].get("correlation") for e in kernels)
    return {"graph_launches": len(launches),
            "k1_per_launch": sorted(Counter(k1[c] for c in launches).items()),
            "kernels_per_launch": sorted(Counter(every[c] for c in launches).items()),
            "kernels_outside_launches": sum(every.values()) - sum(every[c] for c in launches)}


def serve_http_run(best, posts, quantize, report_key, reference=None):
    """One service built by ``server.build_service`` (what ``python -m
    d2r_tpu_torch.server`` runs) on an ephemeral port, and its traffic:
    (a) one client, one /predict at a time; (b) ``SERVE_CLIENTS`` client
    threads; for the unquantized service also (d) a /reload of the same
    checkpoint issued as (b) starts, with one more client posting until it
    returns, and a profiler trace of a second (b)-like burst; (c)
    one /predict_batch of 32 items; (e) a body over MAX_BODY_BYTES. Checks
    every answer against a direct ``Predictor.predict`` of that post alone
    (and, for int8, the labels against ``reference`` where its top
    probability leads by more than 0.1) and /metrics against the requests
    sent."""
    import base64
    import http.client
    import threading
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from d2r_tpu_torch import server
    from d2r_tpu_torch.serve import latency_stats

    tag = f"[serve_http {report_key}]"
    flags = ["--load_path", best, "--port", "0", "--batch_buckets",
             ",".join(map(str, BUCKETS)), "--max_wait_ms", str(SERVE_MAX_WAIT_MS)]
    t0 = time.perf_counter()
    svc, httpd = server.build_service(server.build_arg_parser().parse_args(
        flags + (["--quantize", quantize] if quantize else [])))
    build_s = time.perf_counter() - t0
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = {"build_s": build_s}
    try:
        # each post alone through the service's own predictor (bucket 1)
        items = [svc.preprocess(p["text"], base64.b64decode(p["image_b64"])) for p in posts]
        stack = lambda rows: [np.stack([it[k] for it in rows]) for k in
                              ("input_ids", "attention_mask", "token_type_ids", "pixel_values")]
        direct = np.concatenate([svc.predictor.predict(*stack([it]))["probs"] for it in items])
        log(f"{tag} service built in {build_s:.1f} s; {len(posts)} posts alone: labels "
            f"{np.bincount(direct.argmax(-1), minlength=3).tolist()}")
        answers, sent = {}, 0
        n_a, n_b = SERVE_SEQUENTIAL, len(posts) - SERVE_SEQUENTIAL
        for i in range(n_a):                                             # (a)
            answers[i] = http_post(url + "/predict", posts[i])
        sent += n_a
        snap0 = get_json(url + "/metrics")
        reload_out, hammer = {}, []
        stop = threading.Event()
        if quantize is None:                                             # (d)
            def reload():
                t = time.perf_counter()
                reload_out["status"], reload_out["body"], _ = http_post(
                    url + "/reload", {"load_path": best}, timeout=600)
                reload_out["s"] = time.perf_counter() - t
                stop.set()

            def keep_posting():
                k = 0
                while not stop.is_set():
                    hammer.append((k % len(posts),) + http_post(
                        url + "/predict", posts[k % len(posts)]))
                    k += 1

            side = [threading.Thread(target=reload), threading.Thread(target=keep_posting)]
            for t in side:
                t.start()
        b_s = run_clients(url, posts, list(range(n_a, n_a + n_b)), SERVE_CLIENTS, answers)  # (b)
        if quantize is None:
            for t in side:
                t.join(timeout=600)
            assert not any(t.is_alive() for t in side), "the reload or its client hung"
            assert reload_out["status"] == 200, reload_out
        sent += n_b + len(hammer)
        snap1 = get_json(url + "/metrics")
        flushes_b = snap1["flushes_total"] - snap0["flushes_total"]

        traced = {}
        if quantize is None:   # K1 a replay, from the card's trace of a (b)-like burst
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run_clients(url, posts, list(range(SERVE_TRACED)), SERVE_CLIENTS, traced)
                torch.cuda.synchronize()
            sent += SERVE_TRACED
            flushes_t = get_json(url + "/metrics")["flushes_total"] - snap1["flushes_total"]
            out["traced_burst"] = burst = replay_kernels(prof, os.path.dirname(best))
            burst.update(requests=SERVE_TRACED, flushes=flushes_t)
            log(f"{tag} traced burst: {SERVE_TRACED} requests in {flushes_t} flushes; "
                f"{burst['graph_launches']} graph launches in the trace, K1 kernels a "
                f"launch {burst['k1_per_launch']}, kernels a launch {burst['kernels_per_launch']}")
            assert burst["graph_launches"] == flushes_t, burst
            assert [c for c, _ in burst["k1_per_launch"]] == [MODELS["base"]["k1"]], burst

        status, body, c_ms = http_post(url + "/predict_batch", {"items": posts[:32]})  # (c)
        assert status == 200, body
        sent += 32
        want = svc.predictor.predict(*stack(items[:32]))["probs"]
        got = np.asarray([r["probs"] for r in body["results"]], np.float32)
        out["batch_c"] = {"ms": c_ms, "bit_equal": bool(np.array_equal(got, want)),
                          "max_abs_diff": float(np.abs(got - want).max())}
        assert np.array_equal(got, want), ("(c) differs from Predictor.predict", out["batch_c"])

        conn = http.client.HTTPConnection(url.split("//", 1)[1], timeout=30)   # (e)
        try:
            conn.putrequest("POST", "/predict")
            conn.putheader("Content-Type", "application/json")
            conn.putheader("Content-Length", str(server.MAX_BODY_BYTES + 1))
            conn.endheaders()
            conn.send(b'{"text": "too large"}')
            resp = conn.getresponse()
            out["oversized_status"] = resp.status
            resp.read()
        finally:
            conn.close()
        assert out["oversized_status"] == 413, out["oversized_status"]

        replies = [(i, *answers[i]) for i in sorted(answers)] + hammer + [
            (i, *traced[i]) for i in sorted(traced)]
        bad = [(i, s) for i, s, _, _ in replies if s != 200]
        assert not bad, f"{len(bad)} requests failed: {bad[:5]}"
        probs = np.asarray([b["probs"] for _, _, b, _ in replies], np.float32)
        idx = [i for i, _, _, _ in replies]
        diff = np.abs(probs - direct[idx]).max(axis=-1)
        flips = int((probs.argmax(-1) != direct[idx].argmax(-1)).sum())
        metrics = get_json(url + "/metrics")
        lat = lambda ids: percentiles([answers[i][2] for i in ids])
        out.update({
            "requests_sent": sent, "metrics": metrics,
            "a": lat(range(n_a)), "b": lat(range(n_a, n_a + n_b)),
            "b_posts_per_s": n_b / b_s, "b_wall_s": b_s,
            "b_flushes": flushes_b, "b_mean_flush": (n_b + len(hammer)) / flushes_b,
            "reload": {k: v for k, v in reload_out.items() if k != "body"},
            "reload_requests_during": len(hammer),
            "max_abs_diff_vs_alone": float(diff.max()), "label_flips_vs_alone": flips,
            "replay_ms_p50_by_bucket": {}})
        for b in BUCKETS:
            rows = dict(zip(("input_ids", "attention_mask", "token_type_ids", "pixel_values"),
                            stack(items[:b])))
            out["replay_ms_p50_by_bucket"][b] = latency_stats(
                svc.predictor, rows, iters=20, warmup=3, device_resident=True)["p50"] * 1e3
        log(f"{tag} (a) {n_a} sequential: HTTP ms p50 {out['a']['p50']:.2f}, p95 "
            f"{out['a']['p95']:.2f}, p99 {out['a']['p99']:.2f}")
        log(f"{tag} (b) {n_b} from {SERVE_CLIENTS} clients in {b_s:.2f} s: "
            f"{out['b_posts_per_s']:.1f} posts/s, HTTP ms p50 {out['b']['p50']:.2f}, p95 "
            f"{out['b']['p95']:.2f}, p99 {out['b']['p99']:.2f}; {flushes_b} flushes, mean "
            f"flush {out['b_mean_flush']:.2f} rows (with {len(hammer)} posts of the reload's "
            f"client)")
        if reload_out:
            log(f"{tag} (d) reload under load: status {reload_out['status']} in "
                f"{reload_out['s']:.1f} s, {len(hammer)} requests answered meanwhile")
        log(f"{tag} (c) /predict_batch of 32: {c_ms:.2f} ms, bit equal to Predictor.predict; "
            f"(e) oversized body: {out['oversized_status']}")
        log(f"{tag} answers against each post alone: max abs diff {diff.max():.3g}, label "
            f"flips {flips}; /metrics requests {metrics['requests_total']} (sent {sent}), "
            f"errors {metrics['errors_total']}, reloads {metrics['reloads_total']}, mean "
            f"flush {metrics['batch_size']['mean']:.2f}")
        log(f"{tag} replay + download ms (latency_stats, device resident, p50) by bucket: "
            + json.dumps({b: round(v, 3) for b, v in out["replay_ms_p50_by_bucket"].items()}))
        assert diff.max() <= 2e-2 and flips == 0, (diff.max(), flips)
        assert metrics["requests_total"] == sent and metrics["errors_total"] == 0, metrics
        assert metrics["reloads_total"] == (0 if quantize else 1), metrics
        if reference is not None:   # int8 labels against the unquantized service's
            top2 = np.sort(reference, axis=-1)
            decisive = (top2[:, -1] - top2[:, -2]) > 0.1
            same = direct.argmax(-1) == reference.argmax(-1)
            agree = same[decisive]
            out["int8_label_agreement"] = {"decisive": int(decisive.sum()),
                                           "agree": int(agree.sum()), "all_agree": int(same.sum()),
                                           "max_abs_diff": float(np.abs(direct - reference).max())}
            log(f"{tag} int8 against unquantized: labels agree on {int(agree.sum())} of "
                f"{int(decisive.sum())} decisive posts (top probability ahead by > 0.1) and on "
                f"{int(same.sum())} of all {len(same)}; max abs diff "
                f"{out['int8_label_agreement']['max_abs_diff']:.3g}")
            assert agree.all(), out["int8_label_agreement"]
        return out, direct
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
        thread.join(timeout=30)


def phase_serve_http(report):
    """The HTTP service at full width, D2R-base (``D2RConfig(DR_step=4,
    max_seq=64, compute_dtype="bfloat16")``, random weights from seed 0,
    saved with ``save_checkpoint`` and ``save_config_json`` under
    ``build/``), through ``server.build_service``: ``SERVE_POSTS`` posts of
    text and 256-pixel JPEGs, every 50th corrupt; then the same traffic on
    its own ``--quantize int8`` service (:func:`serve_http_run`)."""
    import shutil
    import types
    from d2r_tpu_torch.config import save_config_json
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.train.checkpoint import save_checkpoint

    root = os.path.join("build", "chip_smoke_serve_http")
    shutil.rmtree(root, ignore_errors=True)
    try:
        cfg = model_config("base", compute_dtype="bfloat16")
        best = os.path.join(root, "best_model")
        t0 = time.perf_counter()
        save_checkpoint(best, types.SimpleNamespace(model=build_model(cfg, device="cpu", seed=0)))
        save_config_json(cfg, os.path.join(root, "config.json"))
        posts = make_posts(SERVE_POSTS, 256, 50, seed=13)
        log(f"[serve_http] checkpoint saved and {len(posts)} posts made in "
            f"{time.perf_counter() - t0:.1f} s")
        zero_counts()
        result = {}
        result["bf16"], dense = serve_http_run(best, posts, None, "bf16")
        result["int8"], _ = serve_http_run(best, posts, "int8", "int8", reference=dense)
        launches = read_counts()
        result["launches"] = launches
        report["serve_http"] = result
        # each service build, and the reload, captures every bucket: an eager
        # forward and its capture, two host calls a site; replays make none
        want = 2 * MODELS["base"]["k1"] * len(BUCKETS) * 3
        log(f"[serve_http] K1 host calls {launches['k1']} (3 builds of {len(BUCKETS)} "
            f"buckets, eager + capture), K3 {launches['k3']}")
        assert launches == {"k1": want, "k2": 0, "k3": 0}, launches
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def fabricate_pretrained(cfg, directory, seed):
    """Write ``bert.pt`` and ``clip_vit.pt`` for ``cfg``'s two towers into
    ``directory``, as ``transformers`` would save them, without needing
    ``transformers``: the HF keys of the port's own mapping tables
    (``d2r_tpu_torch/utils/weights.py``), each tensor drawn from a seeded
    generator (0.02 N(0, 1), LayerNorm scales around 1) at the shape of the
    port tensor it lands in (q, k and v a third of the fused rows each),
    taken from the model built on the meta device. Plus one key of each
    whitelisted kind (the BERT pooler and position/type-id buffers, CLIP's
    post-LayerNorm), which the loader must skip. Returns the two state
    dicts."""
    import torch
    from d2r_tpu_torch.models.unimo import D2RClassifier
    from d2r_tpu_torch.utils import weights as uw
    from d2r_tpu_torch.weights import flax_path

    with torch.device("meta"):
        model = D2RClassifier(cfg)
    shapes = {flax_path(model, k): tuple(v.shape) for k, v in model.state_dict().items()}
    tc, vc = cfg.text_config(), cfg.vision_config()
    gen = torch.Generator().manual_seed(seed)
    norm = ("LayerNorm.weight", "layer_norm1.weight", "layer_norm2.weight", "pre_layrnorm.weight")

    def draw(key, shape):
        t = 0.02 * torch.randn(shape, generator=gen)
        return t + 1.0 if key.endswith(norm) else t

    h, m = tc.hidden_size, tc.max_position_embeddings
    whitelisted = (
        {"pooler.dense.weight": draw("pooler", (h, h)), "pooler.dense.bias": draw("pooler", (h,)),
         "embeddings.position_ids": torch.arange(m)[None],
         "embeddings.token_type_ids": torch.zeros((1, m), dtype=torch.int64)},
        {"post_layernorm.weight": draw("post_layernorm", (vc.hidden_size,)),
         "post_layernorm.bias": draw("post_layernorm", (vc.hidden_size,))})
    out = []
    for mapping, extra, name in (
            (uw.bert_mapping(tc.num_hidden_layers), whitelisted[0], "bert.pt"),
            (uw.clip_vision_mapping(vc.num_hidden_layers), whitelisted[1], "clip_vit.pt")):
        sd = {}
        for dst, src, _ in mapping:
            shape = shapes["model/" + "/".join(dst)]
            srcs = src if isinstance(src, tuple) else (src,)
            if len(srcs) == 3:       # q, k, v: a third of the fused rows each
                shape = (shape[0] // 3,) + shape[1:]
            sd.update({s: draw(s, shape) for s in srcs})
        sd.update(extra)
        torch.save(sd, os.path.join(directory, name))
        out.append(sd)
    return out


def tower_mismatches(state_dict, cfg, text_sd, vision_sd):
    """(tensors compared, port keys that differ): every tower tensor of a
    port ``state_dict`` against the files'. The port keeps torch's layouts,
    so each tensor must equal its file tensor as it is, except the fused
    q/k/v projection, whose rows are the three Linears' stacked (weights and
    biases): the one layout change the loader makes on the port's side."""
    import torch
    from d2r_tpu_torch.models.unimo import D2RClassifier
    from d2r_tpu_torch.utils import weights as uw
    from d2r_tpu_torch.weights import flax_path

    with torch.device("meta"):
        model = D2RClassifier(cfg)
    by_path = {flax_path(model, k): k for k in model.state_dict()}
    tc, vc = cfg.text_config(), cfg.vision_config()
    compared, differ = 0, []
    for mapping, sd in ((uw.bert_mapping(tc.num_hidden_layers), text_sd),
                        (uw.clip_vision_mapping(vc.num_hidden_layers), vision_sd)):
        for dst, src, _ in mapping:
            key = by_path["model/" + "/".join(dst)]
            srcs = src if isinstance(src, tuple) else (src,)
            want = torch.cat([sd[s] for s in srcs])
            compared += 1
            if not torch.equal(state_dict[key].detach().cpu(), want):
                differ.append(key)
    return compared, differ


def cli_run(flags, out, name, extra=()):
    """``d2r_tpu_torch.cli.main`` with ``flags`` and a save path and metrics
    file under ``out/name``; returns (its metrics records, the launch counts
    of the run, seconds)."""
    from d2r_tpu_torch import cli
    jsonl = os.path.join(out, name + ".jsonl")
    zero_counts()
    t0 = time.perf_counter()
    cli.main(list(flags) + ["--save_path", os.path.join(out, name), "--metrics_jsonl", jsonl,
                            *extra])
    wall = time.perf_counter() - t0
    counts = read_counts()
    return [json.loads(line) for line in open(jsonl)], counts, wall


def cli_counts(records, batch_size, n):
    """(train steps, eval batches) of a CLI run: every split holds ``n``
    posts; each dev evaluation and the test pass run over one split."""
    steps = next(r for r in records if r["kind"] == "summary")["steps"]
    dev = sum(r["kind"] == "dev" for r in records)
    return steps, math.ceil(n / batch_size) * (dev + 1)


def phase_pretrained(report):
    """Fine-tuning from pretrained towers at full width, D2R-base: fabricated
    BERT-base and CLIP ViT-B/32 files (:func:`fabricate_pretrained`) loaded
    into a model on the card, every tower tensor equal to the file's bit for
    bit; then the CLI at ``run.sh``'s recipe, one epoch on phase 12's
    fabricated dataset with ``--pretrained_dir`` (samples/s beside phase
    12's), and once more with ``--freeze_towers``, whose best model's towers
    must equal the files bit for bit. Launch counts as phase 12: 34 K1 and
    34 K2 a train step, 34 K1 an eval batch."""
    import shutil
    import numpy as np
    from d2r_tpu_torch import cli
    from d2r_tpu_torch.data.dataset import write_fake_dataset
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.utils.weights import load_pretrained_params
    import torch

    root = os.path.join("build", "chip_smoke_pretrained")
    shutil.rmtree(root, ignore_errors=True)
    pre = os.path.join(root, "pretrained")
    os.makedirs(pre)
    try:
        cfg = cli.config_from_args(cli.build_arg_parser().parse_args(TRAINER_RECIPE))
        t0 = time.perf_counter()
        text_sd, vision_sd = fabricate_pretrained(cfg, pre, seed=11)
        write_s = time.perf_counter() - t0
        model = build_model(cfg, device="cuda", seed=0)
        t0 = time.perf_counter()
        load_pretrained_params(pre, model)
        load_s = time.perf_counter() - t0
        compared, differ = tower_mismatches(model.state_dict(), cfg, text_sd, vision_sd)
        del model
        result = {"files_write_s": write_s, "load_s": load_s, "tower_tensors": compared,
                  "tower_tensors_differing": differ}
        log(f"[pretrained] BERT-base + CLIP ViT-B/32 files written in {write_s:.1f} s, loaded "
            f"into the card's model in {load_s:.1f} s; {compared} tower tensors, "
            f"{len(differ)} differing from the files")
        assert compared > 0 and not differ, differ

        paths = write_fake_dataset(os.path.join(root, "data"), **TRAINER_DATA)
        flags = TRAINER_RECIPE + [
            "--num_epochs", "1", "--train_json", paths["train"], "--dev_json", paths["dev"],
            "--test_json", paths["test"], "--img_dir", paths["img_dir"],
            "--steps_per_dispatch", str(TRAINER_DISPATCH), "--pretrained_dir", pre]
        launches = {"k1": 0, "k2": 0, "k3": 0}
        for name, extra in (("fine_tune", []), ("frozen", ["--freeze_towers"])):
            records, counts, wall = cli_run(flags, root, name, extra)
            summary = next(r for r in records if r["kind"] == "summary")
            test = next(r for r in records if r["kind"] == "test")
            steps, eval_batches = cli_counts(records, cfg.batch_size, TRAINER_DATA["n"])
            best = torch.load(os.path.join(root, name, "best_model", "model.pth"),
                              map_location="cpu", weights_only=True)
            _, differ = tower_mismatches(best, cfg, text_sd, vision_sd)
            result[name] = {
                "samples_per_sec": summary["samples_per_sec"], "steps": steps,
                "eval_batches": eval_batches, "wall_s": wall, "launches": counts,
                "step_ms_median": float(np.median(summary["step_ms"][1:])),
                "test_loss": test["loss"], "test_f_score": test["f_score"],
                "tower_tensors_differing_from_files": len(differ)}
            log(f"[pretrained] CLI {name} ({' '.join(extra) or 'towers trained'}), one epoch: "
                f"{steps} steps, {eval_batches} eval batches, {wall:.1f} s; samples/s "
                f"{summary['samples_per_sec']:.2f}, median step "
                f"{result[name]['step_ms_median']:.2f} ms; K1 {counts['k1']}, K2 "
                f"{counts['k2']}; test loss {test['loss']!r}; best model's tower tensors "
                f"differing from the files: {len(differ)} of {compared}")
            assert counts == {"k1": 34 * (steps + eval_batches), "k2": 34 * steps, "k3": 0}, counts
            assert math.isfinite(test["loss"])
            launches = {k: launches[k] + counts[k] for k in launches}
            del best
        assert result["frozen"]["tower_tensors_differing_from_files"] == 0
        assert result["fine_tune"]["tower_tensors_differing_from_files"] > 0
        phase12 = report.get("train_cli", {}).get("samples_per_sec")
        result["phase12_samples_per_sec"] = phase12
        if phase12:
            log(f"[pretrained] samples/s, fine-tuning / frozen towers / phase 12 (random "
                f"init, two epochs): {result['fine_tune']['samples_per_sec']:.2f} / "
                f"{result['frozen']['samples_per_sec']:.2f} / {phase12:.2f}")
        report["pretrained"] = result
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def scaled_config(**overrides):
    """D2R-large at ``tools/perf_sweep.py``'s ``scaled_large`` recipe as
    written (:data:`SCALED_KNOBS`, batch 16, bf16 compute)."""
    return model_config("large", batch_size=SCALED_BATCH, compute_dtype="bfloat16",
                        **{**SCALED_KNOBS, **overrides})


def uint8_batch(cfg, batch_size, seed):
    """:func:`model_batch` with raw uint8 pixels (the recipe's transfer)."""
    import numpy as np
    b = model_batch(cfg, batch_size, seed)
    b["pixel_values"] = np.random.default_rng(seed).integers(
        0, 256, size=b["pixel_values"].shape).astype(np.uint8)
    return b


def fresh_state(cfg, weights):
    """A train state on the card for ``cfg`` holding ``weights`` (a CPU
    state dict), its optimizer empty."""
    from d2r_tpu_torch.models.unimo import D2RClassifier
    from d2r_tpu_torch.train.state import create_train_state
    model = D2RClassifier(cfg)
    model.load_state_dict(weights)
    return create_train_state(cfg, total_steps=1000, device="cuda", model=model)


def step_pair(cfg_a, cfg_b, weights, batch, seed):
    """One train step from ``weights`` under each config, on the same batch
    and dropout seed: (loss a, loss b, max over leaves of max |a - b| / max
    |a| of the updated parameters, the launch counts of b's step)."""
    import torch
    from d2r_tpu_torch.train.state import make_train_step
    out = []
    for cfg in (cfg_a, cfg_b):
        state = fresh_state(cfg, weights)
        zero_counts()
        state, metrics = make_train_step()(state, batch, seed)
        torch.cuda.synchronize()
        out.append((metrics["loss"].item(), dict(state.model.named_parameters()), read_counts()))
        del state
    (loss_a, pa, _), (loss_b, pb, counts) = out
    with torch.no_grad():
        rel = max(((pb[n] - p).abs().max() / p.abs().max().clamp_min(1e-30)).item()
                  for n, p in pa.items())
    del out, pa, pb
    torch.cuda.empty_cache()
    return loss_a, loss_b, rel, counts


def phase_train_scaled(report):
    """D2R-large at the scaled recipe as written (:data:`SCALED_KNOBS`):
    weights from fabricated RoBERTa-large and CLIP ViT-L/14 files through
    ``load_pretrained_params`` (the scanned path), every tower tensor equal
    to the files'; 10 timed steps after 3 warm-up ones (CUDA events), step
    ms, samples/s and peak memory, beside the same model and batch without
    the three knobs; ``remat`` against no remat and, at D2R-base,
    ``remat_ffn_act`` against none, one step each from the same weights and
    batch, dropout off then on with one seed: losses and updated parameters
    within 1e-6 of each leaf's max |value|; then the CLI for one epoch of 64
    posts with all of the recipe's flags and ``--pretrained_dir``.

    Launches a step: without remat K1, K2 and K3 29 times each (phase 10).
    ``remat`` runs each of the 24 RoBERTa-large and 24 CLIP-L tower layers'
    forward again in the backward: 29 + 24 = 53 K1 and 53 K3 host calls a
    step, K2 29 (the backward is not repeated). ``remat_ffn_act``
    recomputes no attention: 34 K1 and 34 K2 at base. An eval batch runs
    no backward: 29 K1 and 29 K3."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from d2r_tpu_torch import config as tconfig
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.train.state import make_train_step
    from d2r_tpu_torch.utils.weights import load_pretrained_params

    root = os.path.join("build", "chip_smoke_train_scaled")
    shutil.rmtree(root, ignore_errors=True)
    pre = os.path.join(root, "pretrained")
    os.makedirs(pre)
    large = MODELS["large"]
    remat_k1 = large["k1"] + model_config("large").text_config().num_hidden_layers
    remat_k3 = large["k3"] + model_config("large").vision_config().num_hidden_layers
    per_step = {"recipe": {"k1": remat_k1, "k2": large["k1"], "k3": remat_k3},
                "without_knobs": {"k1": large["k1"], "k2": large["k1"], "k3": large["k3"]}}
    launches = {"k1": 0, "k2": 0, "k3": 0}
    try:
        cfg = scaled_config()
        t0 = time.perf_counter()
        text_sd, vision_sd = fabricate_pretrained(cfg, pre, seed=12)
        write_s = time.perf_counter() - t0
        model = build_model(cfg, device="cuda", seed=0)
        t0 = time.perf_counter()
        load_pretrained_params(pre, model)
        load_s = time.perf_counter() - t0
        compared, differ = tower_mismatches(model.state_dict(), cfg, text_sd, vision_sd)
        weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        del model, text_sd, vision_sd
        torch.cuda.empty_cache()
        result = {"files_write_s": write_s, "load_s": load_s, "tower_tensors": compared,
                  "tower_tensors_differing": differ, "knobs": SCALED_KNOBS,
                  "launches_per_step": per_step}
        log(f"[train_scaled] RoBERTa-large + CLIP ViT-L/14 files written in {write_s:.1f} s, "
            f"loaded (scanned path) in {load_s:.1f} s; {compared} tower tensors, "
            f"{len(differ)} differing from the files")
        assert compared > 0 and not differ, differ

        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in uint8_batch(cfg, SCALED_BATCH, 0).items()}
        plain_cfg = scaled_config(scan_layers=False, remat=False, adam_mu_dtype="float32")
        for name, c in (("recipe", cfg), ("without_knobs", plain_cfg)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state = fresh_state(c, weights)
            step = make_train_step()
            zero_counts()
            losses, step_ms = [], []
            for i in range(WARMUP_STEPS + TIMED_STEPS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, metrics = step(state, batch, 1)
                end.record()
                losses.append(metrics["loss"])
                if i >= WARMUP_STEPS:
                    torch.cuda.synchronize()
                    step_ms.append(start.elapsed_time(end))
            torch.cuda.synchronize()
            counts = read_counts()
            steps = WARMUP_STEPS + TIMED_STEPS
            med = float(np.median(step_ms))
            mu = {str(s["exp_avg"].dtype) for s in state.optimizer.state.values()}
            result[name] = {"step_ms": step_ms, "step_ms_median": med,
                            "samples_per_s": SCALED_BATCH / (med / 1e3),
                            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                            "losses": [x.item() for x in losses], "launches": counts,
                            "adam_mu_dtypes": sorted(mu)}
            del state, step, metrics, losses
            r = result[name]
            log(f"[train_scaled] {name}: step {med:.2f} ms (CUDA events, median of "
                f"{TIMED_STEPS}), {r['samples_per_s']:.1f} samples/s, peak memory "
                f"{r['peak_mem_gb']:.2f} GB; Adam mu {r['adam_mu_dtypes']}; launches {counts}")
            assert counts == {k: v * steps for k, v in per_step[name].items()}, counts
            assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
            launches = {k: launches[k] + counts[k] for k in launches}
        torch.cuda.empty_cache()
        r, p = result["recipe"], result["without_knobs"]
        result["step_ms_ratio"] = r["step_ms_median"] / p["step_ms_median"]
        result["peak_mem_ratio"] = r["peak_mem_gb"] / p["peak_mem_gb"]
        log(f"[train_scaled] recipe / without the knobs: step ms {result['step_ms_ratio']:.3f}, "
            f"peak memory {result['peak_mem_ratio']:.3f}")

        # remat against none (large) and remat_ffn_act against none (base):
        # the same weights, batch and dropout seed, dropout off then on
        base_cfg = model_config("base", batch_size=TRAIN_BATCH, compute_dtype="bfloat16")
        base_weights = {k: v.detach() for k, v in
                        build_model(base_cfg, device="cpu", seed=0).state_dict().items()}
        checks = {}
        for key, knob, c0, w in (("large", "remat", cfg, weights),
                                 ("base", "remat_ffn_act", base_cfg, base_weights)):
            b = batch if key == "large" else {
                k: torch.from_numpy(v).cuda() for k, v in model_batch(c0, TRAIN_BATCH, 0).items()}
            tc = c0.text_config()
            nodrop = f"{c0.bert_name}-dropout-0"
            tconfig.register_text_preset(nodrop, lambda tc=tc: dataclasses.replace(
                tc, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
            for dropout, bert_name in (("off", nodrop), ("on", c0.bert_name)):
                pair = [dataclasses.replace(c0, bert_name=bert_name, lr=1e-5, warmup_ratio=0.0,
                                            **{knob: flag}) for flag in (False, True)]
                loss_a, loss_b, rel, counts = step_pair(*pair, w, b, seed=3)
                expect = ({"k1": remat_k1, "k2": large["k1"], "k3": remat_k3} if key == "large"
                          else {"k1": 34, "k2": 34, "k3": 0})
                checks[f"{knob}_{key}_dropout_{dropout}"] = c = {
                    "loss": loss_a, "loss_abs_diff": abs(loss_b - loss_a),
                    "param_max_rel_diff": rel, "launches": counts}
                log(f"[train_scaled] {knob} against none, {MODELS[key]['label']}, dropout "
                    f"{dropout}: loss {loss_a!r} / {loss_b!r}, updated parameters' max diff "
                    f"{rel:.3g} of the leaf's max |value|; launches with {knob} {counts}")
                assert counts == expect, (counts, expect)
                assert c["loss_abs_diff"] <= 1e-6 * max(1.0, abs(loss_a)) and rel <= 1e-6, c
        result["equality"] = checks

        # the entry point with every flag of the recipe
        from d2r_tpu_torch.data.dataset import write_fake_dataset
        paths = write_fake_dataset(os.path.join(root, "data"), **SCALED_CLI_DATA)
        flags = ["--bert_name", cfg.bert_name, "--vit_name", cfg.vit_name,
                 "--embed_size", "1024", "--num_head_IMRC", "16", "--hid_IMRC", "1024",
                 "--DR_step", str(cfg.DR_step), "--max_seq", str(cfg.max_seq),
                 "--batch_size", str(SCALED_BATCH), "--compute_dtype", "bfloat16",
                 "--scan_layers", "--remat", "--adam_mu_dtype", "bfloat16",
                 "--pixel_transfer", "uint8", "--num_epochs", "1",
                 "--train_json", paths["train"], "--dev_json", paths["dev"],
                 "--test_json", paths["test"], "--img_dir", paths["img_dir"],
                 "--steps_per_dispatch", "1", "--pretrained_dir", pre]
        records, counts, wall = cli_run(flags, root, "cli")
        steps, eval_batches = cli_counts(records, SCALED_BATCH, SCALED_CLI_DATA["n"])
        test = next(r for r in records if r["kind"] == "test")
        saved = tconfig.load_config_json(os.path.join(root, "cli", "config.json"))
        result["cli"] = {"steps": steps, "eval_batches": eval_batches, "wall_s": wall,
                         "launches": counts, "test_loss": test["loss"],
                         "config": {k: getattr(saved, k) for k in SCALED_KNOBS}}
        log(f"[train_scaled] CLI with the recipe's flags and --pretrained_dir, "
            f"{SCALED_CLI_DATA['n']} posts, one epoch: {steps} steps, {eval_batches} eval "
            f"batches, {wall:.1f} s; launches {counts}; test loss {test['loss']!r}")
        assert result["cli"]["config"] == SCALED_KNOBS, result["cli"]["config"]
        assert counts == {"k1": remat_k1 * steps + large["k1"] * eval_batches,
                          "k2": large["k1"] * steps,
                          "k3": remat_k3 * steps + large["k3"] * eval_batches}, counts
        assert math.isfinite(test["loss"])
        launches = {k: launches[k] + counts[k] for k in launches}
        report["train_scaled"] = result
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------- phases 17-19

# the JAX CLI's --dry_run line (d2r_tpu/cli.py::_dry_run)
DRY_RUN_KEYS = {"dry_run", "params", "flops_per_step", "bytes_accessed_per_step", "devices",
                "mesh", "batch_size", "max_seq", "compute_dtype"}


def sentic_texts(n, seed=0):
    """``n`` fabricated posts of 5-60 words, about half of them words of
    the SenticNet lexicon, the others filler words it lacks or has."""
    import numpy as np
    from d2r_tpu_torch.data.sentic import load_sentic_lexicon
    words = sorted(load_sentic_lexicon())
    filler = ["the", "a", "photo", "of", "my", "today", "zzq", "at", "we"]
    rng = np.random.default_rng(seed)
    return [" ".join(words[int(rng.integers(len(words)))] if rng.random() < 0.5
                     else filler[int(rng.integers(len(filler)))]
                     for _ in range(int(rng.integers(5, 61)))) for _ in range(n)]


def sentic_adjacency(n, max_seq, seed=0):
    """(n, max_seq, max_seq) fp32 adjacency of :func:`sentic_texts`, built by
    the port's ``batched_affective_adjacency``."""
    from d2r_tpu_torch.data.sentic import batched_affective_adjacency, load_sentic_lexicon
    return batched_affective_adjacency(sentic_texts(n, seed), load_sentic_lexicon(), max_seq)


def timed_steps(state, batch, warmup=WARMUP_STEPS, timed=TIMED_STEPS):
    """``warmup`` + ``timed`` train steps on ``batch`` (device tensors);
    step ms from CUDA events around each timed step."""
    import numpy as np
    import torch
    from d2r_tpu_torch.train.state import make_train_step
    step = make_train_step()
    losses, ms = [], []
    for i in range(warmup + timed):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch, 1)
        end.record()
        losses.append(metrics["loss"])
        if i >= warmup:
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    batch_size = batch["input_ids"].shape[0]
    med = float(np.median(ms))
    return state, {"steps": warmup + timed, "losses": [float(x) for x in losses],
                   "step_ms": ms, "step_ms_median": med,
                   "samples_per_s": batch_size / (med / 1e3)}


def step_runs(report_key, runs, batch, weights, after=None):
    """For each (name, cfg, extra inputs) of ``runs``, one after the other:
    a train state on the card from ``weights`` (a CPU state dict, each run
    taking the keys its model has), :func:`timed_steps` on ``batch`` plus
    the extras, peak memory above what was allocated before the run, the
    launch counts of the run (34 K1 and 34 K2 a step), then ``after(name,
    state, result)``. Returns ({name: result}, the launch counts summed)."""
    import torch
    from d2r_tpu_torch.models.unimo import D2RClassifier
    out, total = {}, {"k1": 0, "k2": 0, "k3": 0}
    for name, cfg, extra in runs:
        keys = set(D2RClassifier(cfg).state_dict())
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = fresh_state(cfg, {k: v for k, v in weights.items() if k in keys})
        b = {**batch, **{k: torch.from_numpy(v).cuda() for k, v in extra.items()}}
        zero_counts()
        state, r = timed_steps(state, b)
        counts = read_counts()
        r.update({"peak_mem_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                  "launches": counts})
        out[name] = r
        log(f"[{report_key}] {name}: step {r['step_ms_median']:.2f} ms (CUDA events, median of "
            f"{TIMED_STEPS}), {r['samples_per_s']:.1f} samples/s, peak {r['peak_mem_gb']:.2f} GB; "
            f"K1 / K2 / K3 {counts['k1']} / {counts['k2']} / {counts['k3']} in {r['steps']} "
            f"steps; losses {[round(x, 4) for x in r['losses']]}")
        assert counts == {"k1": 34 * r["steps"], "k2": 34 * r["steps"], "k3": 0}, counts
        assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
        total = {n: total[n] + counts[n] for n in total}
        if after is not None:
            after(name, state, r, b)
        del state, b
    torch.cuda.empty_cache()
    return out, total


def phase_sentic(report):
    """SenticNet graph refinement at full width, D2R-base at bench.py's
    recipe (batch 64, bf16): a train step with and without
    ``use_sentic_graph`` on the same weights and batch (the adjacency from
    the port's ``batched_affective_adjacency`` over texts with lexicon
    words); fp32 logits and one fp32 train step card against CPU; one CLI
    epoch of run.sh's recipe with ``--use_sentic_graph`` on phase 12's 512
    fabricated posts, with the loader's wait a step (the adjacency is built
    on the host, in Python loops, per item)."""
    import shutil
    import numpy as np
    import torch
    from d2r_tpu_torch.data.dataset import write_fake_dataset
    from d2r_tpu_torch.models.unimo import build_model

    cfg_s = model_config("base", batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                         use_sentic_graph=True)
    cfg_p = model_config("base", batch_size=TRAIN_BATCH, compute_dtype="bfloat16")
    weights = build_model(cfg_s, device="cpu", seed=0).state_dict()
    batch = {k: torch.from_numpy(v).cuda() for k, v in model_batch(cfg_s, TRAIN_BATCH, 0).items()}
    t0 = time.perf_counter()
    adj = sentic_adjacency(TRAIN_BATCH, cfg_s.max_seq)
    adj_ms = (time.perf_counter() - t0) * 1e3
    gcn = {}

    def after(name, state, r, b):
        if name == "sentic":
            gcn["grad_max"] = state.model.model.sentic_gcn.weight.weight.grad.abs().max().item()

    runs, total = step_runs("sentic", [("plain", cfg_p, {}), ("sentic", cfg_s, {"sentic_adj": adj})],
                            batch, weights, after)
    result = report["sentic"] = dict(runs)
    result["adjacency_host_ms_batch"] = adj_ms
    result["adjacency_nonzero_share"] = float((adj != 0).mean())
    result["step_ratio_sentic_over_plain"] = (runs["sentic"]["step_ms_median"]
                                              / runs["plain"]["step_ms_median"])
    result["gcn_grad_max"] = gcn["grad_max"]
    log(f"[sentic] adjacency of {TRAIN_BATCH} posts on the host: {adj_ms:.1f} ms, "
        f"{result['adjacency_nonzero_share']:.3f} non-zero; step sentic / plain "
        f"{result['step_ratio_sentic_over_plain']:.3f}; GCN weight grad max "
        f"{result['gcn_grad_max']:.3g}")
    assert result["gcn_grad_max"] > 0, "the GCN got no gradient"

    phase_card_vs_cpu(report, "base", sentic=True)
    phase_train_card_vs_cpu(report, "base", sentic=True)

    root = os.path.join("build", "chip_smoke_sentic")
    shutil.rmtree(root, ignore_errors=True)
    try:
        paths = write_fake_dataset(os.path.join(root, "data"), **TRAINER_DATA)
        flags = TRAINER_RECIPE + [
            "--num_epochs", "1", "--train_json", paths["train"], "--dev_json", paths["dev"],
            "--test_json", paths["test"], "--img_dir", paths["img_dir"],
            "--steps_per_dispatch", str(TRAINER_DISPATCH), "--use_sentic_graph"]
        records, counts, wall = cli_run(flags, root, "cli")
        steps, eval_batches = cli_counts(records, TRAIN_BATCH, TRAINER_DATA["n"])
        summary = next(r for r in records if r["kind"] == "summary")
        test = next(r for r in records if r["kind"] == "test")
        cli = result["cli"] = {
            "steps": steps, "eval_batches": eval_batches, "wall_s": wall, "launches": counts,
            "samples_per_sec": summary["samples_per_sec"],
            "step_ms_median": float(np.median(summary["step_ms"][1:])),
            "loader_wait_ms_median": float(np.median(summary["loader_wait_ms"])),
            "loader_wait_ms": summary["loader_wait_ms"], "test_loss": test["loss"]}
        plain_wait = report.get("train_cli", {}).get("loader_wait_ms_median")
        log(f"[sentic] CLI, run.sh recipe + --use_sentic_graph, 1 epoch of "
            f"{TRAINER_DATA['n']} posts: {steps} steps, {eval_batches} eval batches, K1 / K2 "
            f"{counts['k1']} / {counts['k2']}; {cli['samples_per_sec']:.2f} samples/s, step "
            f"median {cli['step_ms_median']:.2f} ms; loader wait a step median "
            f"{cli['loader_wait_ms_median']:.2f} ms"
            + (f" (phase 12 without the graph: {plain_wait:.2f})" if plain_wait else "")
            + f"; test loss {test['loss']!r}")
        assert counts == {"k1": 34 * (steps + eval_batches), "k2": 34 * steps, "k3": 0}, counts
        assert math.isfinite(test["loss"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {n: total[n] + counts[n] for n in total}


def op_profile(fn):
    """Device time of one call of ``fn`` by kind, from torch.profiler: the
    union of its kernels' spans (busy), K1 and K2 by kernel name, and by
    aten op (self device time) ``torch._int_mm`` and the float products
    (mm, addmm, bmm); ``other`` is the rest of busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, k1, k2 = [], 0.0, 0.0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
                and not getattr(e, "is_user_annotation", False)):
            spans.append((e.time_range.start, e.time_range.end))
            k1 += e.time_range.elapsed_us() * ("fused_attention_fwd" in e.name)
            k2 += e.time_range.elapsed_us() * ("fused_attention_bwd" in e.name)
    if not spans:
        return {"device_time": "not measured (no CUDA events in the trace)"}
    spans.sort()
    busy = busy_time(spans)
    by_op = {}
    for a in prof.key_averages():
        t = getattr(a, "self_device_time_total", None)
        if t is None:
            t = getattr(a, "self_cuda_time_total", 0.0)
        by_op[a.key] = by_op.get(a.key, 0.0) + t
    int_mm = by_op.get("aten::_int_mm", 0.0)
    gemm = sum(by_op.get(k, 0.0) for k in ("aten::mm", "aten::addmm", "aten::bmm"))
    return {"busy_ms": busy / 1e3, "window_ms": (spans[-1][1] - spans[0][0]) / 1e3,
            "idle_share": 1.0 - busy / (spans[-1][1] - spans[0][0]),
            "k1_ms": k1 / 1e3, "k2_ms": k2 / 1e3, "int_mm_ms": int_mm / 1e3,
            "float_gemm_ms": gemm / 1e3,
            "other_ms": (busy - k1 - k2 - int_mm - gemm) / 1e3,
            "top_ops_ms": {k: v / 1e3 for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:10]}}


def phase_int8(report):
    """int8 quantized training at full width: ``quant_dot`` card against CPU
    on the same operands (:data:`QDOT_SHAPES`; the forward bit for bit in
    fp32 and bf16, the backwards in fp32 with TF32 off within
    :data:`QDOT_BWD_TOL`), its time at the FFN shape beside a bf16 product
    and ``_int_mm`` alone; fp32 int8 logits card against CPU; ten bf16 steps
    of D2R-base at batch 64 with ``quant_train`` none, int8 and int8_all on
    the same weights and batch, and one traced step of each: how much of it
    is ``_int_mm``, the float products, and the rest (the quantize passes
    are what the rest grows by)."""
    import torch
    import torch.nn.functional as F
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.ops import qdot
    from d2r_tpu_torch.train.state import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = report["int8"] = {"quant_dot": []}
    for name, m, k, n in QDOT_SHAPES:
        g = torch.Generator().manual_seed(m + k + n)
        x, w, ct = (torch.randn(s, generator=g) for s in ((m, k), (n, k), (m, n)))
        for dtype in (torch.float32, torch.bfloat16):
            for mode in ("int8", "int8_all"):
                outs = []
                for dev in ("cpu", "cuda"):
                    xd = x.to(dev, dtype, copy=True).requires_grad_()
                    wd = w.to(dev, dtype, copy=True).requires_grad_()
                    y = qdot.quant_dot(xd, wd, mode)
                    y.backward(ct.to(dtype).to(dev))
                    outs.append([t.detach().float().cpu() for t in (y, xd.grad, wd.grad)])
                (y0, *b0), (y1, *b1) = outs
                row = {"shape": name, "m": m, "k": k, "n": n, "dtype": str(dtype)[6:],
                       "mode": mode, "forward_bit_equal": bool(torch.equal(y1, y0)),
                       "backward_bit_equal": all(torch.equal(a, b) for a, b in zip(b1, b0)),
                       "backward_max_err_over_max": max(
                           ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                           for a, b in zip(b1, b0))}
                result["quant_dot"].append(row)
                log(f"[int8] quant_dot {name} ({m}x{k} . {k}x{n}) {row['dtype']} {mode}: forward "
                    f"{'==' if row['forward_bit_equal'] else '!='} CPU; backward "
                    f"{'==' if row['backward_bit_equal'] else '!='} CPU, max err / max "
                    f"{row['backward_max_err_over_max']:.3g}")
                assert row["forward_bit_equal"], row
                if dtype == torch.float32:
                    assert row["backward_max_err_over_max"] <= QDOT_BWD_TOL, row
    _, m, k, n = QDOT_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
    w = torch.randn((n, k), generator=g, device="cuda").bfloat16()
    qx, qw = qdot._quantize(x, -1)[0], qdot._quantize(w, 1)[0]
    times = {"quant_dot_ms": cuda_time_ms(lambda: qdot.quant_dot(x, w)),
             "bf16_linear_ms": cuda_time_ms(lambda: F.linear(x, w)),
             "int_mm_ms": cuda_time_ms(lambda: qdot.int_mm(qx, qw)),
             "quantize_x_ms": cuda_time_ms(lambda: qdot._quantize(x, -1))}
    times.update({f"{k}_device": device_time_ms(fn) for k, fn in (
        ("int_mm_ms", lambda: qdot.int_mm(qx, qw)), ("bf16_linear_ms", lambda: F.linear(x, w)))})
    result["ffn_times"] = times
    log(f"[int8] FFN product {m}x{k} . {k}x{n}, bf16 in: " + ", ".join(
        f"{k} {v * 1e3:.2f} us" for k, v in times.items()))

    phase_card_vs_cpu(report, "base", quant="int8")

    cfg = {mode: model_config("base", batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                              quant_train=mode) for mode in qdot.MODES}
    weights = build_model(cfg["none"], device="cpu", seed=0).state_dict()
    batch = {k: torch.from_numpy(v).cuda() for k, v in model_batch(cfg["none"], TRAIN_BATCH, 0).items()}
    step = make_train_step()

    def after(mode, state, r, b):
        r["profile"] = op_profile(lambda: step(state, b, 1))
        log(f"[int8] {mode} traced step: " + json.dumps(
            {k: v for k, v in r["profile"].items() if k != "top_ops_ms"}))

    runs, total = step_runs("int8", [(mode, cfg[mode], {}) for mode in qdot.MODES], batch,
                            weights, after)
    none_other = runs["none"]["profile"].get("other_ms")
    for mode in ("int8", "int8_all"):
        p = runs[mode]["profile"]
        if none_other is not None and "other_ms" in p:
            p["quantize_passes_ms_estimate"] = p["other_ms"] - none_other
        runs[mode]["step_ratio_over_none"] = (runs[mode]["step_ms_median"]
                                              / runs["none"]["step_ms_median"])
    result["steps"] = runs
    log("[int8] step / none: " + ", ".join(
        f"{m} {runs[m]['step_ratio_over_none']:.3f} (quantize passes ~"
        f"{runs[m]['profile'].get('quantize_passes_ms_estimate', float('nan')):.2f} ms of device "
        f"time, _int_mm {runs[m]['profile'].get('int_mm_ms', float('nan')):.2f} ms)"
        for m in ("int8", "int8_all")))
    return total


def phase_extras(report):
    """The trainer extras through the CLI at run.sh's recipe, a few steps
    each on :data:`EXTRAS_DATA`: ``--dry_run`` prints the JAX CLI's key set;
    a synchronous ``--auto_resume`` run, the same with ``--async_checkpoint``
    (its best model and resume files load back equal bit for bit) and with
    ``--prng_impl threefry2x32`` (its best model equal to the rbg run's);
    then :data:`EXTRAS_RUNS` (int8, int8_all, each with
    ``--use_sentic_graph`` too, ``--debug_nans``), finite losses and 34 K1 +
    34 K2 a step each; and ``debug_nans`` on a batch with NaN pixels
    raising ``FloatingPointError``."""
    import contextlib
    import io
    import shutil
    import numpy as np
    import torch
    from d2r_tpu_torch import cli
    from d2r_tpu_torch.data.dataset import write_fake_dataset
    from d2r_tpu_torch.train.state import create_train_state, make_train_step

    root = os.path.join("build", "chip_smoke_extras")
    shutil.rmtree(root, ignore_errors=True)
    result = report["extras"] = {"runs": {}}
    total = {"k1": 0, "k2": 0, "k3": 0}

    def add(counts):
        for n in total:
            total[n] += counts[n]

    def diff(a, b):
        """The largest |a - b| over the tensors of two loaded checkpoints
        (0.0: equal bit for bit); inf where their structure differs."""
        if isinstance(a, torch.Tensor):
            if not isinstance(b, torch.Tensor) or a.dtype != b.dtype or a.shape != b.shape:
                return math.inf
            return 0.0 if torch.equal(a, b) else (a.double() - b.double()).abs().max().item()
        if isinstance(a, dict):
            if not isinstance(b, dict) or a.keys() != b.keys():
                return math.inf
            return max((diff(a[k], b[k]) for k in a), default=0.0)
        if isinstance(a, (list, tuple)):
            if not isinstance(b, (list, tuple)) or len(a) != len(b):
                return math.inf
            return max((diff(x, y) for x, y in zip(a, b)), default=0.0)
        return 0.0 if a == b else math.inf

    def load(*parts):
        return torch.load(os.path.join(root, *parts), map_location="cpu", weights_only=True)

    try:
        buf = io.StringIO()
        zero_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            line = cli.main(TRAINER_RECIPE + ["--dry_run", "--save_path", os.path.join(root, "dry")])
        counts = read_counts()
        add(counts)
        printed = json.loads(buf.getvalue().strip().splitlines()[-1])
        result["dry_run"] = {"line": line, "launches": counts, "wall_s": time.perf_counter() - t0}
        log(f"[extras] --dry_run: {json.dumps(printed)}; K1 / K2 {counts['k1']} / {counts['k2']}")
        assert printed == line and set(line) == DRY_RUN_KEYS, line
        assert counts == {"k1": 34, "k2": 34, "k3": 0}, counts
        assert not os.path.exists(os.path.join(root, "dry"))

        paths = write_fake_dataset(os.path.join(root, "data"), **EXTRAS_DATA)
        flags = TRAINER_RECIPE + [
            "--num_epochs", "1", "--train_json", paths["train"], "--dev_json", paths["dev"],
            "--test_json", paths["test"], "--img_dir", paths["img_dir"],
            "--steps_per_dispatch", "1"]

        def run(name, extra):
            records, counts, wall = cli_run(flags, root, name, extra)
            steps, eval_batches = cli_counts(records, TRAIN_BATCH, EXTRAS_DATA["n"])
            summary = next(r for r in records if r["kind"] == "summary")
            test = next(r for r in records if r["kind"] == "test")
            losses = [r["loss"] for r in records if r["kind"] == "train_window"]
            r = result["runs"][name] = {
                "flags": extra, "steps": steps, "eval_batches": eval_batches, "wall_s": wall,
                "launches": counts, "train_losses": losses, "test_loss": test["loss"],
                "step_ms": summary["step_ms"], "checkpoint_save_ms": summary["checkpoint_save_ms"]}
            log(f"[extras] CLI {' '.join(extra) or '(the recipe)'}: {steps} steps, "
                f"{eval_batches} eval batches in {wall:.1f} s; K1 / K2 {counts['k1']} / "
                f"{counts['k2']}; losses {[round(x, 4) for x in losses]}, test loss "
                f"{test['loss']!r}; best-model save {summary['checkpoint_save_ms']} ms")
            assert counts == {"k1": 34 * (steps + eval_batches), "k2": 34 * steps, "k3": 0}, counts
            assert all(math.isfinite(x) for x in losses + [test["loss"]]), losses
            add(counts)
            return r

        # --async_checkpoint: the best model, written by the save thread at the
        # end of the epoch, equals the resume slot written synchronously right
        # after from the same state; the test pass after its reload equals a
        # restore probe of the file. Two runs are compared too, for the record:
        # training on the card need not repeat bit for bit (cuBLAS and atomic
        # reductions), so the runs' master weights may differ by an ulp
        sync = run("sync", ["--auto_resume"])
        asyn = run("async", ["--auto_resume", "--async_checkpoint"])
        asyn["best_vs_resume_slot_max_abs_diff"] = diff(
            load("async", "best_model", "model.pth"), load("async", "resume", "slot_1", "model.pth"))
        records, counts, _ = cli_run(flags, root, "async_probe", [
            "--only_test", "--load_path", os.path.join(root, "async", "best_model")])
        probe = next(r for r in records if r["kind"] == "test")
        asyn["restore_probe_test_loss"] = probe["loss"]
        asyn["vs_sync_run_max_abs_diff"] = {
            f: diff(load("async", *f.split("/")), load("sync", *f.split("/")))
            for f in ("best_model/model.pth", "resume/slot_1/model.pth",
                      "resume/slot_1/train_state.pth")}
        log(f"[extras] --async_checkpoint: the thread's best model against the synchronous "
            f"resume slot of the same state: max abs diff "
            f"{asyn['best_vs_resume_slot_max_abs_diff']!r}; test loss {asyn['test_loss']!r}, "
            f"restore probe {probe['loss']!r}; against the synchronous run (another run): "
            f"{asyn['vs_sync_run_max_abs_diff']}, test loss {sync['test_loss']!r}")
        assert asyn["best_vs_resume_slot_max_abs_diff"] == 0.0
        assert probe["loss"] == asyn["test_loss"], (probe["loss"], asyn["test_loss"])
        shutil.rmtree(os.path.join(root, "async"))
        # --prng_impl threefry2x32: the rbg run's losses within PRNG_RUN_TOL
        # (two runs need not repeat bit for bit, above); other dropout bits
        # would move the first step's loss by far more. The names' bit
        # equality within one process is the CPU tests'.
        three = run("threefry2x32", ["--prng_impl", "threefry2x32"])
        three["best_model_vs_rbg_run_max_abs_diff"] = diff(
            load("threefry2x32", "best_model", "model.pth"), load("sync", "best_model", "model.pth"))
        pairs = list(zip(three["train_losses"] + [three["test_loss"]],
                         sync["train_losses"] + [sync["test_loss"]]))
        three["loss_max_rel_diff_vs_rbg_run"] = max(
            (abs(a - b) / max(1.0, abs(b)) for a, b in pairs), default=math.inf)
        log(f"[extras] --prng_impl threefry2x32: losses {three['train_losses']} and test loss "
            f"{three['test_loss']!r} against the rbg run's {sync['train_losses']} and "
            f"{sync['test_loss']!r} (max rel diff {three['loss_max_rel_diff_vs_rbg_run']!r}, "
            f"bound {PRNG_RUN_TOL}); best model max abs diff "
            f"{three['best_model_vs_rbg_run_max_abs_diff']!r}")
        assert (len(three["train_losses"]) == len(sync["train_losses"])
                and three["loss_max_rel_diff_vs_rbg_run"] <= PRNG_RUN_TOL), \
            "threefry2x32 trained otherwise than rbg"
        for name in ("sync", "threefry2x32", "async_probe"):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        for name, extra in EXTRAS_RUNS:
            run(name, extra)
            shutil.rmtree(os.path.join(root, name))

        cfg = model_config("base", batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                           debug_nans=True)
        state = create_train_state(cfg, total_steps=1000, device="cuda", seed=0)
        bad = model_batch(cfg, TRAIN_BATCH, 3)
        bad["pixel_values"][1, :, :8, :8] = np.nan
        try:
            make_train_step(True)(state, bad, 1)
        except FloatingPointError as e:
            result["debug_nans_error"] = str(e)
        log(f"[extras] debug_nans on a batch with NaN pixels: "
            f"{result.get('debug_nans_error', 'NO ERROR')}")
        assert "debug_nans: step 0" in result.get("debug_nans_error", ""), result
        del state
        torch.cuda.empty_cache()
        return total
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    import d2r_tpu_torch  # noqa: F401  (fails when run outside the repo)

    report = {"card": card_line()}
    log(f"[card] {report['card']}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    paths = {}   # launch counts of each path's run, by phase
    phases = [("build", phase_build), ("kernels", phase_kernels), ("k3", phase_k3)]
    for key in MODELS:
        suffix = MODELS[key]["suffix"]
        phases += [("main_path" + suffix, lambda r, k=key: phase_main_path(r, k)),
                   ("card_vs_cpu" + suffix, lambda r, k=key: phase_card_vs_cpu(r, k)),
                   ("train" + suffix, lambda r, k=key: phase_train(r, k)),
                   ("train_card_vs_cpu" + suffix,
                    lambda r, k=key: phase_train_card_vs_cpu(r, k))]
    phases.append(("train_cli", phase_train_cli))
    phases.append(("serve_http", phase_serve_http))
    phases += [("pretrained", phase_pretrained), ("train_scaled", phase_train_scaled),
               ("card_vs_cpu_alpha", lambda r: phase_card_vs_cpu(r, "base", alpha=CCR_ALPHA))]
    phases += [("train_sentic", phase_sentic), ("train_int8", phase_int8),
               ("train_extras", phase_extras)]
    failed = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            got = fn(report)
        except Exception as e:  # noqa: BLE001 - report every phase, then fail
            failed[name] = f"{type(e).__name__}: {e}"[:2000]
            log(f"[{name}] FAILED: {failed[name]}")
            traceback.print_exc()
            if name == "build":
                break
            continue
        finally:
            # what a phase leaves on the card goes before the next starts
            gc.collect()
            torch.cuda.empty_cache()
            report.setdefault("memory_gb", {})[name] = memory_gb()
        if (name.startswith(("main_path", "train", "serve", "pretrained"))
                and "card_vs_cpu" not in name):
            paths[name] = got
        report.setdefault("phase_s", {})[name] = time.perf_counter() - t0
        log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s; card memory (GB) "
            f"{json.dumps(report['memory_gb'][name])}")

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    if failed:
        # last on both streams, where the end of either shows it
        for stream in (sys.stdout, sys.stderr):
            print(f"chip_smoke: failed phases {list(failed)}", file=stream)
            for name, why in failed.items():
                print(f"chip_smoke: [{name}] {why}", file=stream)
            stream.flush()
        return 1

    # times at the most frequent site of each path (K1: serving, B=32, rate 0;
    # K2: training, B=64, rate 0.1; K3: the CLIP-L site, B=32); the error
    # over every check of the kernel; launches over every serving and
    # training run
    k1 = next(r for r in report["k1_sites"] if r["site"] == "bert" and r["dtype"] == "bfloat16")
    k2 = next(r for r in report["k2_sites"]
              if r["site"] == "bert" and r["dtype"] == "bfloat16" and r["rate"] > 0)
    k3 = next(r for r in report["k3_sites"] if r["site"] == "clip_l" and r["dtype"] == "bfloat16")
    k1_err = max(r["max_abs_err"] for r in
                 report["k1_sites"] + report["k1_edges"] + report["k1_dropout"])
    launches = {n: sum(c[n] for c in paths.values()) for n in ("k1", "k2", "k3")}
    row = lambda r: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "device_ms", "library_device_ms")}
    print(json.dumps({"kernels": [
        {"name": "fused_attention_fwd", "route": "cuda",
         "source": "d2r_tpu_torch/csrc/fused_attention_fwd.cu",
         "replaces": "d2r_tpu/ops/kernels/fused_attention.py:65",
         "launches": launches["k1"], "max_abs_err": k1_err, **row(k1)},
        {"name": "fused_attention_bwd", "route": "cuda",
         "source": "d2r_tpu_torch/csrc/fused_attention_bwd.cu",
         "replaces": "d2r_tpu/ops/kernels/fused_attention.py:101",
         "launches": launches["k2"],
         "max_abs_err": max(r["max_abs_err"] for r in report["k2_sites"]), **row(k2)},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "d2r_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "d2r_tpu/ops/kernels/flash_attention.py:37",
         "launches": launches["k3"],
         "max_abs_err": max(r["max_abs_err"] for r in report["k3_sites"]), **row(k3)}]}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
