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
   fp32 and bf16, errors only. Then K1 and K2 with dropout on rows 4: and
   heads 6: of a (8, 64, 12, 64) site, the slice's global offsets in its
   seed (``DropoutSeed.b0``/``.h0``, as a mesh rank passes them): out, dq,
   dk and dv equal the whole launch's rows and heads bit for bit. Then
   the W8A16 kernel of int8 serving against its plain version at
   D2R-base's sites (:data:`W8A16_SITES`: FFN in and out, the QKV with one
   scale a hidden unit, the patch conv) at the rows of buckets 1, 8 and
   32, and an odd shape, bf16 and fp32 (:data:`W8A16_TOL`), timed in bf16
   beside ``torch._weight_int8pack_mm`` (the one PyTorch call of the same
   product from the same codes, the library column, where the card's
   torch has a CUDA kernel for it), ``F.linear`` on the bf16 weight and
   the plain path, back to back and on the card alone, with its bound.
3. K3 against its plain version the same way, at D2R-large's vision-site
   geometry (B=32, L=S=257, H=16, D=64, strided QKV views, no bias), three
   off-path shapes (L=200, S=333, D=48, B=4, H=8 with a padding bias;
   L=S=1024, H=16, D=128 at batch 2; L=S=300, H=4, D=256, the widest head
   of the first two bodies, at batch 2 with a bias), four edges of the bf16
   tiling (L=17 against S=300 with a bias; S=1; D=37; rows padded by 4)
   and two heads for the wide body (L=S=257, H=2, B=2: D=320 with a bias,
   D=512, timed on the card alone too), max abs error <= 1e-5
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
   and idle share, K1's and K3's share, the top kernels. Then weight-only
   int8 serving (``int8_serving``): the same seeded model behind
   ``Predictor(quantize="int8")``, each of its 449 quantized modules one
   W8A16 product (2 host calls a module a bucket at warmup), at every
   bucket its replay equal to its eager forward bit for bit and within
   ``QUANT_LOGITS_TOL`` of the eager forward through the W8A16 plain
   version (labels equal), its replay ms beside the bf16 one's in turns,
   and a trace of the bucket-1 replay: one W8A16 kernel a module and no
   more elementwise kernels than the bf16 replay has (no pass over a
   weight).
5. The same model in fp32 (TF32 off), batch 2, on the CPU through the plain
   path and on the card through the kernel: logits within 1e-3.
6. Training at full width, ``bench.py``'s recipe: the same D2R-base, batch
   64, bf16 compute, fp32 parameters, AdamW at the reference's four groups
   (``d2r_tpu_torch.train.state``), on a batch made with numpy the way
   ``synthetic_batch`` makes it (PAD ids included), through the captured
   step: 3 warm-up steps (the state's 2 eager ones and the capture's) and
   10 timed replays (CUDA events, median). Counts set to 0 before, read
   after: K1 and K2 are called 34 times a warm-up step and at the capture,
   never in a replay; one AdamW call likewise. The loss is finite, every
   parameter and every BatchNorm running buffer has moved, and the PAD
   embedding row got an exactly zero gradient (AdamW's decoupled weight
   decay still shrinks it, as in the reference). Then torch.profiler
   traces of 3 replayed steps (34 K1, 34 K2 and 1 AdamW kernel a step,
   the hidden-dropout kernel as often as an eager step launches it, each
   one's device ms; no ``_foreach`` pass but the gradients' zeroing), 3
   replays whose host code runs under ``torch.cuda.set_sync_debug_mode("error")``, 3 eager steps
   of the same state (timed) and one traced; then ``replay_checks``: from
   the same initial weights, 5 steps (2 eager, 3 replayed) against 5
   eager ones, dropout off and on: losses within 1e-4 and parameters
   within 1e-3 of each leaf's max |value|, and with dropout on K1's keep
   masks at two sites, read back from the state's seed buffer after each
   replayed step, equal to the eager derivation's and new each step.
7. One train step of D2R-base in fp32 (TF32 off), batch 2, dropout off
   through a registered dropout-0 preset, two ill-conditioned spots of the
   random weights moved off (see the phase), on the CPU (plain path) and on the card (K1/K2):
   loss within 1e-4; the gradients of ``fc``, one BERT ``qkv``, one CLIP
   ``qkv``, one IMRC ``sa_qkv`` and one SAF BatchNorm within 1e-3 of each
   leaf's max |grad|; the updated parameters of those leaves and the
   BatchNorm running statistics agree too. Beside it, the same step on the
   card with every attention site through the plain versions: the kernels'
   own share of the difference.
8-11. Phases 4-7 (and phase 6's capture checks) again for D2R-large, the scaled recipe
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
   batch 16 calls K1, K2 and K3 29 times a warm-up step and at the
   capture, and the PAD row is row 1. The fp32 train step card against CPU adds the image-branch IMRC
   ``sa_qkv`` (K3's path, as the CLIP-L ``qkv`` is) to the leaves.

12. The training entry point as a user runs it: ``d2r_tpu_torch.cli.main``
   at ``run.sh``'s recipe (``TRAINER_RECIPE``: D2R-base, batch 64, bf16) for
   two epochs on ``write_fake_dataset(n=512, image_size=256,
   corrupt_every=50)`` through the port's tokenizer, decoders, loader,
   trainer and checkpoints. The items that decode to the fallback frame
   must be exactly the corrupt files. Counts set to 0 before, read after:
   34 K1 and 34 K2 host calls a warm-up step and at the capture (the
   trainer runs the captured step), 34 K1 at the eval warm-up forward and
   at the eval capture (dev and test batches share one signature, and
   every later eval batch is a replay); finite losses;
   the best model and ``config.json`` saved. The trainer's own
   samples/s and the shares of its epoch loop, step time (CUDA events a
   step: median, quartiles and extremes), host wait on the loader, eval and
   checkpoint-save times and bytes, and K1's, K2's and AdamW's card time
   and kernel counts in a replayed step from the run's ``--profile_dir``
   trace (the first dispatch after the capture). Then the restore probe:
   ``--only_test --load_path <best_model>`` gives the trained run's test
   loss bit for bit. Then ``eval_replay_check`` on the best model: three
   different batches through the captured eval step, each batch's kept
   loss and logits equal to its eager forward bit for bit, again after a
   train step and after ``restore_checkpoint``, and a dev pass (8 batches
   of 64) timed eager and replayed.

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
   within 1e-6 of each leaf's max |value|, the difference reported. The
   recipe's captured step against its eager step (phase 6's
   ``replay_checks``). Then the CLI for one epoch of 64 posts with all of
   the recipe's flags and ``--pretrained_dir``; eval batches launch 29 K1
   and 29 K3.
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
18. int8 quantized training: first the quantize kernels (by rows, in one
   launch and as amax + codes; by columns, codes transposed) and the
   rescale kernel against their plain versions at :data:`QDOT_SHAPES`,
   fp32 and bf16, bit for bit, at the FFN shape inside a captured graph
   too; the rows quantize at every site of :data:`QUANT_ROW_SITES` (bf16,
   the two activation sites in fp32 too), bit for bit in its three uses,
   the columns quantize and the rescale at the FFN shape, with their times
   beside the plain versions' and their bounds; then ``quant_dot`` card
   against CPU on the same operands at a BERT FFN
   product and at an odd shape that takes the
   padding to ``_int_mm``'s shapes (:data:`QDOT_SHAPES`), fp32 and bf16:
   the forward bit for bit, the backwards in fp32 within
   :data:`QDOT_BWD_TOL`; the FFN product's time beside a bf16 ``F.linear``
   and ``_int_mm`` alone. Phase 5 with ``quant_train="int8"`` (within
   :data:`QUANT_LOGITS_TOL`, equal labels). 13 bf16 steps each with
   ``quant_train`` none, int8 and int8_all from the same weights and batch
   (34 K1 and 34 K2 a step), one traced replay of each (the quantize
   kernels' launches and device ms a replayed step, by name) and one
   traced eager step of each: device time of ``_int_mm``, of the float
   products and of the rest, whose growth over ``none`` is the quantize
   passes.
19. The trainer extras through the CLI at ``run.sh``'s recipe, one epoch
   on :data:`EXTRAS_DATA`: ``--dry_run`` prints the JAX CLI's keys (one
   step: 34 K1, 34 K2); ``--auto_resume`` with and without
   ``--async_checkpoint`` (the thread's best model equal bit for bit to the
   resume slot written synchronously from the same state, the test pass
   after its reload equal to a restore probe's; the two runs' weights
   compared for the record); ``--prng_impl threefry2x32`` (the rbg run's
   losses bit for bit); :data:`EXTRAS_RUNS`; then ``debug_nans`` on a batch
   with NaN pixels raises ``FloatingPointError``. It runs in the second
   process after ``serve_export``'s checks (host work: the CLI a few steps
   at a time), and the last phase, ``train_extras``, takes its report and
   launch counts.

Between phases 13 and 14, ``mesh_start``: the one-process
fp32 runs of phases 23, 21 and 20's meshes (:data:`BACKGROUND_MESHES`) and
``serve_mesh``'s checkpoint and posts, then their ranks and servers from a
thread of the script's process, one after the other, beside phases 14
and 15 and on: the ranks spend most of a step waiting
on gloo's copies through host memory, and those phases mostly on the host
or in CUDA graphs. Phases 20, 21, 23 and ``serve_mesh`` wait for them and
check them.

20-21. Training across processes (``d2r_tpu_torch/parallel``), D2R-base
   at full width with towers of :data:`MESH_DEPTH` blocks (cut for the
   script's time limit), global batch 64, on meshes dp = 2 (phase 20) and
   (2, 2) (phase 21, whose model axis is tp = 2). The machine has one card and NCCL takes one rank a card, so
   the ranks run on the one card over gloo (``parallel.launch.spawn``;
   gloo carries the CUDA tensors through host memory, and every collective
   of the port is an all-reduce or a broadcast, the two gloo takes on
   CUDA tensors). Their step times say nothing about scaling. First the
   one-process run, from :func:`mesh_base_model` in fp32 (TF32 off,
   dropout off): a train-mode forward and one train step, saved. Then each
   rank, from the same CPU-built weights cut to its slices: loss and JS
   loss within rtol 2e-5, its logits rows within 2e-5, the BatchNorm
   running statistics within rtol 2e-5 of the one-process run's; the step's
   loss within rtol 2e-4 and, on rank 0, every element of the whole
   gradient and of the updated parameters within rtol 2e-4 / atol 2e-6
   (:func:`mesh_fp32_errors` says which parameter elements it excuses and
   why: Adam's step where the gradient is within that tolerance of 0).
   Then 3 bf16 steps with the text tower's dropout (0.1): 18 K1 and 18 K2
   launches a step on every rank (4 + 4 tower blocks, 2 extra layers, 8
   IMRC cells), the kernels seeing each rank's own heads
   (6 / 6 / 8 at the BERT / CLIP / IMRC sites at tp = 2), step ms a rank,
   the step's dropout seeds the same on every rank with the rank's global
   (row, head) offsets (K1's masks of two ranks each the one-process mask
   cut at their rows and heads, differing from each other in ≈18% of a
   site's elements), and afterwards the tensors that the model
   axis leaves whole bit-equal across the model ranks and every tensor
   bit-equal across the data ranks (``parallel.mesh.replica_mismatches``).
   Phase 21's ranks then run ``seq_shard``, ``fabric_shard`` and
   ``quant_train="int8"`` in fp32 against one process (the plain run for
   the two hints, an int8 one-process run for int8, whose gradients are
   held within 2/127 of each leaf's max, a share of 1e-5 of the elements
   excepted, and the parameters excused only where they differ by what
   Adam's first step makes of the two gradients), and both phases' ranks
   one fp32 step with the text tower's dropout on under
   ``prng_impl="threefry2x32"`` against one process's dropout step under
   rbg, at the plain run's tolerances (the masks keyed on global
   coordinates), recording each rank's step peak
   memory and routing-fabric ms beside the plain run's, and ``quant_dot``
   split over the model group along K and along N, bit for bit one
   process's (:func:`qdot_mesh_check`).
22. The CLI with ``--coordinator_address 127.0.0.1:<free> --num_processes 1
   --process_id 0``: a process group of one under NCCL, two epochs at
   run.sh's recipe on :data:`EXTRAS_DATA` (four steps, captured as in one
   process; 34 K1 an eval batch) and its restore probe (the test loss bit for bit); the
   group ended at the CLI's exit. With two cards or more, also two NCCL
   processes (dp = 2); with one, that is logged as not run.
23. Pipeline stages (``models/pipeline.py``), D2R-base at full width and
   depth. In one process (bf16, batch 64, 2 stages x 4 microbatches,
   captured): its step timed beside the sequential one; in fp32 four
   steps (two eager, the capture, a replay) against the sequential steps
   from the same weights (dropout off; every loss within 1e-4, the first
   step's gradients within 1e-3 of each leaf's max, the parameters after
   it within rtol 2e-4 / atol 2e-6 but where that bound leaves Adam's sign
   free; every step's gradient and parameter gaps recorded), 106 K1 and
   106 K2 a step (24 blocks x 4 microbatches + 10), the
   replays against eager steps (:func:`replay_checks`), and a pipelined
   checkpoint through ``restore_model``, served unpipelined at bucket 8
   with the unpipelined model's probabilities bit for bit. Then the stage
   mesh (data, stage, model) = (1, 2, 2) on the one card over gloo, its
   ranks run in the background since ``mesh_start``: fp32 against the
   one-process sequential run at 2 microbatches (as phases 20-21), 2 bf16
   dropout steps at 2 and at 4 microbatches each
   (per rank 34 and 58 K1 and K2 a step: 6 + 6 blocks a microbatch, 2
   extra layers, 8 IMRC cells), step ms and peak memory a rank (not
   scaling figures: four ranks share one card through host memory), the
   pipeline's (microbatch, block) dropout seeds all distinct, within and
   across the stages.
24. ``serve_mesh``: serving over a mesh, D2R-base at full width (bf16,
   buckets 1/8/32), run in the background since ``mesh_start``: ``python
   -m d2r_tpu_torch.server --dp 2`` (two processes on the one card over
   gloo, each replaying its CUDA graphs of its share of a bucket) answers
   /predict_batch of 1, 8 and 32 posts, and a (data, model) = (1, 2)
   ``Predictor`` (eager, each rank K1 on its own heads) the same rows;
   each against one process's replay of the same arrays within
   ``QUANT_LOGITS_TOL``, labels equal, both ranks' answers equal. Not a
   scaling figure: the ranks share one card.

After phase 15, ``serve_export``: the serving artifact as a user makes
it. After ``step_kernels``, ``export_start`` saves phase 13's D2R-base
checkpoint under ``build/`` and starts a second process
(``background_process``), which runs beside phases 4-18 (exporting and
loading programs is host work: tracing and JSON; a program's trace and
save take 15-28 s and its load 8-19 s on that machine):
``export_artifacts``, that is ``python -m d2r_tpu_torch.export`` at
buckets 1/8/32 (uint8 pixels; the CLI's self-check reloads bucket 1),
again with ``--quantize int8`` at ``EXPORT_INT8_BUCKETS``, D2R-large at
``EXPORT_LARGE_BUCKETS`` through ``export_predictor``, and ``--format
torch``; then their checks (``serve_export_checks``), whose report
``serve_export`` takes; then phase 19, which the last phase,
``train_extras``, takes. The checks: ``load_exported`` with the
checkpoint's model: each bucket's program holds 34 K1 op nodes
(``d2r_torch::fused_attention_fwd``; D2R-large 29 and 29 K3; an int8
program also one ``d2r_torch::w8a16_linear`` node a quantized module) and
no einsum of the plain attention, its warm-up calls K1 2 x 34 times (the
eager forward and the capture through the program), its replayed
probabilities equal ``Predictor``'s on the same rows (atol 1e-6, labels
equal; int8 within ``QUANT_LOGITS_TOL``; the difference is printed), and
traced replays at the first and last bucket (bf16 and large) show the
kernels by name. Per
bucket: trace and save s, program bytes against the bytes of the tensors
it takes, load s, replayed forward ms beside ``Predictor``'s; the
reference checkpoint's key count.

Between phases 3 and 4, ``step_kernels``: the AdamW kernel against its
16-pass plain twin, bit for bit, fp32 and bf16 first moments, 3 steps
through a fractional warmup, on odd sizes (1, 3, 1023, 2^25 + 7), on a
list cut from one flat buffer at 4-byte offsets (the scalar body) and on
D2R-base's 400,186,367-element parameter list, timed there beside
``torch.optim.AdamW(fused=True)`` and the bytes bound; the hidden-dropout
kernel against its plain version at a BERT hidden state (64, 64, 768) and
D2R-large's (16, 64, 1024), bf16 and fp32, and an odd shape, forward and
backward bit for bit, timed beside ``F.dropout``; on views 2-8 bytes off
16-byte alignment, at ragged sizes and under a layout whose seg is 4 mod
8; then the sliced hidden dropout (a sequence half,
a data rank's batch half, both) equal to the whole tensor's elements; then
one forward of each module of ``models/extras.py`` and each loss of
``ops/losses_extra.py``, card against CPU in fp32 (:data:`EXTRAS_TOL`).

It prints one ``kernels`` JSON line (K1, K2, K3, the AdamW kernel, the
hidden-dropout kernel, W8A16 and the quantize-rows, quantize-columns and
rescale kernels; ``launches`` counts the
wrappers' host calls in the serving and training runs of both
configurations, the HTTP phase, phases 14-15, the main-path runs of
phases 17-19 (not their card-against-CPU checks) and the bf16 steps of
every rank of phases 20-21 and 23, the CLI runs of phase 22 and the
(1, 2) Predictor's ranks of phase 24, a graph capture
counting once and a replay not at all; ``ms``, ``plain_ms`` and
``library_ms`` back to back from the host, ``device_ms`` and
``library_device_ms`` the card alone), the card line, and last
``{"ok": true, "device": {...}}``; the log's ``[total]`` line gives the
whole run's seconds. The full report also goes to
``chiprun_out/chip_smoke.json``.
"""

import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core fp32; dense bf16
BUCKETS = (1, 8, 32)
REQUESTS = (1, 3, 8, 20, 40)
# torch.profiler's trace of a forward at D2R-large, bucket 32, loses a few of
# its ~9,000 kernel events in most runs (kernels a forward read 2,982.33 and
# 2,958.33 for the 2,983 every run launches); a kernel count is read again
# from a new trace when the trace shows that loss, at most this many times
TRACE_ATTEMPTS = 3
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
             ("row_pad", 4, 257, 257, 4, 64, False, 4),
             # heads wider than 256: the wide body (any D), at the
             # 257-token geometry
             ("wide_d320", 2, 257, 257, 2, 320, True, 0),
             ("wide_d512", 2, 257, 257, 2, 512, False, 0),
             # the CLIP-L site at the other serving buckets and the
             # training batch
             ("clip_l_b1", 1, 257, 257, 16, 64, False, 0),
             ("clip_l_b8", 8, 257, 257, 16, 64, False, 0),
             ("clip_l_b16", 16, 257, 257, 16, 64, False, 0))
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
# W8A16 (int8 serving's product) at D2R-base's sites, (name, rows a post,
# N, K, scale period): the BERT FFN in and out and the QKV (one scale a
# hidden unit, shared by q, k and v) at 64 rows a post, the patch conv's
# 49 patches of 3,072 pixels, the 768 x 768 products (the attention
# outputs and the fabric's token projections: 194 of a forward's 449
# products) at 64 rows a post, and the fabric's products of one row a post
# (116 a forward); at the rows of buckets 1, 8 and 32 (each of the
# kernel's bodies), bf16 and fp32; then an odd shape that 16-byte copies cannot stage. The sums run in
# another order than the library GEMM's, so an output is within fp32
# summation noise of the plain path's before its one rounding: bf16 within
# 1e-2 of max(1, max |plain|) (one bf16 ulp of the largest outputs, 2^-8 of
# their size, twice over), fp32 within 1e-5
W8A16_SITES = (("ffn_in", 64, 3072, 768, 3072), ("ffn_out", 64, 768, 3072, 768),
               ("qkv", 64, 2304, 768, 768), ("patch_conv", 49, 768, 3072, 768),
               ("proj_768", 64, 768, 768, 768), ("row_a_post", 1, 768, 768, 768))
W8A16_BUCKETS = (1, 8, 32)
W8A16_ODD = ("odd", 5, 3, 37, 3)
W8A16_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
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
# The serving export (phase serve_export): the CLI at the serving buckets
# for D2R-base in bf16, ``--quantize int8`` at two of them, D2R-large at
# bucket 1
EXPORT_INT8_BUCKETS = (1, 8)
EXPORT_LARGE_BUCKETS = (1,)
# the most phase serve_export waits for the export process still running
# (on an H100 host its exports ran 386.9 s beside phases 4-13, and its
# checks ≈120 s after them)
EXPORT_WAIT_S = 900
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
# the rows quantize's sites in a D2R-base step at batch 64 (64 x 64 tokens)
# and CLIP-B's (64 x 50): (name, R, K, types); each is timed beside its
# plain version and its bound and held to the plain version bit for bit
QUANT_ROW_SITES = (("x", 4096, 768, ("bfloat16", "float32")),         # QKV, FFN in, attn out
                   ("x_ffn_out", 4096, 3072, ("bfloat16", "float32")),  # FFN out; int8_all's g
                   ("clip_x", 3200, 768, ("bfloat16",)),
                   ("qkv_w", 2304, 768, ("bfloat16",)),
                   ("ffn_in_w", 3072, 768, ("bfloat16",)),
                   ("ffn_out_w", 768, 3072, ("bfloat16",)),
                   ("attn_out_w", 768, 768, ("bfloat16",)))
QDOT_BWD_TOL = 1e-5
# the trainer extras through the CLI (phase 19): run.sh's recipe for one
# epoch on a small fabricated dataset (two train steps, one dev and one
# test batch of 64 each)
EXTRAS_DATA = {"n": 128, "image_size": 256, "corrupt_every": 50}
# --prng_impl threefry2x32 against rbg through the CLI: the two names draw
# the same bits, and two CLI runs on the card repeat bit for bit since the
# token-type table's gradient is summed in a fixed order
# (``models/layers.py::_SmallTableLookup``; before, the library's atomics
# left the best models of two runs up to 1.86e-9 apart, and
# ``bisect_cli_runs.py`` found that gradient at the first step to be where
# they parted), so their losses and best models are held equal
PRNG_RUN_TOL = 0.0
# the CLI's configurations of phases 17-19 beside the recipe's defaults
EXTRAS_RUNS = (("int8", ["--quant_train", "int8"]),
               ("int8_all", ["--quant_train", "int8_all"]),
               ("sentic_int8", ["--use_sentic_graph", "--quant_train", "int8"]),
               ("sentic_int8_all", ["--use_sentic_graph", "--quant_train", "int8_all"]),
               ("debug_nans", ["--debug_nans"]))
# Training across processes (phases 20-22). The card's machine has one
# H100, and NCCL takes one rank a card, so the mesh phases run their ranks
# on the one card over gloo (CUDA tensors through host memory): they hold
# the mesh to one process and run K1 and K2 in every rank; they measure no
# scaling. D2R-base at full width, global batch 64; phases 20-21 cut its
# towers to MESH_DEPTH blocks (the script's time limit), phase 23
# (train_pp) runs them whole, 6 blocks a stage. Each phase: its meshes,
# tower depth, pipeline stages and microbatches (fp32 check; bf16 steps at
# each of ``bf16_microbatches``, ``bf16_steps`` of them, default
# PARALLEL_BF16_STEPS), and the configurations its ranks run after the
# plain one (fp32, each against one process).
MESH_DEPTH = 4
# a mesh step with the text tower's dropout on (0.1) under threefry2x32,
# held in fp32 to one process's step with dropout on under rbg: the masks
# are keyed on global coordinates, so the mesh draws one process's, and the
# two names give the same bits
DROPOUT_THREEFRY = dict(dropout=True, prng_impl="threefry2x32")
PARALLEL_MESHES = {
    "train_dp": dict(shapes=[(2,)], depth=MESH_DEPTH,
                     more=(("dropout_threefry", DROPOUT_THREEFRY),)),
    "train_tp": dict(shapes=[(2, 2)], depth=MESH_DEPTH,
                     more=(("seq_shard", dict(seq_shard=True)),
                           ("fabric_shard", dict(fabric_shard=True)),
                           ("int8", dict(quant_train="int8")),
                           ("dropout_threefry", DROPOUT_THREEFRY))),
    "train_pp": dict(shapes=[(1, 2, 2)], depth=12, stages=2, microbatches=2,
                     bf16_microbatches=(2, 4), bf16_steps=2),
}
PARALLEL_BF16_STEPS = 3
# the meshes whose ranks run in a thread of the script's process beside
# the phases after mesh_start (pretrained, train_scaled, ...: host work and
# the card's, while the ranks wait on gloo), one after the other; phases
# 20, 21 and 23 collect them, waiting at most MESH_WAIT_S
BACKGROUND_MESHES = ("train_pp", "train_tp", "train_dp")
MESH_WAIT_S = 1300
# serving over a mesh (phase serve_mesh), D2R-base at full width: the HTTP
# service as ``python -m d2r_tpu_torch.server --dp 2`` (two processes on
# the one card over gloo, each replaying its CUDA graphs of its rows), then
# a (data, model) = (1, 2) Predictor (eager); each answers SERVE_MESH_ROWS
# posts (buckets 1/8/32) against one process's replay within
# QUANT_LOGITS_TOL, labels equal. Its lane runs after the meshes'.
SERVE_MESH_ROWS = (1, 8, 32)
SERVE_MESH_SHAPE = (1, 2)
# int8 training on a mesh against one process (phase 21): a quantized
# activation's code can flip where the float work before it (a data-group
# sum) rounds differently, which moves a gradient by a step of its
# slice's scale; gradients are held within two such steps, 2/127 of the
# leaf's max, the bound of tests/test_torch_qdot.py
QDOT_STEP_BOUND = 2 / 127
# ...and the share of gradient elements allowed beyond it: each flipped
# code moves the gradients of what its row feeds, so at full width a few
# elements in a million land beyond two steps (3.9e-6 on an H100 at (2, 2)
# with 4-block towers, the first reading; the bound set after it)
INT8_MESH_GRAD_SHARE = 1e-5
# the one-process pipelined step (phase 23): two stages over four
# microbatches, captured, against the sequential step
PP_LOCAL = dict(pipeline_stages=2, pipeline_microbatches=4)
# phase 22's epochs on EXTRAS_DATA: 4 steps, so that the step is captured
MP_EPOCHS = 2
# the fp32 mesh run against the one-process run: the JAX package's
# tolerances (tests/test_dp_semantics.py, tests/test_tp_semantics.py)
MESH_FWD_RTOL, MESH_LOGITS_ATOL = 2e-5, 2e-5
MESH_STEP_RTOL, MESH_STEP_ATOL = 2e-4, 2e-6
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


T0 = time.perf_counter()


def log(msg):
    """``msg`` on stdout behind the seconds since the script started."""
    print(f"{time.perf_counter() - T0:7.1f} {msg}", flush=True)


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
            if any(w in line for w in ("entry function", "registers", "spill", "smem",
                                       "serialized", "setmaxnreg")):
                log(f"[build] {name}: {line.strip()}")


def device_seed(seed, site=0):
    """A K1/K2 dropout seed as a training forward hands it to them: the
    64-bit ``seed`` in a device buffer, and a site ordinal."""
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    return fa.DropoutSeed(fa.seed_tensor(seed, "cuda"), site)


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
    report["dropout_offsets"] = offset_checks(failures)
    report["w8a16_sites"] = w8a16_checks(failures)
    if failures:
        raise AssertionError("; ".join(failures))


def w8a16_bound(m, n, k, period, dtype_name):
    """The least time of an (M, N, K) W8A16 product with a bias: the int8
    codes, scales, x, bias and output moved once at 3.35 TB/s, against 2 M N
    K operations at the type's peak."""
    item = 4 if dtype_name == "float32" else 2
    nbytes = n * k + 4 * period + (m * k + n + m * n) * item
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * n * k / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def w8a16_checks(failures):
    """The W8A16 kernel against its plain version (the dequantized weight,
    then ``F.linear``) at :data:`W8A16_SITES` for the rows of
    :data:`W8A16_BUCKETS` and at :data:`W8A16_ODD`, bf16 and fp32 (TF32
    off): the error over max(1, max |plain|) within :data:`W8A16_TOL` and
    the share of outputs that differ at all. In bf16, times beside the
    library call (``library_*``: ``torch._weight_int8pack_mm`` on the same
    codes with the scales expanded to N, one call and so without the bias,
    where the card's torch has a CUDA kernel for it; else ``None`` and a
    log line saying so), ``F.linear`` on the bf16 weight (``f_linear_*``: what bf16 serving
    runs) and the plain path, back to back and on the card alone, and the
    bound."""
    import torch
    import torch.nn.functional as F
    from d2r_tpu_torch.ops.kernels import w8a16
    rows = []
    cases = [(site, b, rows_a_post * b, n, k, period)
             for b in W8A16_BUCKETS for site, rows_a_post, n, k, period in W8A16_SITES]
    cases.append((W8A16_ODD[0], 1, *W8A16_ODD[1:]))
    int8pack = torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int8pack_mm", "CUDA")
    log(f"[W8A16] torch._weight_int8pack_mm has {'a' if int8pack else 'no'} CUDA kernel in "
        f"torch {torch.__version__}")
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for i, (site, b, m, n, k, period) in enumerate(cases):
            g = torch.Generator(device="cuda").manual_seed(300 + i)
            x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
            q = torch.randint(-127, 128, (n, k), generator=g, device="cuda").to(torch.int8)
            scale = torch.rand((period,), generator=g, device="cuda") * 2e-3 + 1e-4
            bias = torch.randn((n,), generator=g, device="cuda").to(dtype)
            out = w8a16.w8a16_linear(x, q, scale, period, bias)
            torch.cuda.synchronize()
            ref = w8a16.w8a16_linear_plain(x, q, scale, period, bias)
            err = ((out.float() - ref.float()).abs().max()
                   / ref.float().abs().max().clamp_min(1.0)).item()
            r = {"site": site, "bucket": b, "dtype": dtype_name, "M": m, "N": n, "K": k,
                 "period": period, "tiling": list(w8a16.tiling(m, n, k, dtype)),
                 "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                 "err_over_max": err, "differing_share": (out != ref).float().mean().item()}
            if not (err <= W8A16_TOL[dtype_name] and torch.isfinite(out).all().item()):
                failures.append(f"W8A16 {site} b{b} {dtype_name}: error over max {err}")
            if dtype_name == "bfloat16":
                weight = w8a16.dequantize(q, scale, period, dtype)
                kernel = lambda: w8a16.w8a16_linear(x, q, scale, period, bias)
                linear = lambda: F.linear(x, weight, bias)
                plain = lambda: w8a16.w8a16_linear_plain(x, q, scale, period, bias)
                r["bound_ms"], r["bound_by"] = w8a16_bound(m, n, k, period, dtype_name)
                r.update({"ms": cuda_time_ms(kernel), "plain_ms": cuda_time_ms(plain),
                          "f_linear_ms": cuda_time_ms(linear),
                          "plain_device_ms": device_time_ms(plain),
                          "device_ms": device_time_ms(kernel),
                          "f_linear_device_ms": device_time_ms(linear),
                          "library_ms": None, "library_device_ms": None})
                if int8pack:
                    scales_n = scale.repeat(n // period)
                    library = lambda: torch._weight_int8pack_mm(x, q, scales_n)
                    r.update({"library_ms": cuda_time_ms(library),
                              "library_device_ms": device_time_ms(library)})
            rows.append(r)
            log(f"[W8A16] {site:10s} b{b:<2d} {dtype_name:8s} {m}x{k} -> {n} (period {period}, "
                f"tiling {r['tiling']}): err / max {err:.3g}, differing {r['differing_share']:.4f}"
                + (f"; kernel {r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
                   f"F.linear bf16 {r['f_linear_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f}"
                   f" us ({r['bound_by']}); card time alone: kernel {r['device_ms'] * 1e3:.2f} us, "
                   f"F.linear {r['f_linear_device_ms'] * 1e3:.2f} us, plain "
                   f"{r['plain_device_ms'] * 1e3:.2f} us, _weight_int8pack_mm "
                   + (f"{r['library_ms'] * 1e3:.2f} us back to back, "
                      f"{r['library_device_ms'] * 1e3:.2f} us alone"
                      if r["library_ms"] is not None else "not timed (no CUDA kernel)")
                   if "ms" in r else ""))
    return rows


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
                seed = device_seed(2 ** 33 + i, site=i) if rate else None
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
            scale, seed = d ** -0.5, device_seed(2 ** 40 + 17, site=5)
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
            scale, seed = d ** -0.5, (device_seed(12345, site=2) if rate else None)
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
                seed = device_seed(2 ** 35 + i, site=i) if rate else None
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
    out = fa.fused_attention_small(q, k, v, bias, 0.125, 0.5, device_seed(1234))
    out.sum().backward()
    a, b = v.grad.sum().item(), out.sum().item()
    log(f"[K1/K2 dropout identity] sum(dv) {a:.6f}, sum(out) {b:.6f}")
    if not abs(a - b) <= 1e-3 * abs(b):
        failures.append(f"dropout identity: sum(dv) {a} != sum(out) {b}")
    return {"sum_dv": a, "sum_out": b}


def offset_checks(failures):
    """K1 and K2 with dropout on a slice of the batch rows and heads, the
    slice's global offsets in its seed (``DropoutSeed.b0``/``.h0``, as a
    rank of a mesh passes them), against the whole tensor's launch: the
    slice's output and dq, dk, dv equal the whole one's rows and heads bit
    for bit, fp32 and bf16, and the slice's K1 equals its plain version
    within ``K1_TOL``."""
    import torch
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    rows = []
    b, l, h, d, b0, h0 = 8, 64, 12, 64, 4, 6
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        q, k, v, bias = k1_inputs(b, l, h, d, True, dtype, seed=450)
        g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(451),
                        device="cuda").to(dtype)
        seed = device_seed(2 ** 35 + 3, site=7)
        part_seed = seed._replace(b0=b0, h0=h0)
        cut = lambda x: x[b0:, :, h0:]
        whole = [fa.fused_attention_small(q, k, v, bias, 0.125, 0.1, seed),
                 *fa.fused_attention_small_bwd(q, k, v, bias, g, 0.125, 0.1, seed,
                                               need_dbias=False)[:3]]
        args = (cut(q), cut(k), cut(v), bias[b0:])
        part = [fa.fused_attention_small(*args, 0.125, 0.1, part_seed),
                *fa.fused_attention_small_bwd(*args, cut(g), 0.125, 0.1, part_seed,
                                              need_dbias=False)[:3]]
        ref = fa.fused_attention_small_plain(*args, 0.125, 0.1, part_seed)
        err = (part[0].float() - ref.float()).abs().max().item()
        equal = all(torch.equal(x, cut(y)) for x, y in zip(part, whole))
        rows.append({"dtype": dtype_name, "B": b, "H": h, "L": l, "D": d, "b0": b0, "h0": h0,
                     "equal_to_whole": equal, "max_abs_err": err})
        log(f"[K1/K2 offsets] {dtype_name}: rows {b0}: and heads {h0}: of B{b} H{h} with "
            f"their offsets: out, dq, dk, dv equal the whole launch's {equal}; K1 against "
            f"its plain version err {err:.3g}")
        if not (equal and err <= K1_TOL[dtype_name]):
            failures.append(f"K1/K2 offsets {dtype_name}: {rows[-1]}")
    return rows


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
            body = fl.body_for(q, k, v)
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
                "bias": with_bias, "row_pad": pad, "body": body, "max_abs_err": err,
                "max_abs_ref": ref_max,
                **rounding,
                "sdpa_max_abs_diff": (out.float() - sdpa().transpose(1, 2).float()).abs().max().item(),
                "ms": cuda_time_ms(kernel, iters=20),
                "plain_ms": cuda_time_ms(lambda: fl.flash_attention_plain(q, k, v, bias, scale),
                                         iters=20),
                "library_ms": cuda_time_ms(sdpa, iters=20),
                "bound_ms": bound_ms, "bound_by": bound_by})
            r = rows[-1]
            if (site, dtype_name) in (("clip_l", "bfloat16"),    # the kernels line's site
                                      ("wide_d512", "bfloat16")):
                r.update(device_times(kernel, sdpa, iters=20))
            turns = ""
            if site.startswith("clip_l") and dtype_name == "bfloat16":
                # the body that runs against the mma.sync body, forced
                # through the wrapper for timing only, on the card alone in
                # turns (body, mma.sync, mma.sync, body)
                mma_sync = lambda: fl.flash_attention(q, k, v, bias, scale, body="mma_sync")
                t = [device_time_ms(fn, iters=20) for fn in (kernel, mma_sync, mma_sync, kernel)]
                r.update({"device_ms_turns": [t[0], t[3]], "mma_sync_device_ms_turns": t[1:3],
                          "device_ms": (t[0] + t[3]) / 2, "mma_sync_device_ms": (t[1] + t[2]) / 2})
                r.setdefault("library_device_ms", device_time_ms(sdpa, iters=20))
                turns = (f"; in turns on the card alone: {body} "
                         f"{' / '.join(f'{x * 1e3:.2f}' for x in r['device_ms_turns'])} us, "
                         f"mma_sync {' / '.join(f'{x * 1e3:.2f}' for x in t[1:3])} us")
                if body != "wgmma":
                    failures.append(f"K3 {site}: body {body}, not wgmma")
            share = (f"; differs from plain in {rounding['diff_share']:.3g} of outputs "
                     f"(p rounded once: {rounding['control_diff_share']:.3g}), mean abs err "
                     f"{rounding['mean_abs_err']:.3g}" if rounding else "")
            log(f"[K3] {site:11s} {dtype_name:8s} B{b} L{l} S{s} H{h} D{d} row pad {pad} "
                f"body {body}: "
                f"err {err:.3g} (max |ref| {ref_max:.3g}; vs sdpa {r['sdpa_max_abs_diff']:.3g})"
                f"{share}; kernel {r['ms'] * 1e3:.2f} us, "
                f"plain {r['plain_ms'] * 1e3:.2f} us, sdpa {r['library_ms'] * 1e3:.2f} us, "
                f"bound {bound_ms * 1e3:.2f} us ({bound_by})" + device_note(r) + turns)
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


# the AdamW kernel's odd-size table: one element, three, 1023 and 2^25 + 7
# (a tensor of many blocks with a ragged last one)
ADAMW_SIZES = (1, 3, 1023, (1 << 25) + 7)
# bytes the AdamW kernel moves a parameter: read p, g, mu, nu, write p, mu,
# nu (fp32 mu; bf16 mu: 4 bytes less)
ADAMW_BYTES = {"float32": 28, "bfloat16": 24}
# about 20 fp32 operations an element (the moments, the bias-corrected
# quotient, the decay and the step)
ADAMW_OPS = 20
# the AdamW kernel's flat-buffer list: every stream's tensors cut end to
# end from one buffer, so most start 4, 8 or 12 bytes off 16-byte alignment
# (the scalar body), numel % 4 in {1, 2, 3}
ADAMW_FLAT_SIZES = (1, 6, 7, 1025, 4098, 65539, (1 << 20) + 3)
# the hidden dropout: a BERT-base hidden state at training batch 64, and
# D2R-large's (RoBERTa-large at its training batch 16)
DROPOUT_SHAPE = (TRAIN_BATCH, 64, 768)
DROPOUT_LARGE_SHAPE = (16, 64, 1024)
# its adversarial inputs: views whose data pointer is this many bytes off
# 16-byte alignment (bf16 also 2), sizes with n % 16 in {1, 4, 7, 12}, and
# a slice layout whose seg is 4 mod 8 (each thread's two groups in two rows)
DROPOUT_OFFSETS = {"bfloat16": (2, 4, 8), "float32": (4, 8)}
DROPOUT_RAGGED = tuple(16 * 4099 + r for r in (1, 4, 7, 12))
DROPOUT_SEG4 = (12, 24, 12)


def phase_step_kernels(report):
    """The two kernels the captured train step added, against their plain
    twins on the card. The AdamW kernel (``ops/kernels/adamw.py``), three
    steps through a fractional warmup (1.5 of 4 steps) with the count and
    the schedule on the card, bit for bit against the 16-pass twin, fp32 and
    bf16 first moments: on two lr groups of :data:`ADAMW_SIZES`, on two of
    :data:`ADAMW_FLAT_SIZES` cut from flat buffers, then on D2R-base's own
    parameter list (its 4 groups, 400,186,367 elements, random values).
    Times on D2R-base's list (fp32 and bf16 moments): the kernel (with the
    count's increment), the twin, and ``torch.optim.AdamW(fused=True)`` on
    the same tensors (fp32; another operation order: the decay before the
    Adam update), against the bytes bound. The hidden-dropout kernel
    (``ops/kernels/dropout.py``) at :data:`DROPOUT_SHAPE` and
    :data:`DROPOUT_LARGE_SHAPE` in bf16 and fp32 and at an odd shape,
    forward and backward, bit for bit against its plain version, timed at
    both shapes in bf16 and the first in fp32 against the bound and
    ``F.dropout``'s (another mask); then on views off alignment
    (:data:`DROPOUT_OFFSETS`), at :data:`DROPOUT_RAGGED` sizes, under the
    layout :data:`DROPOUT_SEG4` and on the training site's slices. None of
    these launches counts."""
    import torch
    import torch.nn.functional as F
    from torch import nn
    from d2r_tpu_torch.models.unimo import D2RClassifier
    from d2r_tpu_torch.ops.kernels import adamw
    from d2r_tpu_torch.ops.kernels import dropout as tdrop
    from d2r_tpu_torch.train.optimizer import (
        BETAS,
        EPS,
        GROUPS,
        WEIGHT_DECAY,
        param_group_label,
    )
    from d2r_tpu_torch.weights import flax_path

    saved = read_counts()
    result = report["step_kernels"] = {"adamw": [], "dropout": []}
    hp, sch = adamw.hyper(BETAS, EPS, WEIGHT_DECAY), adamw.schedule(1.5, 4)

    def make(spec, mu_dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        rnd = lambda shape: torch.randn(shape, generator=g, device="cuda")
        return [([rnd(sh) for sh in shapes], [rnd(sh) for sh in shapes],
                 [(rnd(sh) * 0.1).to(mu_dtype) for sh in shapes],
                 [rnd(sh).square_() * 0.01 for sh in shapes], lr) for shapes, lr in spec]

    def make_flat(spec, mu_dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        sizes = [n for shapes, _ in spec for (n,) in shapes]
        rnd = lambda: torch.randn(sum(sizes), generator=g, device="cuda")
        flats = [rnd(), rnd(), (rnd() * 0.1).to(mu_dtype), rnd().square_() * 0.01]
        starts = [sum(sizes[:i]) for i in range(len(sizes))]
        views = [[f[a:a + n] for a, n in zip(starts, sizes)] for f in flats]
        groups, i = [], 0
        for shapes, lr in spec:
            groups.append((*(v[i:i + len(shapes)] for v in views), lr))
            i += len(shapes)
        return groups

    def copy(groups):
        return [tuple([t.clone() for t in x] if isinstance(x, list) else x for x in grp)
                for grp in groups]

    model = D2RClassifier(model_config("base"))      # the parameter shapes only
    by_group = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        by_group[param_group_label(flax_path(model, name))].append(tuple(p.shape))
    del model
    base_spec = [(shapes, 5e-2 if g == "fc" else 3e-5) for g, shapes in by_group.items() if shapes]
    odd_spec = [([(n,) for n in ADAMW_SIZES[::2]], 1e-3), ([(n,) for n in ADAMW_SIZES[1::2]], 5e-2)]
    flat_spec = [([(n,) for n in ADAMW_FLAT_SIZES[::2]], 1e-3),
                 ([(n,) for n in ADAMW_FLAT_SIZES[1::2]], 5e-2)]
    n_base = sum(math.prod(sh) for shapes, _ in base_spec for sh in shapes)
    adamw_row = None
    for table, spec in (("odd_sizes", odd_spec), ("flat_odd_offsets", flat_spec),
                        ("d2r_base", base_spec)):
        for mu_name in ("float32", "bfloat16"):
            mu_dtype = getattr(torch, mu_name)
            kernel_groups = (make_flat if table == "flat_odd_offsets" else make)(
                spec, mu_dtype, seed=1)
            twin_groups = copy(kernel_groups)
            ck, ct = torch.zeros((), device="cuda"), torch.zeros((), device="cuda")
            tab = None
            for _ in range(3):
                tab = adamw.adamw_update(kernel_groups, ck, hp, sch, tab)
                adamw.adamw_plain(twin_groups, ct, hp, sch)
            torch.cuda.synchronize()
            err, differing, elements = 0.0, 0, 0
            for a, b in zip(kernel_groups, twin_groups):
                for xs, ys in zip(a[:4], b[:4]):
                    for x, y in zip(xs, ys):
                        d = (x.float() - y.float()).abs()
                        err = max(err, d.max().item())
                        differing += int((x != y).sum())
                        elements += x.numel()
            row = {"table": table, "mu": mu_name, "tensors": sum(len(g[0]) for g in kernel_groups),
                   "parameters": sum(x.numel() for g in kernel_groups for x in g[0]),
                   "blocks": tab.blocks, "chunks": tab.n_chunks,
                   "scalar_elements": tab.scalar_elements, "steps": 3,
                   "count": [float(ck), float(ct)],
                   "max_abs_err": err, "elements_differing": differing,
                   "elements_compared": elements}
            if table == "d2r_base":
                row["kernel_ms"] = cuda_time_ms(
                    lambda: adamw.adamw_update(kernel_groups, ck, hp, sch, tab), iters=20, warmup=3)
                row["device_ms"] = device_time_ms(
                    lambda: adamw.adamw_update(kernel_groups, ck, hp, sch, tab), iters=20, warmup=3)
                row["plain_ms"] = cuda_time_ms(
                    lambda: adamw.adamw_plain(twin_groups, ct, hp, sch), iters=5, warmup=1)
                row["bound_ms"] = max(n_base * ADAMW_BYTES[mu_name] / HBM_BYTES_PER_S,
                                      n_base * ADAMW_OPS / PEAK_OPS["float32"]) * 1e3
                row["bound_by"] = ("bytes" if n_base * ADAMW_BYTES[mu_name] / HBM_BYTES_PER_S
                                   >= n_base * ADAMW_OPS / PEAK_OPS["float32"] else "operations")
                row["library_ms"] = row["library_device_ms"] = None
                if mu_name == "float32":
                    params = [nn.Parameter(p) for grp in twin_groups for p in grp[0]]
                    for p, g in zip(params, (g for grp in twin_groups for g in grp[1])):
                        p.grad = g
                    lib = torch.optim.AdamW(params, lr=3e-5, betas=BETAS, eps=EPS,
                                            weight_decay=WEIGHT_DECAY, fused=True)
                    row["library_ms"] = cuda_time_ms(lib.step, iters=20, warmup=3)
                    row["library_device_ms"] = device_time_ms(lib.step, iters=20, warmup=3)
                    del lib, params
                    adamw_row = row
            result["adamw"].append(row)
            log(f"[step kernels] AdamW {table} ({row['parameters']} elements, {row['blocks']} "
                f"blocks, {row['chunks']} chunks, {row['scalar_elements']} elements on the "
                f"scalar body), mu {mu_name}, 3 steps: kernel against twin max abs err {err}, "
                f"{differing} of {elements} elements differing; count {row['count']}"
                + (f"; kernel {row['kernel_ms'] * 1e3:.1f} us back to back, "
                   f"{row['device_ms'] * 1e3:.1f} us alone, twin {row['plain_ms'] * 1e3:.1f} "
                   f"us, bound {row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}), "
                   f"torch.optim.AdamW(fused=True) {row['library_ms']}" if "kernel_ms" in row
                   else ""))
            assert err == 0.0 and differing == 0, row
            assert row["count"] == [3.0, 3.0], row
            del kernel_groups, twin_groups, tab
            torch.cuda.empty_cache()

    dropout_row = None
    g = torch.Generator(device="cuda").manual_seed(3)

    def dropout_check(x, gy, seed, layout=None):
        """The kernel forward (on ``x``, a leaf) and backward (on ``gy``)
        against the plain version: (y, max abs err, equal)."""
        y = tdrop.hidden_dropout(x, 0.1, seed, layout)
        y.backward(gy)
        ref = tdrop.hidden_dropout_plain(x.detach(), 0.1, seed, layout)
        ref_g = tdrop.hidden_dropout_plain(gy, 0.1, seed, layout)
        torch.cuda.synchronize()
        err = max((y.detach().float() - ref.float()).abs().max().item(),
                  (x.grad.float() - ref_g.float()).abs().max().item())
        return y.detach(), err, bool(torch.equal(y.detach(), ref) and torch.equal(x.grad, ref_g))

    timed = {(DROPOUT_SHAPE, "bfloat16"), (DROPOUT_SHAPE, "float32"),
             (DROPOUT_LARGE_SHAPE, "bfloat16")}
    for shape in (DROPOUT_SHAPE, DROPOUT_LARGE_SHAPE, (3, 5, 7)):
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            x = torch.randn(shape, generator=g, device="cuda").to(dtype).requires_grad_()
            seed = device_seed(2 ** 63 + 99, site=7)
            gy = torch.randn(shape, generator=g, device="cuda").to(dtype)
            y, err, equal = dropout_check(x, gy, seed)
            row = {"shape": list(shape), "dtype": dtype_name, "max_abs_err": err,
                   "keep_share": (y != 0).float().mean().item(), "equal": equal}
            if (shape, dtype_name) in timed:
                xd = x.detach()
                n, size = xd.numel(), xd.element_size()
                row["kernel_ms"] = cuda_time_ms(lambda: tdrop.hidden_dropout(xd, 0.1, seed))
                row["device_ms"] = device_time_ms(lambda: tdrop.hidden_dropout(xd, 0.1, seed))
                row["plain_ms"] = cuda_time_ms(lambda: tdrop.hidden_dropout_plain(xd, 0.1, seed),
                                               iters=5, warmup=1)
                row["library_ms"] = cuda_time_ms(lambda: F.dropout(xd, 0.1, training=True))
                row["library_device_ms"] = device_time_ms(
                    lambda: F.dropout(xd, 0.1, training=True))
                # one Philox call (about 100 integer operations) a group of
                # four elements, counted at the CUDA cores' fp32 rate
                t_bytes, t_ops = 2 * n * size / HBM_BYTES_PER_S, 25 * n / PEAK_OPS["float32"]
                row["bound_ms"] = max(t_bytes, t_ops) * 1e3
                row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                if shape == DROPOUT_SHAPE and dtype_name == "bfloat16":
                    dropout_row = row
            result["dropout"].append(row)
            log(f"[step kernels] hidden dropout {shape} {dtype_name}: forward and backward "
                f"against the plain version max abs err {err}, equal {row['equal']}, keep "
                f"share {row['keep_share']:.4f}" + (
                    f"; kernel {row['kernel_ms'] * 1e3:.1f} us back to back, "
                    f"{row['device_ms'] * 1e3:.2f} us alone, plain {row['plain_ms'] * 1e3:.1f} "
                    f"us, F.dropout {row['library_ms'] * 1e3:.1f} us back to back, "
                    f"{row['library_device_ms'] * 1e3:.2f} us alone, bound "
                    f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})"
                    if "kernel_ms" in row else ""))
            assert row["equal"], row
    # the adversarial inputs: views off 16-byte alignment (x and the
    # gradient), ragged sizes (the scalar tail), and a layout with seg 4 mod
    # 8 whose outputs are also the whole tensor's
    for dtype_name, offsets in DROPOUT_OFFSETS.items():
        dtype = getattr(torch, dtype_name)
        size = torch.empty((), dtype=dtype).element_size()
        seed = device_seed(2 ** 33 + 17, site=5)
        cases = []
        for off in offsets:
            flat = torch.randn(2, 8 * 64 * 768 + 16, generator=g, device="cuda").to(dtype)
            x, gy = (f[off // size:off // size + 8 * 64 * 768].view(8, 64, 768) for f in flat)
            cases.append((f"{off} bytes off", x.detach().requires_grad_(), gy, None))
        for n in DROPOUT_RAGGED:
            x, gy = torch.randn(2, n, generator=g, device="cuda").to(dtype)
            cases.append((f"n % 16 = {n % 16}", x.clone().requires_grad_(), gy, None))
        seg, whole_w, offset = DROPOUT_SEG4
        whole_x = torch.randn(5001, whole_w, generator=g, device="cuda").to(dtype)
        part = whole_x[:, offset:offset + seg].contiguous()
        cases.append((f"layout {DROPOUT_SEG4}", part.clone().requires_grad_(),
                      torch.randn(part.shape, generator=g, device="cuda").to(dtype),
                      DROPOUT_SEG4))
        whole_y = tdrop.hidden_dropout(whole_x, 0.1, seed)
        for name, x, gy, layout in cases:
            y, err, equal = dropout_check(x, gy, seed, layout)
            row = {"case": name, "dtype": dtype_name, "shape": list(x.shape),
                   "x_address_mod_16": x.data_ptr() % 16, "max_abs_err": err, "equal": equal}
            if layout is not None:
                row["equal_to_whole"] = bool(torch.equal(y, whole_y[:, offset:offset + seg]))
            result["dropout"].append(row)
            log(f"[step kernels] hidden dropout {dtype_name}, {name} {tuple(x.shape)} (x at "
                f"{row['x_address_mod_16']} mod 16): equal to the plain version {equal}"
                + (f", to the whole tensor's elements {row['equal_to_whole']}"
                   if layout is not None else ""))
            assert equal and row.get("equal_to_whole", True), row
    # a rank's slice of the training site: a sequence half (seq_shard, tp =
    # 2), a data rank's batch half (dp = 2), and both: the kernel on each
    # draws its elements' bits of the whole tensor's mask, forward and
    # backward, as the plain version with the same layout
    from d2r_tpu_torch.models.layers import SeqShard, slice_layout
    b, length, width = DROPOUT_SHAPE
    x = torch.randn(DROPOUT_SHAPE, generator=g, device="cuda").to(torch.bfloat16)
    seed = device_seed(2 ** 40 + 5, site=11)
    whole = tdrop.hidden_dropout(x, 0.1, seed)
    for row0, i in ((0, 0), (0, 1), (b // 2, None), (b // 2, 1)):
        rows = slice(row0, b)
        cols = slice(None) if i is None else slice(i * length // 2, (i + 1) * length // 2)
        part = x[rows, cols].contiguous().requires_grad_()
        seq = None if i is None else SeqShard(None, i, 2, length)
        layout = slice_layout(part, row0, seq)
        y = tdrop.hidden_dropout(part, 0.1, seed, layout)
        y.backward(part.detach())
        ref = tdrop.hidden_dropout_plain(part.detach(), 0.1, seed, layout)
        row = {"rows_from": row0, "seq_slice": i, "of": 2, "shape": list(part.shape),
               "dtype": "bfloat16",
               "equal_to_whole_rows": bool(torch.equal(y.detach(), whole[rows, cols])),
               "equal": bool(torch.equal(y.detach(), ref) and torch.equal(part.grad, ref)),
               "max_abs_err": (y.detach().float() - ref.float()).abs().max().item()}
        result["dropout"].append(row)
        log(f"[step kernels] hidden dropout on rows {row0}: and sequence slice {i} of 2 "
            f"{tuple(part.shape)}: equal to the plain version {row['equal']}, to the whole "
            f"tensor's elements {row['equal_to_whole_rows']}")
        assert row["equal"] and row["equal_to_whole_rows"], row
    result["kernels_line"] = {"adamw": adamw_row, "dropout": dropout_row}
    result["extras"] = extras_card_vs_cpu()
    for name, fn in counters().items():   # the comparisons do not count
        fn.launches = saved[name]
    return result


# the off-path extras (models/extras.py, ops/losses_extra.py) card against
# CPU in fp32 (TF32 off): outputs within this share of max(1, max |ref|)
EXTRAS_TOL = 1e-4


def extras_card_vs_cpu():
    """One forward of each module of ``models/extras.py`` at D2R-base's
    widths (768 features, 12 heads), train mode (BatchNorm on batch
    statistics), and each loss of ``ops/losses_extra.py``, on the card and
    on the CPU from the same weights and inputs, fp32: the error over
    max(1, max |ref|) of each (:data:`EXTRAS_TOL`). No kernel of the port
    runs in them."""
    import copy
    import torch
    from d2r_tpu_torch.models import extras as tx
    from d2r_tpu_torch.models.layers import init_weights
    from d2r_tpu_torch.ops import losses_extra as tle
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(21)
    x = lambda *shape: torch.randn(*shape, generator=g)
    unit = lambda t: t / t.norm(dim=-1, keepdim=True)
    noise = [x(16, 2), x(16, 2)]
    cases = {
        "SELayer": (tx.SELayer(2), (x(16, 2, 768),), {}),
        "GraphReasoning": (tx.GraphReasoning(256), (x(16, 10, 256),), {}),
        "GatedQueryAttLayer": (tx.GatedQueryAttLayer(768, 12), (x(16, 64, 768),), {}),
        "AGSA": (tx.AGSA(2, 768, 12), (x(16, 64, 768),), {}),
        "SelfEncoder": (tx.SelfEncoder(768, 768, 12), (x(16, 64, 768),), {}),
        "VariationalEncoder": (tx.VariationalEncoder(768), (x(16, 768),), {}),
        "AmbiguityLearning": (tx.AmbiguityLearning(768, 768), (x(16, 768), x(16, 768),
                                                              x(16, 3)), {"noise": noise}),
    }
    feats, labels = unit(x(16, 2, 128)), torch.randint(0, 3, (16,), generator=g)
    binary = (labels > 0).float()   # labeled_js_div's labels are 0/1
    losses = {
        "soft_contrastive_loss": (tle.soft_contrastive_loss,
                                  (unit(x(16, 128)), unit(x(16, 128))),
                                  dict(alpha=0.5, margin=0.2, max_violation=True)),
        "diff_loss": (tle.diff_loss, (x(16, 64), x(16, 64)), {}),
        "labeled_js_div": (tle.labeled_js_div, (x(16, 3), x(16, 3), binary), {}),
        "supcon_loss": (tle.supcon_loss, (feats,), dict(labels=labels)),
    }
    out = {}
    with torch.no_grad():
        for name, (module, args, kw) in cases.items():
            init_weights(module, torch.Generator().manual_seed(3))
            on_card = copy.deepcopy(module).cuda().train()
            ref = module.train()(*args, **kw)
            got = on_card(*[a.cuda() for a in args],
                          **{k: [t.cuda() for t in v] for k, v in kw.items()})
            ref, got = (t if isinstance(t, tuple) else (t,) for t in (ref, got))
            out[name] = max((b.cpu() - a).abs().max().item() / max(1.0, a.abs().max().item())
                            for a, b in zip(ref, got))
        for name, (fn, args, kw) in losses.items():
            ref = fn(*args, **kw)
            got = fn(*[a.cuda() for a in args],
                     **{k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in kw.items()})
            out[name] = (got.cpu() - ref).abs().item() / max(1.0, ref.abs().item())
    log(f"[extras] card against CPU, fp32, error / max(1, max |ref|): "
        f"{ {k: float(f'{v:.3g}') for k, v in out.items()} }")
    assert all(v <= EXTRAS_TOL for v in out.values()), out      # NaN fails too
    return out


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
    """The launch counters of the kernels a forward or a train step
    launches: the attention kernels K1-K3, the hidden-dropout kernel, the
    AdamW kernel, int8 serving's W8A16 product and int8 training's quantize
    and rescale passes."""
    from d2r_tpu_torch.ops.kernels import adamw
    from d2r_tpu_torch.ops.kernels import dropout
    from d2r_tpu_torch.ops.kernels import flash_attention as fl
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    from d2r_tpu_torch.ops.kernels import quantize as qk
    from d2r_tpu_torch.ops.kernels import w8a16
    return {"k1": fa.fused_attention_small, "k2": fa.fused_attention_small_bwd,
            "k3": fl.flash_attention, "dropout": dropout.hidden_dropout,
            "adamw": adamw.adamw_update, "w8a16": w8a16.w8a16_linear,
            "quantize_rows": qk.quantize_rows, "quantize_cols": qk.quantize_cols,
            "rescale": qk.rescale}


def zero_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def no_counts():
    return {name: 0 for name in counters()}


ATTENTION = ("k1", "k2", "k3")


def attention(counts):
    """The attention kernels' part of a launch-count dict."""
    return {k: counts[k] for k in ATTENTION}


def host_calls(steps):
    """Host calls a wrapper makes in ``steps`` train steps of one kind on
    one batch signature, in one process on the card: one a warm-up step
    (``train.state.WARMUP_STEPS`` eager steps), one for the capture, none
    for a replay."""
    from d2r_tpu_torch.train.state import WARMUP_STEPS
    return min(steps, WARMUP_STEPS) + (1 if steps > WARMUP_STEPS else 0)


def eval_calls(batches):
    """Host calls a wrapper makes in ``batches`` eval forwards of one batch
    signature, in one process on the card: one a warm-up forward
    (``train.state.EVAL_WARMUP``), one for the capture, none for a
    replay."""
    from d2r_tpu_torch.train.state import EVAL_WARMUP
    return min(batches, EVAL_WARMUP) + (1 if batches > EVAL_WARMUP else 0)


def check_step_counts(counts, steps, k1=34, k3=0, k1_recompute=0, k3_recompute=0,
                      eval_batches=0, eval_k1=None, eval_k3=None):
    """The launch counts of ``steps`` captured train steps (plus
    ``eval_batches`` captured eval forwards of one batch signature): K1 and
    K3 a forward site (and a remat recompute), K2 a K1 site, one AdamW a
    step, the hidden dropout launched whenever a step ran."""
    calls = host_calls(steps)
    eval_k1 = k1 if eval_k1 is None else eval_k1
    eval_k3 = k3 if eval_k3 is None else eval_k3
    evals = eval_calls(eval_batches)
    want = {"k1": (k1 + k1_recompute) * calls + eval_k1 * evals, "k2": k1 * calls,
            "k3": (k3 + k3_recompute) * calls + eval_k3 * evals}
    assert attention(counts) == want, (counts, want)
    assert counts["adamw"] == calls, (counts, calls)
    assert counts["dropout"] > 0 or steps == 0, counts


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

    # traced forwards at the first and last bucket; D2R-large's replay at
    # every bucket too (K3's ms a forward at each)
    traced = [(b, m) for b in BUCKETS for m in ("eager", "replay")
              if b in (1, BUCKETS[-1]) or (m == "replay" and spec["k3"])]
    for b, mode in traced:
        g = pred.graph(b)
        fn = {"eager": lambda: pred._forward(*g.inputs), "replay": g.graph.replay}[mode]
        for attempt in range(TRACE_ATTEMPTS):
            result[f"profile_{mode}_b{b}"] = prof = device_profile(fn, 3, "forward")
            log(f"[profile{spec['tag']}] {mode} bucket {b:2d}: " + json.dumps(brief(prof)))
            wrong = [n for n in ("k1", "k3") if prof.get(f"{n}_kernels_per_forward") != spec[n]]
            # lost events: a fractional count of three forwards, or a
            # replay that counts fewer kernels than the eager forward
            # traced just before it (the same kernels)
            kernels = prof.get("kernels_per_forward", 0)
            eager = result.get(f"profile_eager_b{b}", {}).get("kernels_per_forward", 0)
            lost = not float(kernels).is_integer() or (mode == "replay" and kernels < eager)
            if not (wrong and lost):
                break
            log(f"[profile{spec['tag']}] {mode} bucket {b:2d}: the trace lost kernel "
                f"events (three runs of one forward, {prof['kernels_per_forward']} "
                f"kernels each on average); profiling again")
        result[f"profile_{mode}_b{b}"]["trace_attempts"] = attempt + 1
        for name in ("k1", "k3"):
            got = prof.get(f"{name}_kernels_per_forward")
            assert got == spec[name], (
                f"{mode} bucket {b}: {got} {name.upper()} kernels a forward in the "
                f"trace, expected {spec[name]}")
    if spec["k3"]:
        result["k3_replay_ms_per_forward"] = {
            b: result[f"profile_replay_b{b}"]["k3_ms_per_forward"] for b in BUCKETS}
        log(f"{tag} K3 in the traced replays, ms a forward (kernels a forward): " + ", ".join(
            f"bucket {b} {result[f'profile_replay_b{b}']['k3_ms_per_forward']:.3f} "
            f"({result[f'profile_replay_b{b}']['k3_kernels_per_forward']:g})" for b in BUCKETS))
    bad = [b for b in BUCKETS if not equal[b]["bit_equal"]]
    assert not bad, f"replay differs from eager at buckets {bad}: {equal}"
    if key == "base":
        result["int8"], counts = int8_serving(pred, requests)
        launches = {n: launches[n] + counts[n] for n in launches}
    return launches


class plain_int8:
    """Within it, every quantized module's product is the W8A16 plain
    version (the dequantized weight, then ``F.linear``) on the card too: the
    reference the kernel is held to, never the port's path."""

    def __enter__(self):
        from d2r_tpu_torch import quant
        from d2r_tpu_torch.ops.kernels import w8a16
        self.kernel = quant.Int8Weight._dense

        def plain(module, x, bias):
            q = module.weight_q.view(module.weight_q.shape[0], -1)
            scale = module.weight_scale.reshape(-1)
            x2d = x.reshape(-1, x.shape[-1])
            y = w8a16.w8a16_linear_plain(x2d, q, scale, scale.numel(), bias)
            return y.view(*x.shape[:-1], q.shape[0])

        quant.Int8Weight._dense = plain

    def __exit__(self, *exc):
        from d2r_tpu_torch import quant
        quant.Int8Weight._dense = self.kernel


def elementwise_kernels(prof):
    """Elementwise kernels a forward in a profile (casts, copies, products)."""
    return sum(c for name, c in prof.get("kernel_calls_per_forward", {}).items()
               if "elementwise" in name)


def int8_serving(bf16_pred, requests):
    """Weight-only int8 serving beside the bf16 ``Predictor`` of phase 4: the
    same seeded model quantized (``Predictor(quantize="int8")``), warmed up
    at every bucket (2 W8A16 host calls a quantized module a bucket: the
    eager forward and the capture); at each bucket its replay against its
    eager forward on the same buffers (bit for bit) and against the eager
    forward through the W8A16 plain version (within
    :data:`QUANT_LOGITS_TOL`, labels equal wherever the plain top
    probability leads by more than twice that), its replay ms beside the
    bf16 one's (in turns: bf16, int8, int8, bf16), and the bf16 model's
    labels for the record; a trace of the int8 and bf16 replays at every
    bucket (``profile_replay_b{b}``: kernels, W8A16 kernels and ms, the
    library GEMMs' in bf16, busy and idle share, the idle time just before
    those kernels): one W8A16 kernel a quantized module and no more
    elementwise kernels than the bf16 replay's (each plain-path product
    adds two over its weight). Returns (the result, the launch counts of
    the warmup)."""
    import numpy as np
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.quant import Int8Weight
    from d2r_tpu_torch.serve import Predictor
    cfg = bf16_pred.cfg
    t0 = time.perf_counter()
    pred = Predictor(cfg, build_model(cfg, device="cuda", seed=0), batch_buckets=BUCKETS,
                     device="cuda", quantize="int8")
    modules = sum(isinstance(m, Int8Weight) for m in pred.model.modules())
    zero_counts()
    pred.warmup()
    counts = read_counts()
    log(f"[main int8] {modules} quantized modules; built and warmed up in "
        f"{time.perf_counter() - t0:.1f} s; W8A16 host calls {counts['w8a16']}")
    assert counts["w8a16"] == 2 * modules * len(BUCKETS), (counts, modules)
    assert counts["k1"] == 2 * MODELS["base"]["k1"] * len(BUCKETS), counts
    result = {"modules": modules, "warmup_launches": counts, "buckets": {}}
    ids, mask, tt, pixels = requests[-1]
    for b in BUCKETS:
        rows = (ids[:b], mask[:b], tt[:b], pixels[:b])
        g, g16 = pred.graph(b), bf16_pred.graph(b)
        pred._stage(g, rows)
        replayed = pred._replay(g, b)
        eager = pred._forward(*g.inputs).cpu().numpy()
        with plain_int8():
            plain = pred._forward(*g.inputs).cpu().numpy()
        bf16_pred._stage(g16, rows)
        dense = bf16_pred._replay(g16, b)
        top2 = np.sort(plain, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * QUANT_LOGITS_TOL
        same = plain.argmax(-1) == replayed.argmax(-1)
        ms = {"bf16": [replay_ms(g16.graph)], "int8": [replay_ms(g.graph)]}
        ms["int8"].append(replay_ms(g.graph))
        ms["bf16"].append(replay_ms(g16.graph))
        r = result["buckets"][b] = {
            "replay_bit_equal_eager": bool(np.array_equal(replayed, eager)),
            "max_abs_diff_plain": float(np.abs(replayed - plain).max()),
            "labels_equal_plain": bool(same[clear].all()), "labels_excused": int((~clear).sum()),
            "labels_as_bf16_share": float((dense.argmax(-1) == replayed.argmax(-1)).mean()),
            "max_abs_diff_bf16": float(np.abs(dense - replayed).max()),
            "replay_ms": ms, "int8_ms": float(np.median(ms["int8"])),
            "bf16_ms": float(np.median(ms["bf16"]))}
        r["ratio"] = r["int8_ms"] / r["bf16_ms"]
        log(f"[main int8] bucket {b:2d}: replay {'==' if r['replay_bit_equal_eager'] else '!='} "
            f"eager; against the plain W8A16 forward max abs diff {r['max_abs_diff_plain']:.3g}, "
            f"labels {'equal' if r['labels_equal_plain'] else 'DIFFER'} ({r['labels_excused']} "
            f"within 2 x tol excused); as bf16's labels {r['labels_as_bf16_share']:.3f} (max "
            f"abs diff {r['max_abs_diff_bf16']:.3g}); replay int8 {ms['int8']} ms, bf16 "
            f"{ms['bf16']} ms (in turns): {r['ratio']:.3f}x")
        assert r["replay_bit_equal_eager"], (b, r)
        assert r["max_abs_diff_plain"] <= QUANT_LOGITS_TOL and r["labels_equal_plain"], (b, r)
    # the replays traced at every bucket, int8 beside bf16: the W8A16 kernels
    # (one a quantized module), their ms, the idle share, and the idle time
    # just before W8A16 kernels (int8) or the library's GEMMs (bf16)
    keys = {"w8a16": ("w8a16_",), "library_gemm": ("gemm", "nvjet", "cutlass")}
    for b in BUCKETS:
        prof = device_profile(pred.graph(b).graph.replay, 3, "forward", keys)
        prof16 = device_profile(bf16_pred.graph(b).graph.replay, 3, "forward", keys)
        p = result[f"profile_replay_b{b}"] = {
            **brief(prof), "elementwise_kernels_per_forward": elementwise_kernels(prof),
            "w8a16_kernels_per_forward": prof.get("w8a16_kernels_per_forward"),
            "bf16": {**brief(prof16),
                     "elementwise_kernels_per_forward": elementwise_kernels(prof16)}}
        q = p["bf16"]
        # the kernels (by name) whose time a forward differs most between
        # the two replays, beyond the W8A16 kernels and the GEMMs they replace
        mine, theirs = prof.get("kernel_ms_per_forward", {}), prof16.get("kernel_ms_per_forward", {})
        diff = {k: mine.get(k, 0.0) - theirs.get(k, 0.0) for k in {*mine, *theirs}
                if not any(sub in k for sub in keys["w8a16"] + keys["library_gemm"])}
        p["other_kernels_ms_minus_bf16"] = dict(sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:6])
        log(f"[main int8] bucket {b:2d} other kernels, int8 minus bf16 ms a forward: "
            + json.dumps({k[:80]: round(v, 4) for k, v in p["other_kernels_ms_minus_bf16"].items()}))
        log(f"[main int8] bucket {b:2d} replays traced: int8 {p.get('kernels_per_forward')} "
            f"kernels ({p['w8a16_kernels_per_forward']} W8A16, "
            f"{p.get('w8a16_ms_per_forward', 0):.3f} ms; {p['elementwise_kernels_per_forward']} "
            f"elementwise), busy {p.get('device_busy_ms_per_forward', 0):.3f} of "
            f"{p.get('window_ms_per_forward', 0):.3f} ms, idle share "
            f"{p.get('device_idle_share', 0):.3f}, idle before W8A16 "
            f"{p.get('idle_before_w8a16_ms_per_forward', 0):.3f} ms; bf16 "
            f"{q.get('kernels_per_forward')} kernels ({q.get('library_gemm_kernels_per_forward')} "
            f"library GEMMs, {q.get('library_gemm_ms_per_forward', 0):.3f} ms; "
            f"{q['elementwise_kernels_per_forward']} elementwise), busy "
            f"{q.get('device_busy_ms_per_forward', 0):.3f} of "
            f"{q.get('window_ms_per_forward', 0):.3f} ms, idle share "
            f"{q.get('device_idle_share', 0):.3f}, idle before the GEMMs "
            f"{q.get('idle_before_library_gemm_ms_per_forward', 0):.3f} ms")
        if "kernels_per_forward" in p:
            assert p["w8a16_kernels_per_forward"] == modules, (b, p)
            assert (p["elementwise_kernels_per_forward"]
                    <= q["elementwise_kernels_per_forward"] + 2), (b, p)
    del pred
    return result, counts


def busy_time(spans):
    """The length of the union of sorted (start, end) spans."""
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s


def device_profile(fn, n, unit, gap_keys=None):
    """Device busy share and kernel time by name over ``n`` back-to-back
    calls of ``fn``, from torch.profiler's CUDA kernel events. ``gap_keys``
    (label: name substrings) adds, for each label, the device's idle time
    just before the kernels whose name holds one of its substrings (the gap
    from the last end of any earlier kernel to the kernel's start), and
    their count and ms, a ``unit``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans, by_name, calls, named = [], {}, {}, []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
                and not getattr(e, "is_user_annotation", False)):   # e.g. Optimizer.step
            spans.append((e.time_range.start, e.time_range.end))
            named.append((e.time_range.start, e.time_range.end, e.name))
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
    ms = lambda key: sum(v for k, v in by_name.items() if key in k) / n / 1e3
    gaps = {}
    if gap_keys:
        named.sort()
        frontier = named[0][0]
        before = {label: 0.0 for label in gap_keys}
        matched = {label: 0 for label in gap_keys}
        kernel_us = {label: 0.0 for label in gap_keys}
        for start, end, name in named:
            for label, subs in gap_keys.items():
                if any(sub in name for sub in subs):
                    before[label] += max(0.0, start - frontier)
                    matched[label] += 1
                    kernel_us[label] += end - start
            frontier = max(frontier, end)
        for label in gap_keys:
            gaps[f"{label}_kernels_per_{unit}"] = matched[label] / n
            gaps[f"{label}_ms_per_{unit}"] = kernel_us[label] / n / 1e3
            gaps[f"idle_before_{label}_ms_per_{unit}"] = before[label] / n / 1e3
    return {**gaps,f"{unit}s": n, f"kernels_per_{unit}": len(spans) / n,
            f"window_ms_per_{unit}": window / n / 1e3,
            f"device_busy_ms_per_{unit}": busy / n / 1e3,
            "device_idle_share": 1.0 - busy / window,
            f"k1_ms_per_{unit}": k1 / n / 1e3, f"k2_ms_per_{unit}": k2 / n / 1e3,
            f"k3_ms_per_{unit}": k3 / n / 1e3,
            f"k1_kernels_per_{unit}": count("fused_attention_fwd"),
            f"k2_kernels_per_{unit}": count("fused_attention_bwd"),
            f"k3_kernels_per_{unit}": count("flash_attention_fwd"),
            f"adamw_kernels_per_{unit}": count("adamw_kernel"),
            f"adamw_ms_per_{unit}": ms("adamw_kernel"),
            f"dropout_kernels_per_{unit}": count("hidden_dropout_kernel"),
            f"dropout_ms_per_{unit}": ms("hidden_dropout_kernel"),
            # full names: two kernels may share a long prefix
            f"top_kernels_ms_per_{unit}": {k: v / n / 1e3 for k, v in top},
            f"kernel_calls_per_{unit}": {k: c / n for k, c in calls.items()},
            f"kernel_ms_per_{unit}": {k: v / n / 1e3 for k, v in by_name.items()}}


def brief(prof):
    """A profile without its per-kernel tables, for the log."""
    return {k: v for k, v in prof.items() if not k.startswith(("kernel_calls_per_",
                                                                "kernel_ms_per_"))}


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
    4-group AdamW), the captured step: warm-up steps, the capture, timed
    replays, the launch counts, what moved, profiled replays (kernels a
    step by name: K1, K2, K3, the AdamW kernel, no ``_foreach`` pass but
    the gradients' zeroing), replays whose host code runs under
    ``set_sync_debug_mode("error")``; then eager steps of the same state
    (timed and profiled) and :func:`replay_checks` from the same initial
    weights."""
    import numpy as np
    import torch
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    from d2r_tpu_torch.train import state as st

    spec = MODELS[key]
    tag, batch_size = f"[train{spec['tag']}]", spec["train_batch"]
    cfg = model_config(key, batch_size=batch_size, compute_dtype="bfloat16")
    pad = cfg.text_config().pad_token_id
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state = st.create_train_state(cfg, total_steps=1000, device="cuda", seed=0)
    model = state.model
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    batch = {k: torch.from_numpy(v).cuda() for k, v in model_batch(cfg, batch_size, 0).items()}
    initial = {n: p.detach().clone() for n, p in model.named_parameters()}
    initial.update({n: b.detach().clone() for n, b in model.named_buffers() if "running" in n})
    log(f"{tag} {spec['label']}, batch {batch_size}, bf16 compute, fp32 parameters: state "
        f"built in {time.perf_counter() - t0:.1f} s; "
        f"{int((batch['input_ids'] == pad).sum())} PAD ids (id {pad}) in the batch")
    step = st.make_train_step()

    zero_counts()
    t0 = time.perf_counter()
    state, timed = timed_steps(state, batch)
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps, losses, med = timed["steps"], timed["losses"], timed["step_ms_median"]
    out = {"config": spec["label"], "batch": batch_size, "steps": steps,
           "k1_launches": launches["k1"], "k2_launches": launches["k2"],
           "k3_launches": launches["k3"], "launches": launches, **timed, "wall_s": wall,
           "g_copies": fa.fused_attention_small_bwd.g_copies,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    report["train" + spec["suffix"]] = out
    log(f"{tag} {steps} steps ({st.WARMUP_STEPS} eager, the capture, then replays): host "
        f"calls {launches}; losses {[round(x, 4) for x in losses]}")
    log(f"{tag} replayed step {med:.2f} ms (CUDA events, median of {TIMED_STEPS}), "
        f"{out['samples_per_s']:.1f} samples/s, peak memory {out['peak_mem_gb']:.2f} GB")
    check_step_counts(launches, steps, k1=spec["k1"], k3=spec["k3"])
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
    del initial

    # the replays as the card sees them (traced again while a count is off
    # in a trace that lost kernel events, as phase 4 does), and their host
    # code with no sync
    # the hidden-dropout kernel at every site a step, forward and backward,
    # as the eager steps launched it
    assert launches["dropout"] % host_calls(steps) == 0, launches
    want = {"k1": spec["k1"], "k2": spec["k1"], "k3": spec["k3"], "adamw": 1,
            "dropout": launches["dropout"] // host_calls(steps)}
    for attempt in range(TRACE_ATTEMPTS):
        out["profile"] = prof = device_profile(lambda: step(state, batch, 1), 3, "step")
        names = prof.get("kernel_calls_per_step", {})
        log(f"[profile{spec['tag']}] replayed train step: " + json.dumps(brief(prof)))
        wrong = [n for n in want if prof.get(f"{n}_kernels_per_step") != want[n]]
        # three replays of one graph launch the same kernels: a count that
        # is not a whole number a step, or one kernel seen in some replays
        # and not others, is a trace that lost events, not the step's
        lost = not float(prof.get("kernels_per_step", 0)).is_integer() or any(
            not float(prof.get(f"{n}_kernels_per_step", 0)).is_integer() for n in wrong)
        if not (wrong and lost):
            break
        log(f"[profile{spec['tag']}] the trace lost kernel events ({prof['kernels_per_step']} "
            f"kernels a step on average over three replays of one graph; {wrong} off); "
            f"profiling again")
    prof["trace_attempts"] = attempt + 1
    out["optimizer_kernels"] = {k: v for k, v in names.items() if "adamw" in k}
    out["foreach_kernels"] = {k: v for k, v in names.items() if "multi_tensor_apply" in k}
    # the earlier optimizer's sixteen passes: scalar, list, tensor-scalar
    # and unary (sqrt) functors; the step's own zeroing is ZeroFunctor's
    foreach = {k: v for k, v in out["foreach_kernels"].items()
               if any(f in k for f in ("BinaryOp", "UnaryOp", "PointwiseOp"))}
    log(f"{tag} optimizer kernels a replayed step: {out['optimizer_kernels']}; _foreach "
        f"kernels: {out['foreach_kernels']}")
    for name in want:
        assert prof.get(f"{name}_kernels_per_step") == want[name], (name, brief(prof))
    assert not foreach, foreach
    sync_free = 3
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(sync_free):
            step(state, batch, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out["replays_under_sync_debug_error"] = sync_free

    # eager steps of the same state: the step the capture replaced
    eager_ms = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        st._eager_step(state, batch, 1, False)
        end.record()
        state.step += 1
        torch.cuda.synchronize()
        eager_ms.append(start.elapsed_time(end))

    def eager():
        st._eager_step(state, batch, 1, False)
        state.step += 1

    out["eager_step_ms"] = eager_ms
    out["eager_step_ms_median"] = float(np.median(eager_ms))
    out["eager_profile"] = eprof = device_profile(eager, 1, "step")
    log(f"{tag} eager step {out['eager_step_ms_median']:.2f} ms (CUDA events, median of 3), "
        f"device busy {eprof.get('device_busy_ms_per_step', float('nan')):.2f} ms, idle share "
        f"{eprof.get('device_idle_share', float('nan')):.3f}; replayed step {med:.2f} ms, "
        f"device busy {prof.get('device_busy_ms_per_step', float('nan')):.2f} ms, idle share "
        f"{prof.get('device_idle_share', float('nan')):.3f}")
    del state, model, step
    torch.cuda.empty_cache()
    out["replay_checks"] = replay_checks(f"{tag} replay", cfg, weights, batch)
    return launches


def replay_checks(tag, cfg, weights, batch, seed=1, dropouts=("off", "on")):
    """The captured step against the eager one from the same ``weights``
    (a state dict) on ``batch``, with dropout off (a registered dropout-0
    text preset) and on: ``WARMUP_STEPS`` eager steps, the capture's step
    and two more replays in one state, the same number of eager steps in
    another. The losses must agree within 1e-4 of max(1, |loss|) and the
    updated parameters within 1e-3 of each leaf's max |value| (phase 7's
    train-step tolerances; replays and eager steps run the same kernels,
    save for the order of atomic sums); the largest difference and the count
    of differing elements are reported. With dropout on, after each
    replayed step K1 is launched at two of the step's dropout sites (one
    early, one late; D >= S) on q = k = 0 and v = I, from the state's seed
    buffer: its keep mask must equal the plain mask of the key the eager
    derivation gives (``fold_in(seed, step)``, ``site_key``) and differ from
    the previous step's. Those probe launches do not count."""
    import dataclasses
    import torch
    from d2r_tpu_torch import config as tconfig
    from d2r_tpu_torch.models.layers import fold_in
    from d2r_tpu_torch.ops import attention as tattn
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    from d2r_tpu_torch.train import state as st

    steps = st.WARMUP_STEPS + 3
    tc = cfg.text_config()
    nodrop = f"{cfg.bert_name}-dropout-0"
    tconfig.register_text_preset(nodrop, lambda tc=tc: dataclasses.replace(
        tc, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    result = {}
    for dropout, bert_name in (("off", nodrop), ("on", cfg.bert_name)):
        if dropout not in dropouts:
            continue
        c = dataclasses.replace(cfg, bert_name=bert_name)
        state = fresh_state(c, weights)
        step = st.make_train_step()
        sites, masks, losses = [], [], []
        kernel = tattn.fused_attention_small

        def recording(q, k, v, bias, scale, rate=0.0, seed=None):
            if rate > 0 and q.shape[-1] >= k.shape[1]:
                sites.append((seed.site, tuple(q.shape), k.shape[1], rate))
            return kernel(q, k, v, bias, scale, rate, seed)

        for i in range(steps):
            if i == 0:
                tattn.fused_attention_small = recording
            try:
                state, m = step(state, batch, seed)
            finally:
                tattn.fused_attention_small = kernel
            losses.append(m["loss"])
            if dropout == "on" and i >= st.WARMUP_STEPS:
                # the first and the last site of the forward (a remat
                # recompute calls a site again)
                by_site = {x[0]: x for x in sites}
                probe = [by_site[min(by_site)], by_site[max(by_site)]]
                masks.append(probe_masks(state, probe, fold_in(seed, i)))
        captured = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        del state, step
        torch.cuda.empty_cache()
        ref = fresh_state(c, weights)
        ref_losses = []
        for _ in range(steps):
            ref_losses.append(st._eager_step(ref, batch, seed, False)["loss"])
            ref.step += 1
        torch.cuda.synchronize()
        loss_diff = max(abs(float(a) - float(b)) for a, b in zip(losses, ref_losses))
        rel, differing, total = 0.0, 0, 0
        for n, p in ref.model.named_parameters():
            d = (captured[n] - p).abs()
            rel = max(rel, (d.max() / p.abs().max().clamp_min(1e-30)).item())
            differing += int((d > 0).sum())
            total += p.numel()
        del ref, captured
        torch.cuda.empty_cache()
        r = result[f"dropout_{dropout}"] = {
            "losses_replayed": [float(x) for x in losses],
            "losses_eager": [float(x) for x in ref_losses], "loss_max_abs_diff": loss_diff,
            "param_max_rel_diff": rel, "param_elements_differing": differing,
            "param_elements": total}
        log(f"{tag} dropout {dropout}: {steps} steps ({st.WARMUP_STEPS} eager, then 3 "
            f"replayed) against {steps} eager: losses max abs diff {loss_diff:.3g}; updated "
            f"parameters max diff {rel:.3g} of the leaf's max |value|, {differing} of "
            f"{total} elements differing")
        assert loss_diff <= 1e-4 * max(1.0, max(abs(float(x)) for x in ref_losses)), r
        assert rel <= 1e-3, r
        if dropout == "on":
            r["probe_sites"] = [[x[0], list(x[1]), x[2], x[3]] for x in probe]
            r["masks"] = masks
            log(f"{tag} K1 masks at sites {[x[0] for x in probe]} after each replayed step: "
                + json.dumps(masks))
            assert all(m["equal_to_eager"] for step_masks in masks for m in step_masks), masks
            for a, b in zip(masks, masks[1:]):
                assert all(x["keep_hash"] != y["keep_hash"] for x, y in zip(a, b)), masks
    return result


def probe_masks(state, sites, step_seed):
    """K1's keep mask at each of ``sites`` ((site, q shape, S, rate)) from
    the state's seed buffer, read back through q = k = 0 (p = 1/S) and
    v = I: whether it equals the plain mask of ``site_key(step_seed,
    site)``, its keep share and a hash of it. The launches do not count."""
    import torch
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    out = []
    before = fa.fused_attention_small.launches
    for site, (b, l, h, d), s, rate in sites:
        dt = state.model.cfg.dtype
        q = torch.zeros((b, l, h, d), dtype=dt, device="cuda")
        k = torch.zeros((b, s, h, d), dtype=dt, device="cuda")
        v = torch.eye(s, d, dtype=dt, device="cuda")[None, :, None, :].expand(b, s, h, d)
        got = fa.fused_attention_small(q, k, v.contiguous(), None, 1.0, rate,
                                       fa.DropoutSeed(state.seed, site))
        keep = (got[..., :s].float() > 0).permute(0, 2, 1, 3)
        want = fa.dropout_keep_mask(fa.site_key(step_seed, site), b, h, l, s, rate, "cuda")
        out.append({"site": site, "equal_to_eager": bool(torch.equal(keep, want)),
                    "keep_share": keep.float().mean().item(),
                    "keep_hash": int((keep.flatten().long() * torch.arange(
                        keep.numel(), device="cuda")).sum().item())})
    fa.fused_attention_small.launches = before
    return out


def condition_fabric(model):
    """Move off the two spots where the model turns fp32 rounding into
    gradient noise (see :func:`phase_train_card_vs_cpu`), in place: BLOCK
    fusion's merge biases to [1, ~1.1], the cross-modal alignments' query
    and key weights shrunk 10x."""
    import torch
    from d2r_tpu_torch.models.xmodules import CrossModalAlignment
    with torch.no_grad():
        fusion = model.model.block_fusion
        for bias in (fusion.merge_bias0, fusion.merge_bias1):
            bias.abs_().add_(1.0)
        for m in model.modules():
            if isinstance(m, CrossModalAlignment):
                m.query.weight.mul_(0.1)
                m.key.weight.mul_(0.1)
    return model


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
    condition_fabric(cpu_model)
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
    """ms and kernel counts of K1, K2 and the AdamW kernel in a
    torch.profiler chrome trace, and the device busy ms (the union of its
    kernels' spans)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel" and e.get("dur", 0) > 0]
    of = lambda key: [e for e in events if key in e["name"]]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    return {"k1_ms": sum(e["dur"] for e in of("fused_attention_fwd")) / 1e3,
            "k2_ms": sum(e["dur"] for e in of("fused_attention_bwd")) / 1e3,
            "adamw_ms": sum(e["dur"] for e in of("adamw_kernel")) / 1e3,
            "k1_kernels": len(of("fused_attention_fwd")),
            "k2_kernels": len(of("fused_attention_bwd")),
            "adamw_kernels": len(of("adamw_kernel")),
            "busy_ms": busy_time(spans) / 1e3,
            "window_ms": (spans[-1][1] - spans[0][0]) / 1e3, "kernels": len(events)}


def phase_train_cli(report):
    """The training entry point as a user runs it: ``d2r_tpu_torch.cli.main``
    on a fabricated dataset (``TRAINER_DATA``, corrupt images included),
    D2R-base at ``run.sh``'s recipe for ``TRAINER_EPOCHS`` epochs; then the
    restore probe, ``--only_test --load_path <best_model>``, whose test loss
    must equal the trained run's bit for bit. The trainer runs the captured
    step: host calls 34 K1 and 34 K2 a warm-up step and the capture, none a
    replay, 34 K1 an eval batch; the traced dispatch (the first replay)
    holds K1, K2 and AdamW kernels, counted.
    ``--steps_per_dispatch`` is ``TRAINER_DISPATCH``; the step statistics
    leave out the warm-up dispatches, the capture's and the traced one."""
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
        # neither the warm-up dispatches, the capture's nor the traced one
        timed = summary["step_ms"][host_calls(steps) + 1:]
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
            f"{len(timed)} of {len(summary['step_ms'])} dispatches, the warm-up, capture and "
            f"traced ones left out): median {quartiles[2]:.2f}, min / q1 / q3 / max "
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
        log(f"[train_cli] traced dispatch ({TRAINER_DISPATCH} replayed step(s)): "
            f"{prof['k1_kernels']} K1, {prof['k2_kernels']} K2, {prof['adamw_kernels']} AdamW "
            f"kernels; K1 {prof['k1_ms'] / TRAINER_DISPATCH:.3f} ms, K2 "
            f"{prof['k2_ms'] / TRAINER_DISPATCH:.3f} ms and AdamW "
            f"{prof['adamw_ms'] / TRAINER_DISPATCH:.3f} ms a step, device busy "
            f"{prof['busy_ms'] / TRAINER_DISPATCH:.2f} ms a step in a "
            f"{prof['window_ms'] / TRAINER_DISPATCH:.2f} ms window")
        log(f"[train_cli] losses by window {[round(x, 4) for x in result['train_losses']]}; "
            f"dev F1 {[round(r['f_score'], 4) for r in dev]}; test loss {test['loss']!r}")
        check_step_counts(launches, steps, eval_batches=eval_batches)
        # one trace of one dispatch, which cannot be taken again: the kernels
        # are there (a trace may lose a few events; phase 6 counts exactly)
        assert min(prof["k1_kernels"], prof["k2_kernels"], prof["adamw_kernels"]) > 0, prof
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
        assert probe_launches == {**no_counts(), "k1": 34 * eval_calls(batches)}, probe_launches
        assert probe["loss"] == test["loss"] and probe["f_score"] == test["f_score"]
        result["eval_replay"] = eval_replay_check(best, cfg, batches)
        return {n: launches[n] + probe_launches[n] for n in launches}
    finally:
        logging.getLogger("d2r_tpu_torch").removeHandler(handler)
        shutil.rmtree(root, ignore_errors=True)


def eval_replay_check(best, cfg, batches):
    """The captured eval step on the trained checkpoint: three different
    batches through ``make_eval_step`` (the eager warm-up, the capture and a
    replay), each batch's kept loss and logits against its eager forward,
    bit for bit, read after all three ran; again after a train step (the
    AdamW kernel writes the weights in place) and after
    ``restore_checkpoint`` (``load_state_dict`` copies them in). Then a dev
    pass of ``batches`` batches timed eager and replayed (CUDA events)."""
    import numpy as np
    import torch
    from d2r_tpu_torch.train import state as st
    from d2r_tpu_torch.train.checkpoint import restore_checkpoint
    state = restore_checkpoint(best, st.create_train_state(cfg, total_steps=10, device="cuda"))
    data = [dict(uint8_batch(cfg, cfg.batch_size, seed=40 + i),
                 valid=np.ones(cfg.batch_size, bool)) for i in range(3)]
    step = st.make_eval_step()

    def compare(when):
        with torch.no_grad():
            ref = [st._eager_eval(state, b) for b in data]
        got = [step(state, b) for b in data]
        diff = max(max((g[k].float() - r[k].float()).abs().max().item() for k in ("loss", "logits"))
                   for g, r in zip(got, ref))
        equal = all(torch.equal(g[k], r[k]) for g, r in zip(got, ref) for k in ("loss", "logits"))
        log(f"[train_cli] eval replay {when}: kept loss and logits of 3 batches "
            f"{'==' if equal else '!='} eager (max abs diff {diff:.3g})")
        return {"bit_equal": equal, "max_abs_diff": diff}, ref

    out = {}
    out["trained"], first = compare("on the trained weights")
    state, _ = st.make_train_step()(state, data[0], 1)
    out["after_train_step"], _ = compare("after a train step")
    restore_checkpoint(best, state)
    out["after_restore"], again = compare("after restore_checkpoint")
    out["restored_equals_trained"] = all(torch.equal(a["logits"], b["logits"])
                                         for a, b in zip(first, again))
    timed = {}
    for mode, fn in (("eager", lambda b: st._eager_eval(state, b)), ("replay",
                                                                    lambda b: step(state, b))):
        ms = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            with torch.no_grad():
                for i in range(batches):
                    fn(data[i % 3])
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        timed[mode] = float(np.median(ms))
    out["dev_pass_ms"] = timed
    log(f"[train_cli] a dev pass of {batches} batches of {cfg.batch_size}: eager "
        f"{timed['eager']:.1f} ms, replayed {timed['replay']:.1f} ms (CUDA events, median "
        f"of 3)")
    assert all(out[k]["bit_equal"] for k in ("trained", "after_train_step", "after_restore")), out
    assert out["restored_equals_trained"], out
    return out


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
        # the int8 service's build: two W8A16 host calls a quantized module
        # a bucket
        w8 = 2 * int8_modules(cfg) * len(BUCKETS)
        assert launches == {**no_counts(), "k1": want, "w8a16": w8}, launches
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def int8_modules(cfg):
    """The modules ``quant.quantize_model`` quantizes in ``cfg``'s model:
    one W8A16 product each a forward."""
    import torch
    from d2r_tpu_torch.models.unimo import D2RClassifier
    from d2r_tpu_torch.quant import _INT8
    with torch.device("meta"):
        model = D2RClassifier(cfg)
    return sum(type(m) in _INT8 for m in model.modules())


EXPORT_ROOT = os.path.join("build", "chip_smoke_serve_export")
EXPORT_LINE = re.compile(r"exported bucket (\d+) for (\w+): trace ([\d.]+) s, save ([\d.]+) s, "
                         r"(\d+) bytes")
# the processes this script starts, stopped by main() if still running
STARTED = []
EXPORTS = {}     # the process that phase export_start started
LANE_LOG = os.path.join("build", "chip_smoke_lane.log")          # its output
EXTRAS_OUT = os.path.join("build", "chip_smoke_extras_lane.json")   # phase 19's result


def export_cli(argv):
    """``python -m d2r_tpu_torch.export`` in a process of its own: its wall
    seconds, its JSON line, and each exported bucket's trace and save
    seconds and bytes from its log."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "d2r_tpu_torch.export", *argv],
                       capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"export CLI {argv} exited {p.returncode}: {p.stderr[-3000:]}")
    buckets = {int(m[1]): {"trace_s": float(m[3]), "save_s": float(m[4]), "bytes": int(m[5])}
               for m in EXPORT_LINE.finditer(p.stderr)}
    return {"wall_s": time.perf_counter() - t0, "line": json.loads(p.stdout.splitlines()[-1]),
            "buckets": buckets}


def export_artifacts(root):
    """Phase ``serve_export``'s work, run in the second process
    (``background_process``) beside phases 4-15: it is host work (tracing,
    JSON, loading programs) but for the self-checks' few forwards and the
    replays. The exports: the CLI on the D2R-base checkpoint at ``BUCKETS``
    and, with ``--quantize int8``, at ``EXPORT_INT8_BUCKETS``; D2R-large
    (seed 0, built on the card) through ``export_predictor`` at
    ``EXPORT_LARGE_BUCKETS``; ``--format torch``. Then their checks
    (:func:`serve_export_checks`). Writes ``root/serve_export.json`` (the
    checks' report and launch counts)."""
    import logging
    from d2r_tpu_torch import export as texport
    from d2r_tpu_torch.models.unimo import build_model
    best = os.path.join(root, "best_model")
    out = {}
    for name, flags, buckets in (("bf16", [], BUCKETS),
                                 ("int8", ["--quantize", "int8"], EXPORT_INT8_BUCKETS)):
        out[name] = export_cli(["--load_path", best, "--out_dir", os.path.join(root, name),
                                "--batch_buckets", ",".join(map(str, buckets)), *flags])
    rows = []
    handler = logging.Handler()
    handler.emit = lambda record: rows.append(record.args)
    logger = logging.getLogger("d2r_tpu_torch.export")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    t0 = time.perf_counter()
    texport.export_predictor(model_config("large", compute_dtype="bfloat16"),
                             build_model(model_config("large", compute_dtype="bfloat16"),
                                         device="cuda", seed=0),
                             os.path.join(root, "large"), batch_buckets=EXPORT_LARGE_BUCKETS,
                             self_check=False)
    out["large"] = {"wall_s": time.perf_counter() - t0,
                    "buckets": {b: {"trace_s": tr, "save_s": sv, "bytes": n}
                                for b, _, tr, sv, n in rows}}
    out["torch"] = export_cli(["--load_path", best, "--out_dir", os.path.join(root, "torch"),
                               "--format", "torch"])
    result = {"exports_s": time.perf_counter() - T0}
    launches = serve_export_checks(result, out)
    write_json(os.path.join(root, "serve_export.json"), {"result": result, "launches": launches})


def background_process(root, lane_out):
    """The script's second process: :func:`export_artifacts` (the exports
    and their checks, for ``phase_serve_export``), then phase 19
    (:func:`phase_extras`, host work: the CLI a few steps at a time) with
    its report and launch counts into ``lane_out``, for the phase that
    collects it (:func:`phase_extras_collect`). A failure of either goes
    into its file as ``error``."""
    import torch
    for fn, out in ((lambda: export_artifacts(root), os.path.join(root, "serve_export.json")),
                    (lambda: extras_process(lane_out), lane_out)):
        try:
            fn()
        except BaseException:  # noqa: BLE001 - the collecting phase raises it
            write_json(out, {"error": traceback.format_exc()[-3000:]})
        gc.collect()
        torch.cuda.empty_cache()


def write_json(path, obj):
    """``obj`` as JSON at ``path``, which appears whole or not at all."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def extras_process(out):
    """:func:`phase_extras` in this process; its report and launch counts
    into ``out``."""
    report = {}
    counts = phase_extras(report)
    write_json(out, {"report": report["extras"], "counts": counts})


def phase_export_start(report):
    """Save phase 13's D2R-base checkpoint (phase 4's model) under
    ``EXPORT_ROOT`` and start :func:`background_process` (the exports and
    their checks, then phase 19); ``phase_serve_export`` and
    ``phase_extras_collect`` collect it."""
    import shutil
    import types
    from d2r_tpu_torch.config import save_config_json
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.train.checkpoint import save_checkpoint
    shutil.rmtree(EXPORT_ROOT, ignore_errors=True)
    cfg = model_config("base", compute_dtype="bfloat16")
    save_checkpoint(os.path.join(EXPORT_ROOT, "best_model"),
                    types.SimpleNamespace(model=build_model(cfg, device="cpu", seed=0)))
    save_config_json(cfg, os.path.join(EXPORT_ROOT, "config.json"))
    log_file = open(LANE_LOG, "w")
    STARTED.append(subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as c; c.background_process({EXPORT_ROOT!r}, {EXTRAS_OUT!r})"],
        stdout=log_file, stderr=subprocess.STDOUT))
    log_file.close()
    EXPORTS["proc"] = STARTED[-1]
    log(f"[export_start] D2R-base checkpoint saved; exports started (pid {STARTED[-1].pid})")


def op_nodes(program):
    """Nodes of an exported program by target: the custom ops K1
    (``d2r_torch::fused_attention_fwd``), K3 and W8A16, and einsums with the
    plain attention's equations."""
    import torch
    targets = {torch.ops.d2r_torch.fused_attention_fwd.default: "k1",
               torch.ops.d2r_torch.flash_attention_fwd.default: "k3",
               torch.ops.d2r_torch.w8a16_linear.default: "w8a16"}
    out = {"k1": 0, "k3": 0, "w8a16": 0, "plain_attention_einsums": 0, "nodes": 0}
    for n in program.graph.nodes:
        out["nodes"] += 1
        if n.op != "call_function":
            continue
        if n.target in targets:
            out[targets[n.target]] += 1
        elif str(n.target) == "aten.einsum.default" and n.args[0] in (
                "blhd,bshd->bhls", "bhls,bshd->blhd"):
            out["plain_attention_einsums"] += 1
    return out


def replay_ms(graph, n=7):
    """Median ms of ``n`` replays of ``graph`` (CUDA events each)."""
    import numpy as np
    import torch
    ms = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return float(np.median(ms))


def export_run(tag, out, live, model, rows, spec, tol, exported, trace=True):
    """Load the artifact at ``out`` with ``model`` and hold each bucket's
    replayed probabilities to ``live``'s (a ``Predictor`` of the same
    weights) on the same rows: labels equal, within ``tol``. Per bucket
    (``exported`` holds its trace and save seconds and bytes): the
    program's op nodes (``spec``'s K1 and K3 counts, no plain attention),
    load s, warm-up s (an eager forward and the capture, whose K1 and K3
    host calls are counted), replayed forward ms beside ``live``'s, and,
    with ``trace``, a traced replay at the first and last bucket."""
    import numpy as np
    from d2r_tpu_torch.export import load_exported
    from d2r_tpu_torch.quant import Int8Weight
    pred = load_exported(out, model)
    # an int8 program holds the W8A16 op once a quantized module
    w8a16_nodes = sum(isinstance(m, Int8Weight) for m in live.model.modules())
    result = {}
    for b in pred.batch_buckets:
        r = result[b] = dict(exported[b])
        t0 = time.perf_counter()
        pred._program(b)
        r["load_s"] = time.perf_counter() - t0
        r["nodes"] = op_nodes(pred.programs[b])
        before = read_counts()
        t0 = time.perf_counter()
        g = pred.graph(b, np.uint8)
        r["warmup_s"] = time.perf_counter() - t0
        r["host_calls"] = {k: read_counts()[k] - before[k] for k in ATTENTION}
        mine = (rows[0][:b], rows[1][:b], rows[2][:b], rows[3][:b])
        got = pred.predict(*mine)
        want = live.predict(*mine)
        r["max_abs_diff"] = float(np.abs(got["probs"] - want["probs"]).max())
        r["bit_equal"] = bool(np.array_equal(got["probs"], want["probs"]))
        r["labels_equal"] = bool(np.array_equal(got["label"], want["label"]))
        r["replay_ms"] = replay_ms(g.graph)
        r["predictor_replay_ms"] = replay_ms(live.graph(b, np.uint8).graph)
        if trace and b in (pred.batch_buckets[0], pred.batch_buckets[-1]):
            # a count that is off in a trace that lost kernel events (three
            # replays of one graph, a kernel count that is not whole) is
            # traced again, as phase 4 does
            for attempt in range(TRACE_ATTEMPTS):
                prof = device_profile(g.graph.replay, 3, "forward")
                counts = {k: prof.get(f"{k}_kernels_per_forward") for k in ("k1", "k3")}
                lost = not float(prof.get("kernels_per_forward", 0)).is_integer()
                if counts == {"k1": spec["k1"], "k3": spec["k3"]} or not lost:
                    break
                log(f"[export{spec['tag']}] {tag} bucket {b:2d}: the trace lost kernel events "
                    f"({prof['kernels_per_forward']} kernels a replay); profiling again")
            r["traced_replay"] = {**counts, "kernels_per_forward": prof.get("kernels_per_forward"),
                                  "trace_attempts": attempt + 1}
        log(f"[export{spec['tag']}] {tag} bucket {b:2d}: {r['nodes']['k1']} K1 and "
            f"{r['nodes']['k3']} K3 and {r['nodes']['w8a16']} W8A16 op nodes of "
            f"{r['nodes']['nodes']}, plain attention "
            f"einsums {r['nodes']['plain_attention_einsums']}; trace {r['trace_s']:.1f} s, save "
            f"{r['save_s']:.1f} s, {r['bytes']} bytes, load {r['load_s']:.1f} s, warmup "
            f"{r['warmup_s']:.1f} s (host calls {r['host_calls']}); "
            f"{'==' if r['bit_equal'] else '!='} Predictor (max abs diff "
            f"{r['max_abs_diff']:.3g}, labels {'equal' if r['labels_equal'] else 'DIFFER'}); "
            f"replay {r['replay_ms']:.3f} ms, Predictor's {r['predictor_replay_ms']:.3f} ms"
            + (f"; traced replay {r['traced_replay']}" if "traced_replay" in r else ""))
        assert r["labels_equal"] and r["max_abs_diff"] <= tol, (tag, b, r)
        assert r["nodes"]["k1"] == spec["k1"] and r["nodes"]["k3"] == spec["k3"], r["nodes"]
        assert r["nodes"]["w8a16"] == w8a16_nodes, (r["nodes"], w8a16_nodes)
        assert r["nodes"]["plain_attention_einsums"] == 0, r["nodes"]
        assert r["host_calls"] == {"k1": 2 * spec["k1"], "k2": 0, "k3": 2 * spec["k3"]}, r
        if "traced_replay" in r:
            assert (r["traced_replay"]["k1"], r["traced_replay"]["k3"]) == (
                spec["k1"], spec["k3"]), r["traced_replay"]
    return result


def serve_export_checks(result, exported):
    """The serving artifacts that :func:`export_artifacts` wrote (their
    trace and save times in ``exported``), loaded with ``load_exported``
    and replayed in their bucket graphs beside ``Predictor``'s on the same
    rows: D2R-base through the CLI at buckets 1/8/32, uint8 pixels (atol
    1e-6, labels equal, 34 K1 op nodes a program), int8 at
    ``EXPORT_INT8_BUCKETS`` (within ``QUANT_LOGITS_TOL``, labels equal) and
    D2R-large at ``EXPORT_LARGE_BUCKETS`` (29 K1 and 29 K3 op nodes); the
    ``--format torch`` file's keys. Into ``result``; returns the launch
    counts."""
    import copy
    import torch
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.serve import Predictor
    from d2r_tpu_torch.train.checkpoint import restore_model

    zero_counts()
    result["cli"] = {k: {"wall_s": v["wall_s"], "line": v.get("line")} for k, v in exported.items()}
    log(f"[export] the exports ran {result['exports_s']:.1f} s (CLI wall s: "
        f"{({k: round(v['wall_s'], 1) for k, v in exported.items()})})")
    cfg = model_config("base", compute_dtype="bfloat16")
    model = restore_model(os.path.join(EXPORT_ROOT, "best_model"), cfg)
    requests = make_requests(cfg)[-1]
    for name, quantize, tol in (("bf16", None, 1e-6), ("int8", "int8", QUANT_LOGITS_TOL)):
        buckets = exported[name]["line"]["buckets"]
        # a Predictor takes its model over: each side gets a copy
        live = Predictor(cfg, copy.deepcopy(model), batch_buckets=buckets, quantize=quantize)
        run = export_run(name, os.path.join(EXPORT_ROOT, name), live, copy.deepcopy(model),
                         requests, MODELS["base"], tol,
                         {int(b): v for b, v in exported[name]["buckets"].items()},
                         trace=quantize is None)
        result[name] = {"buckets": run,
                        "tensor_bytes": sum(t.nbytes for t in live.tensors().values())}
        log(f"[export] {name}: program bytes {[run[b]['bytes'] for b in run]} against "
            f"{result[name]['tensor_bytes']} bytes of the tensors a program takes")
        del live
        gc.collect()
        torch.cuda.empty_cache()
    del model
    large = model_config("large", compute_dtype="bfloat16")
    model = build_model(large, device="cuda", seed=0)
    live = Predictor(large, copy.deepcopy(model), batch_buckets=EXPORT_LARGE_BUCKETS)
    result["large"] = {"buckets": export_run(
        "large", os.path.join(EXPORT_ROOT, "large"), live, model, make_requests(large)[-1],
        MODELS["large"], 1e-6, {int(b): v for b, v in exported["large"]["buckets"].items()})}
    del live, model
    sd = torch.load(os.path.join(EXPORT_ROOT, "torch", "best_model.pth"), weights_only=True,
                    mmap=True)
    result["format_torch"] = {"keys": len(sd), "wall_s": exported["torch"]["wall_s"],
                              "bytes": sum(t.nbytes for t in sd.values())}
    log(f"[export] --format torch: {len(sd)} keys, {result['format_torch']['bytes']} bytes "
        f"(the CLI's wall {exported['torch']['wall_s']:.1f} s)")
    assert len(sd) == exported["torch"]["line"]["keys"], result["format_torch"]
    launches = read_counts()
    result["launches"] = launches
    assert launches["k2"] == 0 and launches["k1"] > 0 and launches["k3"] > 0, launches
    return launches


def lane_file(path, tag):
    """The JSON that :func:`background_process` writes to ``path``, once it
    is there (at most ``EXPORT_WAIT_S`` from here, and not after the process
    ended), with the process's log lines that hold ``tag`` shown first;
    raises the process's error."""
    proc = EXPORTS["proc"]
    t0 = time.perf_counter()
    while not os.path.exists(path) and proc.poll() is None:
        if time.perf_counter() - t0 > EXPORT_WAIT_S:
            raise TimeoutError(f"{path}: not written within {EXPORT_WAIT_S} s")
        time.sleep(0.5)
    waited = time.perf_counter() - t0
    with open(LANE_LOG) as f:
        lines = f.read().splitlines()
    for line in lines:
        if tag in line:
            log(f"[second process] {line.strip()}")
    if not os.path.exists(path):
        raise RuntimeError(f"the second process exited {proc.returncode} before writing "
                           f"{path}: " + "\n".join(lines)[-3000:])
    with open(path) as f:
        got = json.load(f)
    if "error" in got:
        raise RuntimeError(f"the second process failed: {got['error']}")
    return {**got, "waited_s": waited}


def phase_extras_collect(report):
    """Phase 19: the trainer extras (:func:`phase_extras`), run by the
    second process after the exports' checks; its log lines, report and
    launch counts here."""
    try:
        got = lane_file(EXTRAS_OUT, "[extras]")
        report["extras"] = {**got["report"], "waited_s": got["waited_s"]}
        log(f"[train_extras] the second process ran phase 19 beside the phases since "
            f"serve_export's checks; waited {got['waited_s']:.1f} s for it here")
        return got["counts"]
    finally:
        for path in (EXTRAS_OUT, LANE_LOG):
            if os.path.exists(path):
                os.remove(path)


def phase_serve_export(report):
    """The serving artifacts as a user makes them: the process that
    ``phase_export_start`` started exported them and ran their checks
    (:func:`export_artifacts`, :func:`serve_export_checks`) beside the
    phases since; here it is waited for, its log lines are shown and its
    report and launch counts taken."""
    import shutil
    try:
        got = lane_file(os.path.join(EXPORT_ROOT, "serve_export.json"), "[export")
        report["serve_export"] = {**got["result"], "waited_s": got["waited_s"]}
        log(f"[serve_export] the second process ran the exports and their checks beside the "
            f"phases since export_start; waited {got['waited_s']:.1f} s for them here")
        return got["launches"]
    finally:
        shutil.rmtree(EXPORT_ROOT, ignore_errors=True)


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
        launches = no_counts()
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
                "step_ms_median": float(np.median(summary["step_ms"][host_calls(steps):])),
                "test_loss": test["loss"], "test_f_score": test["f_score"],
                "tower_tensors_differing_from_files": len(differ)}
            log(f"[pretrained] CLI {name} ({' '.join(extra) or 'towers trained'}), one epoch: "
                f"{steps} steps, {eval_batches} eval batches, {wall:.1f} s; samples/s "
                f"{summary['samples_per_sec']:.2f}, median step "
                f"{result[name]['step_ms_median']:.2f} ms; K1 {counts['k1']}, K2 "
                f"{counts['k2']}; test loss {test['loss']!r}; best model's tower tensors "
                f"differing from the files: {len(differ)} of {compared}")
            check_step_counts(counts, steps, eval_batches=eval_batches)
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
    within 1e-6 of each leaf's max |value|; the recipe's captured step
    against its eager step (:func:`replay_checks`); then the CLI for one
    epoch of 64 posts with all of the recipe's flags and
    ``--pretrained_dir``.

    Host calls a step (a warm-up step's and the capture's; a replay makes
    none): without remat K1, K2 and K3 29 times each (phase 10).
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
    launches = no_counts()
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
            per = per_step[name]
            check_step_counts(counts, steps, k1=per["k2"], k3=large["k3"],
                              k1_recompute=per["k1"] - per["k2"],
                              k3_recompute=per["k3"] - large["k3"])
            assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
            launches = {k: launches[k] + counts[k] for k in launches}
        torch.cuda.empty_cache()
        r, p = result["recipe"], result["without_knobs"]
        result["step_ms_ratio"] = r["step_ms_median"] / p["step_ms_median"]
        result["peak_mem_ratio"] = r["peak_mem_gb"] / p["peak_mem_gb"]
        log(f"[train_scaled] recipe / without the knobs: step ms {result['step_ms_ratio']:.3f}, "
            f"peak memory {result['peak_mem_ratio']:.3f}")
        # the recipe's captured step (remat, scanned layers, bf16 moments)
        # against its eager step
        result["replay_checks"] = replay_checks("[train_scaled] replay", cfg, weights, batch)

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
                assert attention(counts) == expect, (counts, expect)
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
        check_step_counts(counts, steps, k1=large["k1"], k3=large["k3"],
                          k1_recompute=remat_k1 - large["k1"],
                          k3_recompute=remat_k3 - large["k3"], eval_batches=eval_batches)
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
    out, total = {}, no_counts()
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
        check_step_counts(counts, r["steps"])
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
        check_step_counts(counts, steps, eval_batches=eval_batches)
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


def rows_bound_ms(r, k, dtype_name):
    """The rows quantize's bound: x read once, the codes and the scales
    written once, over the card's memory rate."""
    item = 4 if dtype_name == "float32" else 2
    return (r * k * (item + 1) + 4 * r) / HBM_BYTES_PER_S * 1e3


def quantize_checks():
    """The quantize and rescale kernels against their plain versions at
    :data:`QDOT_SHAPES` (x (M, K), w (N, K), g (M, N)), fp32 and bf16, bit
    for bit: by rows (one launch, and amax + codes as under a group) x, w
    and g; by columns (codes transposed) x, w and g; the rescale of
    ``int_mm``'s product in the forward's order (rows, then columns) and
    the dW order, into fp32 and the input's type; at the FFN shape in bf16
    again inside a captured graph. Then the rows quantize at every site of
    :data:`QUANT_ROW_SITES`, bit for bit in its three uses (one launch, the
    amax alone, the codes from a given amax) and timed beside its plain
    version and its bound, and the column quantize and the rescale at the
    FFN shape in bf16 (bytes: the input read once, the codes, scales or
    output written once); no single PyTorch call computes any of them, so
    they have no library time."""
    import torch
    from d2r_tpu_torch.ops import qdot
    from d2r_tpu_torch.ops.kernels import quantize as qk

    def run(x, w, gout, dtype):
        out = {}
        for name, t in (("x", x), ("w", w), ("g", gout)):
            out[f"rows_{name}"] = qk.quantize_rows(t)
            out[f"rows2_{name}"] = qk.quantize_rows(t, qk.row_amax(t))
            out[f"cols_{name}"] = qk.quantize_cols(t, qk.col_amax(t))
        (qx, sx), (qw, sw) = out["rows_x"], out["rows_w"]
        y = qdot.int_mm(qx, qw)
        out["rescale"] = tuple(qk.rescale(y, sx, sw.t(), t) for t in (torch.float32, dtype))
        (cx, csx), (cg, csg) = out["cols_x"], out["cols_g"]
        out["rescale_dw"] = (qk.rescale(qdot.int_mm(cg, cx), csx, csg.t(), dtype),)
        return out

    def plain(x, w, gout, dtype):
        out = {}
        for name, t in (("x", x), ("w", w), ("g", gout)):
            out[f"rows_{name}"] = out[f"rows2_{name}"] = qk.quantize_rows_plain(t)
            out[f"cols_{name}"] = qk.quantize_cols_plain(t, qk.col_amax_plain(t))
        (qx, sx), (qw, sw) = out["rows_x"], out["rows_w"]
        y = qdot.int_mm(qx, qw)
        out["rescale"] = tuple(qk.rescale_plain(y, sx, sw.t(), t) for t in (torch.float32, dtype))
        (cx, csx), (cg, csg) = out["cols_x"], out["cols_g"]
        out["rescale_dw"] = (qk.rescale_plain(qdot.int_mm(cg, cx), csx, csg.t(), dtype),)
        return out

    checks, bad = [], []
    for name, m, k, n in QDOT_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(m + k + n + 1)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, gout = (torch.randn(sh, generator=g, device="cuda").to(dtype) * 3
                          for sh in ((m, k), (n, k), (m, n)))
            x[0] = 0    # an all-zero row
            want = plain(x, w, gout, dtype)
            runs = {"eager": run(x, w, gout, dtype)}
            if name == QDOT_SHAPES[0][0] and dtype == torch.bfloat16:
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    run(x, w, gout, dtype)
                torch.cuda.current_stream().wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    runs["captured"] = run(x, w, gout, dtype)
                graph.replay()
            torch.cuda.synchronize()
            for how, got in runs.items():
                unequal = [key for key in want
                           if not all(torch.equal(a, b) for a, b in zip(got[key], want[key]))]
                checks.append({"shape": name, "dtype": str(dtype)[6:], "run": how,
                               "outputs": len(want), "unequal": unequal})
                log(f"[int8] quantize / rescale kernels {name} {str(dtype)[6:]} {how}: "
                    f"{len(want) - len(unequal)} of {len(want)} outputs == plain"
                    + (f"; DIFFER: {unequal}" if unequal else ""))
                bad += [f"{name} {dtype} {how} {key}" for key in unequal]
    assert not bad, f"quantize / rescale kernels differ from their plain versions: {bad}"

    bound = lambda ms: {"bound_ms": ms, "bound_by": "bytes", "library_ms": None,
                        "library_device_ms": None}

    def timings(kernel, plain_fn, r, what):
        r = {**r, "site": what, "ms": cuda_time_ms(kernel), "plain_ms": cuda_time_ms(plain_fn),
             "device_ms": device_time_ms(kernel), "plain_device_ms": device_time_ms(plain_fn),
             "max_abs_err": 0.0}
        log(f"[int8] {what}: {r['ms'] * 1e3:.2f} us back to back, {r['device_ms'] * 1e3:.2f} us "
            f"alone; plain {r['plain_ms'] * 1e3:.2f} / {r['plain_device_ms'] * 1e3:.2f} us; "
            f"bound {r['bound_ms'] * 1e3:.2f} us (bytes), "
            f"{r['bound_ms'] / r['device_ms']:.0%} of it alone")
        return r

    row_sites = []
    for i, (site, r, k, dtypes) in enumerate(QUANT_ROW_SITES):
        for dtype in dtypes:
            g = torch.Generator(device="cuda").manual_seed(40 + i)
            x = torch.randn((r, k), generator=g, device="cuda") * 3
            x[0] = 0    # an all-zero row
            x = x.to(getattr(torch, dtype))
            want = qk.quantize_rows_plain(x)
            amax = qk.row_amax(x)
            got = {"one launch": qk.quantize_rows(x), "amax + codes": qk.quantize_rows(x, amax),
                   "amax": (amax,)}
            unequal = [how for how, out in got.items()
                       if not all(torch.equal(a, b)
                                  for a, b in zip(out, (qk.row_amax_plain(x),) if how == "amax"
                                                  else want))]
            log(f"[int8] quantize by rows, {site} ({r}, {k}) {dtype}: "
                + (f"DIFFER: {unequal}" if unequal else "== plain in all three uses"))
            bad += [f"rows {site} {dtype} {how}" for how in unequal]
            row_sites.append({**timings(lambda: qk.quantize_rows(x),
                                        lambda: qk.quantize_rows_plain(x),
                                        bound(rows_bound_ms(r, k, dtype)),
                                        f"quantize by rows, {site} ({r}, {k}) {dtype}"),
                              "site": site, "R": r, "K": k, "dtype": dtype,
                              "tiling": list(qk.rows_tiling(k, x.dtype))})
    assert not bad, f"the rows quantize differs from its plain version: {bad}"

    _, m, k, n = QDOT_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
    w = torch.randn((n, k), generator=g, device="cuda").bfloat16()
    qx, sx = qk.quantize_rows(x)
    qw, sw = qk.quantize_rows(w)
    y = qdot.int_mm(qx, qw)
    timed = {
        "quantize_cols": (lambda: qk.quantize_cols(x, qk.col_amax(x)),
                          lambda: qk.quantize_cols_plain(x, qk.col_amax_plain(x)),
                          bound((m * k * 3 + 4 * k) / HBM_BYTES_PER_S * 1e3),
                          f"quantize by columns, x ({m}, {k}) bf16, codes (K, M)"),
        "rescale": (lambda: qk.rescale(y, sx, sw.t(), torch.bfloat16),
                    lambda: qk.rescale_plain(y, sx, sw.t(), torch.bfloat16),
                    bound((m * n * 6 + 4 * (m + n)) / HBM_BYTES_PER_S * 1e3),
                    f"rescale, y ({m}, {n}) int32 -> bf16")}
    rows = {name: timings(*args) for name, args in timed.items()}
    # the kernels line's rows entry: x of the QKV / FFN-in / attention-out
    # products in bf16
    rows["quantize_rows"] = next(r for r in row_sites
                                 if (r["site"], r["dtype"]) == ("x", "bfloat16"))
    return {"checks": checks, "timed": rows, "row_sites": row_sites}


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
    from d2r_tpu_torch.ops import qdot

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
    result["kernels"] = quantize_checks()
    _, m, k, n = QDOT_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
    w = torch.randn((n, k), generator=g, device="cuda").bfloat16()
    qx, qw = qdot.quantize_rows(x)[0], qdot.quantize_rows(w)[0]
    times = {"quant_dot_ms": cuda_time_ms(lambda: qdot.quant_dot(x, w)),
             "bf16_linear_ms": cuda_time_ms(lambda: F.linear(x, w)),
             "int_mm_ms": cuda_time_ms(lambda: qdot.int_mm(qx, qw)),
             "quantize_x_ms": cuda_time_ms(lambda: qdot.quantize_rows(x))}
    times.update({f"{k}_device": device_time_ms(fn) for k, fn in (
        ("quant_dot_ms", lambda: qdot.quant_dot(x, w)),
        ("quantize_x_ms", lambda: qdot.quantize_rows(x)),
        ("int_mm_ms", lambda: qdot.int_mm(qx, qw)), ("bf16_linear_ms", lambda: F.linear(x, w)))})
    result["ffn_times"] = times
    log(f"[int8] FFN product {m}x{k} . {k}x{n}, bf16 in: " + ", ".join(
        f"{k} {v * 1e3:.2f} us" for k, v in times.items()))

    phase_card_vs_cpu(report, "base", quant="int8")
    return int8_steps(result)[1]


# the int8 kernels of csrc/quantize.cu, by the names a trace gives them
QUANT_KERNELS = ("quantize_rows_kernel", "amax_cols_kernel", "codes_cols_kernel",
                 "rescale_kernel")


def int8_steps(result):
    """Ten bf16 steps of D2R-base at batch 64 with ``quant_train`` none,
    int8 and int8_all on the same weights and batch (``step_runs``), then
    of each one replayed step traced (its kernels by name, the quantize
    kernels' launches and device ms) and one eager step traced by aten op
    (``op_profile``). Into ``result["steps"]``; returns (runs, launch
    counts)."""
    import torch
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.ops import qdot
    from d2r_tpu_torch.train import state as st

    cfg = {mode: model_config("base", batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                              quant_train=mode) for mode in qdot.MODES}
    weights = build_model(cfg["none"], device="cpu", seed=0).state_dict()
    batch = {k: torch.from_numpy(v).cuda() for k, v in model_batch(cfg["none"], TRAIN_BATCH, 0).items()}

    def after(mode, state, r, b):
        step = st.make_train_step()
        replay = device_profile(lambda: step(state, b, 1), 1, "step")
        calls = replay.get("kernel_calls_per_step", {})
        times = replay.get("kernel_ms_per_step", {})
        r["replay"] = {**brief(replay), **{
            f"{name}{what}_per_step": sum(v for k, v in table.items() if name in k)
            for name in QUANT_KERNELS for what, table in (("", calls), ("_ms", times))}}
        log(f"[int8] {mode} replayed step traced: busy "
            f"{replay.get('device_busy_ms_per_step', float('nan')):.2f} ms; " + ", ".join(
                f"{name} {r['replay'][name + '_per_step']:g} launches "
                f"{r['replay'][name + '_ms_per_step']:.3f} ms" for name in QUANT_KERNELS))

        # an eager step: a replay's kernels carry no aten op to attribute
        # them to
        def eager():
            st._eager_step(state, b, 1, False)
            state.step += 1

        r["profile"] = op_profile(eager)
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
    return runs, total


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
    total = no_counts()

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
        check_step_counts(counts, 1)
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
            check_step_counts(counts, steps, eval_batches=eval_batches)
            assert all(math.isfinite(x) for x in losses + [test["loss"]]), losses
            add(counts)
            return r

        # --async_checkpoint: the best model, written by the save thread at the
        # end of the epoch, equals the resume slot written synchronously right
        # after from the same state; the test pass after its reload equals a
        # restore probe of the file. The two runs are compared too, for the
        # record (two runs repeat bit for bit: PRNG_RUN_TOL)
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
        # --prng_impl threefry2x32: the rbg run's losses and best model bit
        # for bit (PRNG_RUN_TOL); other dropout bits would move the first
        # step's loss by far more. The names' bit equality within one
        # process is the CPU tests' too.
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
                and three["loss_max_rel_diff_vs_rbg_run"] <= PRNG_RUN_TOL
                and three["best_model_vs_rbg_run_max_abs_diff"] <= PRNG_RUN_TOL), \
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


def nodrop_base_config(**overrides):
    """D2R-base with its text tower's dropout at 0, under a preset of its
    own (registered here, in every process that calls it)."""
    import dataclasses
    from d2r_tpu_torch import config as tconfig
    base = model_config("base")
    tc = dataclasses.replace(base.text_config(), hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    name = f"{base.bert_name}-dropout-0"
    tconfig.register_text_preset(name, lambda: tc)
    return model_config("base", bert_name=name, **overrides)


def tower_presets(depth, dropout=True):
    """(text, vision) preset names of D2R-base's towers at full width cut
    to ``depth`` blocks (the text tower's dropout off unless ``dropout``),
    registered here, in every process that calls it."""
    import dataclasses
    from d2r_tpu_torch import config as tconfig
    base = model_config("base")
    tc, vc = base.text_config(), base.vision_config()
    if not dropout:
        tc = dataclasses.replace(tc, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    tc = dataclasses.replace(tc, num_hidden_layers=depth)
    vc = dataclasses.replace(vc, num_hidden_layers=depth)
    text = f"{base.bert_name}-{depth}l" + ("" if dropout else "-dropout-0")
    vision = f"{base.vit_name}-{depth}l"
    tconfig.register_text_preset(text, lambda: tc)
    tconfig.register_vision_preset(vision, lambda: vc)
    return text, vision


def mesh_config(spec, fp32=True, dropout=None, **overrides):
    """A mesh phase's configuration: D2R-base at full width with
    ``spec["depth"]``-block towers, batch 64; in fp32 with dropout off
    (on where ``dropout``) and no LR warm-up (the fp32 check), else bf16
    with dropout on; the phase's pipeline stages and ``overrides``."""
    text, vision = tower_presets(spec["depth"], dropout=not fp32 if dropout is None
                                 else dropout)
    pipe = dict(pipeline_stages=spec.get("stages", 1),
                pipeline_microbatches=spec.get("microbatches", 0))
    kind = (dict(compute_dtype="float32", warmup_ratio=0.0) if fp32
            else dict(compute_dtype="bfloat16"))
    return model_config("base", bert_name=text, vit_name=vision, batch_size=TRAIN_BATCH,
                        **{**kind, **pipe, **overrides})


def mesh_rows(batch, mesh):
    """The rows of a global batch that ``mesh``'s rank holds."""
    if mesh is None or mesh.dp == 1:
        return batch
    n = TRAIN_BATCH // mesh.dp
    return {k: v[mesh.data_index * n:(mesh.data_index + 1) * n] for k, v in batch.items()}


def mesh_base_model(cfg):
    """:func:`condition_fabric`'s seed-1 model of ``cfg``, built whole on the
    CPU as one process builds it."""
    from d2r_tpu_torch.models.unimo import build_model
    return condition_fabric(build_model(cfg, device="cpu", seed=1))


def mesh_steps(spec):
    """The bf16 steps a mesh phase's ranks take at each microbatch count."""
    return spec.get("bf16_steps", PARALLEL_BF16_STEPS)


def k1_per_step(depth, held_stages=1, microbatches=1):
    """K1 (and K2) launches a train step of a rank holding 1/``held_stages``
    of each ``depth``-block tower, its blocks run ``microbatches`` times:
    the two towers, the two extra layers and the 8 IMRC cells of DR_step
    4."""
    return 2 * (depth // held_stages) * microbatches + 2 + 8


def fabric_timer(model):
    """CUDA events around both routing branches' forwards: a list that each
    forward appends its (start, end) pair of each branch to."""
    import torch
    spans = []
    for branch in (model.model.itr_module, model.model.Reversed_itr_module):
        def pre(_m, _a):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            spans.append([start, None])

        def post(_m, _a, _o):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            spans[-1][1] = end

        branch.register_forward_pre_hook(pre)
        branch.register_forward_hook(post)
    return spans


def mesh_ref_tag(overrides):
    """The one-process run a mesh configuration is held to: the int8
    run, the dropout run, or the plain one (the layout settings)."""
    return ("_int8" if "quant_train" in overrides else
            "_dropout" if overrides.get("dropout") else "")


def mesh_fp32_run(model, cfg, mesh=None):
    """From ``model`` (:func:`mesh_base_model`) in fp32 (TF32 off) on this
    rank's rows of one batch of 64: a train-mode forward (loss, JS loss,
    logits, the SAF BatchNorms' running statistics after it, both routing
    branches' ms; dropout, where on, from a seed at the rank's global
    rows), then, from the same start, one train step: its loss and
    its peak memory above what was allocated before it on the CPU, and on
    the card the whole updated parameters and buffers, the whole gradients
    it applied and, in one process, each parameter's LR (``"whole"``)."""
    import numpy as np
    import torch
    from d2r_tpu_torch.models.layers import DropoutRNG
    from d2r_tpu_torch.parallel.mesh import full_gradients, full_state_dict
    from d2r_tpu_torch.train.state import _model_inputs, create_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = create_train_state(cfg, 100, device="cuda", model=model, mesh=mesh)
    batch = mesh_rows(model_batch(cfg, TRAIN_BATCH, seed=7), mesh)
    batch["valid"] = np.ones(len(batch["labels"]), bool)
    running = {k: v for k, v in state.model.named_buffers() if "running" in k}
    start = {k: v.clone() for k, v in running.items()}
    spans = fabric_timer(state.model)
    rng = DropoutRNG(5, "cuda", row0=0 if mesh is None else mesh.data_index * len(batch["labels"]))
    with torch.no_grad():
        loss, logits, aux = state.model.train()(**_model_inputs(batch, "cuda"), rng=rng)
    torch.cuda.synchronize()
    out = {"loss": loss.item(), "js_loss": aux["js_loss"].item(), "logits": logits.cpu(),
           "running": {k: v.cpu().clone() for k, v in running.items()},
           "fabric_ms": sum(a.elapsed_time(b) for a, b in spans)}
    for k, v in running.items():
        v.copy_(start[k])
    del loss, logits, aux
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = make_train_step()(state, batch, 0)
    out["step_loss"] = metrics["loss"].item()
    out["step_peak_gb"] = (torch.cuda.max_memory_allocated() - before) / 1e9
    whole = out["whole"] = {"params": full_state_dict(state.model, mesh),
                            "grads": full_gradients(state.model, mesh), "lr": {}}
    if mesh is None:
        lr = {id(p): g["lr"] for g in state.optimizer.param_groups for p in g["params"]}
        whole["lr"] = {k: lr[id(p)] for k, p in state.model.named_parameters()}
    return out


def params_after_one_step(params, ref, excuse):
    """Parameters after one AdamW step against ``ref``'s, both from the same
    weights: (elements beyond rtol 2e-4 / atol 2e-6, elements excused, max
    abs difference, elements). ``excuse(name, ref tensor, difference)``
    gives the mask of a tensor's elements that the difference beyond the
    tolerance is excused at (:func:`sign_free_steps`,
    :func:`adam_explained_steps`), or None to hold it to the tolerance."""
    bad = excused = total = 0
    worst = 0.0
    for k, v in ref.items():
        d = params[k] - v
        beyond = d.abs() > MESH_STEP_ATOL + MESH_STEP_RTOL * v.abs()
        ok = excuse(k, v, d)
        if ok is not None:
            excused += int((beyond & ok).sum())
            beyond &= ~ok
        bad += int(beyond.sum())
        worst = max(worst, d.abs().max().item())
        total += v.numel()
    return bad, excused, worst, total


def sign_free_steps(grads, lr, sign_free):
    """An ``excuse`` of :func:`params_after_one_step` from the reference
    step's gradients and base LRs: Adam's first step moves an element by
    lr g / (|g| + eps), about lr sign(g), so two steps whose gradients agree
    in sign agree within the tolerance. An element is excused only where
    ``sign_free(name, g)`` is true (the gradient's sign is not fixed by the
    tolerance the gradients are held to) and the two differ by at most the
    most one step can move it either way, 2 lr (1 + wd |p|)."""
    from d2r_tpu_torch.train.optimizer import WEIGHT_DECAY

    def excuse(k, v, d):
        if k not in grads:
            return None
        return sign_free(k, grads[k]) & (d.abs() <= 2 * lr[k] * (1 + WEIGHT_DECAY * v.abs()))
    return excuse


def adam_explained_steps(grads, ref_grads, lr):
    """An ``excuse`` of :func:`params_after_one_step` where the gradients
    differ by more than rounding (int8's code flips): an element is excused
    only where the two parameters differ by what Adam's first step makes
    of the two gradients, lr (g / (|g| + eps) - g' / (|g'| + eps)), within
    the tolerance. A wrong LR, weight decay or moment fails it; the
    gradients themselves are held to their own bound."""
    from d2r_tpu_torch.train.optimizer import EPS
    normed = lambda g: g / (g.abs() + EPS)

    def excuse(k, v, d):
        if k not in ref_grads:
            return None
        step_gap = lr[k] * (normed(ref_grads[k]) - normed(grads[k]))
        return (d - step_gap).abs() <= MESH_STEP_ATOL + MESH_STEP_RTOL * v.abs()
    return excuse


def mesh_fp32_errors(got, ref, mesh, whole=None, grad_bound=None):
    """This rank's fp32 results against the one-process run's: relative
    errors of the losses, the logits' max abs error over its rows, the
    running statistics' max relative error and, given the one-process run's
    ``whole`` tensors, the gradient and updated parameter elements beyond
    rtol 2e-4 / atol 2e-6 (compared on the card).
    An updated parameter is excused only where Adam's sign is not fixed
    (:func:`sign_free_steps`): where the one-process gradient lies within
    that tolerance of zero, so that Adam's normalised step g / (|g| + eps)
    takes its sign from digits the gradient tolerance does not fix. The
    excused elements are counted. ``grad_bound`` (int8 training): the
    gradient elements beyond that share of their leaf's max (the bound of
    ``tests/test_torch_qdot.py``) are counted as a share of all
    (:data:`INT8_MESH_GRAD_SHARE` holds it), and a parameter is excused
    only where it differs from one process's by what Adam's first step
    makes of the two gradients (:func:`adam_explained_steps`): a code flip
    moves a small gradient by much of itself, and the fc group's LR of
    5e-2 turns the eps term's share of that into a visible step."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    rows = slice(None)
    if mesh.dp > 1:
        n = TRAIN_BATCH // mesh.dp
        rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    out = {"loss_rel": rel(got["loss"], ref["loss"]),
           "js_loss_rel": rel(got["js_loss"], ref["js_loss"]),
           "logits_abs": (got["logits"] - ref["logits"][rows]).abs().max().item(),
           "running_rel": max(((got["running"][k] - v).abs() / v.abs().clamp_min(1e-30))
                              .max().item() for k, v in ref["running"].items()),
           "step_loss_rel": rel(got["step_loss"], ref["step_loss"])}
    if whole is not None:
        mine = got["whole"]
        assert list(mine["params"]) == list(whole["params"]), "keys differ from one process's"
        grads = whole["grads"]
        if grad_bound is None:
            grads_bad = sum(int(((mine["grads"][k] - g).abs()
                                 > MESH_STEP_ATOL + MESH_STEP_RTOL * g.abs()).sum())
                            for k, g in grads.items())
            excuse = sign_free_steps(grads, whole["lr"],
                                     lambda k, g: g.abs() <= MESH_STEP_ATOL)
        else:
            # a leaf whose gradient is rounding noise (the cross-modal key
            # biases, to which a softmax is invariant) is held against 1e-4
            # of the largest leaf's max, as tests/test_torch_qdot.py does
            floor = 1e-4 * max(g.abs().max().item() for g in grads.values())
            beyond_bound = sum(
                int(((mine["grads"][k] - g).abs() > grad_bound * max(g.abs().max().item(), floor))
                    .sum()) for k, g in grads.items())
            out["grads_share_beyond_bound"] = (
                beyond_bound / sum(v.numel() for v in whole["params"].values()))
            grads_bad = 0
            excuse = adam_explained_steps(mine["grads"], grads, whole["lr"])
        bad, excused, worst, total = params_after_one_step(mine["params"], whole["params"],
                                                           excuse)
        out.update(params_beyond_tol=bad, grads_beyond_tol=grads_bad,
                   params_excused=excused, params_max_abs=worst, params_total=total)
    return out


def mesh_bf16_steps(mesh, steps, weights, cfg):
    """``steps`` train steps of ``cfg`` (bf16, dropout on) from the whole CPU
    state dict ``weights``, on this rank's rows of one batch of 64: the
    launch counts, step ms (CUDA events; the ranks share one card), peak
    memory above what was allocated before, losses, the dropout seed and
    the (L, heads, D) of every attention call of the first step, and
    afterwards the tensors that differ from their copies on the other
    model, stage and data ranks (``replica_mismatches``)."""
    import torch
    from d2r_tpu_torch.models.unimo import D2RClassifier
    from d2r_tpu_torch.ops import attention
    from d2r_tpu_torch.parallel.mesh import replica_mismatches
    from d2r_tpu_torch.train.state import create_train_state, make_train_step
    model = D2RClassifier(cfg)
    model.load_state_dict(weights)
    state = create_train_state(cfg, 1000, device="cuda", model=model, mesh=mesh)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in mesh_rows(model_batch(cfg, TRAIN_BATCH, seed=0), mesh).items()}
    step = make_train_step()
    calls = []
    kernel = attention.fused_attention_small

    def recording(q, k, v, bias, scale, rate=0.0, seed=None):
        # the site's seed (read from the buffer: a sync a call), ordinal and
        # global (row, head) offsets
        calls.append((None if seed is None else (int(seed.seed), *seed[1:]), rate,
                      tuple(q.shape[1:])))
        return kernel(q, k, v, bias, scale, rate, seed)

    attention.fused_attention_small = recording
    losses, events, first = [], [], None
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        zero_counts()
        for _ in range(steps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            state, metrics = step(state, batch, 1)
            end.record()
            losses.append(metrics["loss"])
            events.append((start, end))
            first = first if first is not None else list(calls)
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        attention.fused_attention_small = kernel
    ms = [a.elapsed_time(b) for a, b in events]
    return {"launches": counts, "step_ms": ms, "losses": [float(x) for x in losses],
            "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
            "calls": first, "replica_mismatches": replica_mismatches(state.model, mesh)}


def qdot_mesh_check(mesh):
    """``quant_dot`` on this rank's model group, at the BERT FFN site
    (4096 x 768 -> 3072, bf16) and an odd fp32 one, split along K
    (row-parallel) and along N (column-parallel), both modes: whether the
    forward and the quantized backward equal this rank's part of one
    process's on the card, bit for bit. ``int8``'s backward is two float
    products (the straight-through estimator), of other shapes on a rank
    (a column split's input gradient sums two halves), whose library
    kernels need not give the same bits: held within 1e-5 (fp32) or 2e-2
    (bf16) of the largest value."""
    import torch
    from d2r_tpu_torch.ops.qdot import quant_dot
    out = {}
    gen = torch.Generator().manual_seed(5)
    for name, m, k, n, dtype in (("bert_ffn", 4096, 768, 3072, torch.bfloat16),
                                 ("odd", 6, 40, 24, torch.float32)):
        x0, w0, g0 = (torch.randn(shape, generator=gen).to(dtype).cuda()
                      for shape in ((m, k), (n, k), (m, n)))
        t, i = mesh.tp, mesh.model_index
        ks, ns = slice(i * k // t, (i + 1) * k // t), slice(i * n // t, (i + 1) * n // t)
        for mode in ("int8", "int8_all"):
            def run(x, w, g, **kw):
                x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
                y = quant_dot(x, w, mode, **kw)
                y.backward(g)
                return y.detach(), x.grad, w.grad

            y, dx, dw = run(x0, w0, g0)
            yr, dxr, dwr = run(x0[:, ks], w0[:, ks], g0, model_group=mesh.model_group,
                               split="row")
            yc, dxc, dwc = run(x0, w0[ns], g0[:, ns], model_group=mesh.model_group,
                               split="column")
            def same(a, b):
                if mode == "int8_all":
                    return torch.equal(a, b)
                tol = 1e-5 if a.dtype == torch.float32 else 2e-2
                return bool((a.float() - b.float()).abs().max().item()
                            <= tol * b.float().abs().max().item())

            out[f"{name}_{mode}"] = {
                "row": [torch.equal(yr, y), same(dxr, dx[:, ks]), same(dwr, dw[:, ks])],
                "column": [torch.equal(yc, y[:, ns]), same(dxc, dx), same(dwc, dw[ns])]}
    return out


def mesh_rank(rank, world, shape, ref_root, steps, name):
    """One rank of a mesh on the card (``launch.spawn``, gloo): the fp32
    check against the one-process run saved under ``ref_root`` (rank 0
    holds the whole tensors against it), then the bf16 steps from the same
    weights (at each of the phase's ``bf16_microbatches``), then the
    phase's further configurations in fp32, each against its one-process
    run, and ``quant_dot`` on the model group."""
    import torch
    from d2r_tpu_torch.models.unimo import D2RClassifier
    from d2r_tpu_torch.parallel import distributed
    from d2r_tpu_torch.parallel.mesh import make_mesh
    spec = PARALLEL_MESHES[name]
    torch.cuda.set_device(0)
    names = ("data", "stage", "model") if len(shape) == 3 else ("data", "model")[:len(shape)]
    mesh = make_mesh(shape, names, device="cuda")
    distributed.warmup_collectives(mesh)

    def fp32(tag, overrides, weights=None, grad_bound=None):
        t0 = time.perf_counter()
        cfg = mesh_config(spec, **overrides)
        if weights is None:
            model = mesh_base_model(cfg)
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        else:                     # the same weights: the layout settings name no tensor
            model = D2RClassifier(cfg)
            model.load_state_dict(weights)
        got = mesh_fp32_run(model, cfg, mesh)
        ref = torch.load(os.path.join(ref_root, f"one_process{tag}.pth"), weights_only=True)
        if rank == 0 and tag not in wholes:
            wholes.clear()
            wholes[tag] = torch.load(os.path.join(ref_root, f"whole{tag}.pth"),
                                     map_location="cuda", weights_only=True)
        errors = mesh_fp32_errors(got, ref, mesh, wholes.get(tag), grad_bound)
        errors.update(fabric_ms=got["fabric_ms"], step_peak_gb=got["step_peak_gb"],
                      s=time.perf_counter() - t0)
        del got, model
        gc.collect()
        torch.cuda.empty_cache()
        return errors, weights

    out = {"rank": rank, "data_index": mesh.data_index, "stage_index": mesh.stage_index,
           "model_index": mesh.model_index}
    wholes = {}    # rank 0: the one-process run's whole tensors, loaded once a tag
    out["fp32"], weights = fp32("", {})
    if not spec.get("more"):
        wholes.clear()
    out["bf16"] = {}
    for m in spec.get("bf16_microbatches", (spec.get("microbatches", 0),)):
        t0 = time.perf_counter()
        b16 = mesh_bf16_steps(mesh, steps, weights,
                              mesh_config(spec, fp32=False, pipeline_microbatches=m))
        b16["s"] = time.perf_counter() - t0
        out["bf16"][m] = b16
        gc.collect()
        torch.cuda.empty_cache()
    out["more"] = {}
    for tag, overrides in spec.get("more", ()):
        out["more"][tag] = fp32(mesh_ref_tag(overrides), overrides, weights,
                                QDOT_STEP_BOUND if "quant_train" in overrides else None)[0]
    del weights
    wholes.clear()
    if mesh.tp > 1 and spec.get("more"):
        out["quant_dot"] = qdot_mesh_check(mesh)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def check_mesh(shape, ranks, spec):
    """Assert a mesh's results: the fp32 tolerances, K1 and K2 on every rank
    at every site with the rank's local heads and the launches its blocks
    imply, the step's dropout seeds the same on every rank with the rank's
    global (row, head) offsets, different seeds across the (microbatch,
    block) pairs of a pipeline, whole tensors bit-equal across model and stage ranks and
    every tensor across data ranks; the further configurations at their
    tolerances, and ``quant_dot`` bit for bit."""
    tp = shape[-1] if len(shape) > 1 else 1
    pp = shape[1] if len(shape) == 3 else 1
    depth = spec["depth"]
    for r in ranks:
        for tag, e in [("plain", r["fp32"])] + list(r["more"].items()):
            # int8: a code flip behind a data-group sum moves a value by a
            # step of its row's scale (QUANT_LOGITS_TOL, QDOT_STEP_BOUND)
            fwd, logits = ((QUANT_LOGITS_TOL, QUANT_LOGITS_TOL) if tag == "int8"
                           else (MESH_FWD_RTOL, MESH_LOGITS_ATOL))
            assert e["loss_rel"] <= fwd and e["js_loss_rel"] <= fwd, (tag, e)
            assert e["logits_abs"] <= logits and e["running_rel"] <= fwd, (tag, e)
            assert e["step_loss_rel"] <= max(fwd, MESH_STEP_RTOL), (tag, e)
            assert e.get("params_beyond_tol", 0) == 0 and e.get("grads_beyond_tol", 0) == 0, \
                (tag, e)
            assert e.get("grads_share_beyond_bound", 0) <= INT8_MESH_GRAD_SHARE, (tag, e)
        for m, b in r["bf16"].items():
            k1 = k1_per_step(depth, pp, max(m, 1) if spec.get("stages", 1) > 1 else 1)
            steps = mesh_steps(spec)
            assert attention(b["launches"]) == {"k1": k1 * steps, "k2": k1 * steps,
                                                "k3": 0}, (m, b["launches"])
            assert b["launches"]["adamw"] == steps, b["launches"]
            assert all(math.isfinite(x) for x in b["losses"]), b["losses"]
            heads = {(l, d): h for _, _, (l, h, d) in b["calls"]}
            assert heads == {(64, 64): 12 // tp, (50, 64): 12 // tp, (64, 48): 16 // tp,
                             (50, 48): 16 // tp}, heads
            want = {"model": [], **({"stage": []} if pp > 1 else {}), "data": []}
            assert b["replica_mismatches"] == want, b["replica_mismatches"]
        for check in r.get("quant_dot", {}).values():
            assert all(check["row"]) and all(check["column"]), r["quant_dot"]
    seeds = {}
    for m in ranks[0]["bf16"]:
        seeds[m] = {(r["data_index"], r["stage_index"], r["model_index"]):
                    [c[0] for c in r["bf16"][m]["calls"] if c[1] > 0] for r in ranks}
        tower = (depth // pp) * (max(m, 1) if spec.get("stages", 1) > 1 else 1)
        rows = TRAIN_BATCH // shape[0] // (max(m, 1) if spec.get("stages", 1) > 1 else 1)
        for (d, s, mi), ks in seeds[m].items():
            assert len(ks) == tower + 1, len(ks)      # the BERT blocks + the extra text layer
            keys = [k[:2] for k in ks]                # (step seed, site ordinal)
            assert len(set(keys[:tower])) == tower, "a pipeline's (microbatch, block) share a seed"
            # every rank takes the step's seeds as they are, at its global
            # rows and heads
            assert keys == [k[:2] for k in seeds[m][(0, s, 0)]], "ranks' seeds differ"
            assert all(k[2:] == (d * rows, mi * (12 // tp)) for k in ks), ks
            if (d, s + 1, mi) in seeds[m]:
                assert not set(keys[:tower]) & {k[:2] for k in seeds[m][(d, s + 1, mi)][:tower]}, \
                    "stages share a seed"
    return seeds


def mesh_refs(report, name):
    """The one-process fp32 runs of :data:`PARALLEL_MESHES` ``[name]`` (the
    sequential towers, whose math a pipeline's equals), saved under
    ``build/chip_smoke_<name>`` for the ranks; returns that directory."""
    import shutil
    import torch
    from d2r_tpu_torch.models.unimo import D2RClassifier
    spec = PARALLEL_MESHES[name]
    root = os.path.join("build", "chip_smoke_" + name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    result = report[name] = {}
    t0 = time.perf_counter()
    sequential = dict(pipeline_stages=1, pipeline_microbatches=0)
    refs = [("", {})]
    if any("quant_train" in o for _, o in spec.get("more", ())):
        refs.append(("_int8", dict(quant_train="int8")))
    if any(o.get("dropout") for _, o in spec.get("more", ())):
        refs.append(("_dropout", dict(dropout=True)))      # prng_impl rbg
    weights = None
    for tag, overrides in refs:
        cfg = mesh_config(spec, **{**sequential, **overrides})
        if weights is None:
            model = mesh_base_model(cfg)
            weights = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model = D2RClassifier(cfg)
            model.load_state_dict(weights)
        ref = mesh_fp32_run(model, cfg)
        del model
        result[f"one_process{tag}"] = {"fabric_ms": ref["fabric_ms"],
                                       "step_peak_gb": ref["step_peak_gb"]}
        torch.save(ref.pop("whole"), os.path.join(root, f"whole{tag}.pth"))
        torch.save(ref, os.path.join(root, f"one_process{tag}.pth"))
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    result["one_process_s"] = time.perf_counter() - t0
    return root


def mesh_spawn(name, root):
    """The ranks of every mesh of :data:`PARALLEL_MESHES` ``[name]`` on the
    one card over gloo (:func:`mesh_rank`): (shape, the ranks' results,
    wall s) a mesh."""
    from d2r_tpu_torch.parallel.launch import spawn
    spec = PARALLEL_MESHES[name]
    runs = []
    for shape in spec["shapes"]:
        t0 = time.perf_counter()
        ranks = spawn(mesh_rank, math.prod(shape), (shape, root, mesh_steps(spec), name),
                      backend="gloo", timeout_s=600)
        runs.append((shape, ranks, time.perf_counter() - t0))
    return runs


def mesh_report(report, name, runs):
    """Log and check (:func:`check_mesh`) the meshes' results of
    :func:`mesh_spawn`; returns their launch counts summed."""
    import torch
    from d2r_tpu_torch.ops.kernels.fused_attention import (
        DropoutSeed,
        dropout_keep_mask,
        seed_tensor,
    )
    spec = PARALLEL_MESHES[name]
    result = report[name]
    steps = mesh_steps(spec)
    total = no_counts()
    for shape, ranks, wall in runs:
        world = math.prod(shape)
        label = "x".join(map(str, shape))
        result[label] = {"wall_s": wall, "depth": spec["depth"], "ranks": [
            {k: r[k] for k in r if k != "bf16"}
            | {"bf16": {m: {k: v for k, v in b.items() if k != "calls"}
                        for m, b in r["bf16"].items()}} for r in ranks]}
        for r in ranks:
            for b16 in r["bf16"].values():
                for n in total:
                    total[n] += b16["launches"][n]
            e = r["fp32"]
            log(f"[{name} {label}] rank {r['rank']} (data {r['data_index']}, stage "
                f"{r['stage_index']}, model {r['model_index']}), towers of "
                f"{spec['depth']} blocks: fp32 loss rel {e['loss_rel']:.2e}, js rel "
                f"{e['js_loss_rel']:.2e}, logits abs {e['logits_abs']:.2e}, running rel "
                f"{e['running_rel']:.2e}, step loss rel {e['step_loss_rel']:.2e}"
                + (f", gradient elements beyond rtol 2e-4/atol 2e-6: "
                   f"{e['grads_beyond_tol']}, updated parameters beyond it: "
                   f"{e['params_beyond_tol']} of {e['params_total']}, excused (Adam's sign "
                   f"not fixed, within 2 lr): {e['params_excused']} (max "
                   f"abs {e['params_max_abs']:.2e})" if "params_total" in e else "")
                + f"; fabric {e['fabric_ms']:.2f} ms, step peak {e['step_peak_gb']:.2f} GB"
                + f", peak {r['peak_mem_gb']:.1f} GB")
            for m, b16 in r["bf16"].items():
                log(f"[{name} {label}] rank {r['rank']} bf16 dropout 0.1"
                    + (f", {m} microbatches" if spec.get("stages", 1) > 1 else "")
                    + f": K1/K2/K3 {b16['launches']} in {steps} steps, "
                    f"step ms {[round(x, 1) for x in b16['step_ms']]}, peak "
                    f"{b16['peak_gb']:.2f} GB, losses {[round(x, 4) for x in b16['losses']]}, "
                    f"tensors differing from their copies "
                    f"{ {k: len(v) for k, v in b16['replica_mismatches'].items()} }")
            for tag, e in r["more"].items():
                log(f"[{name} {label}] rank {r['rank']} {tag} fp32: loss rel "
                    f"{e['loss_rel']:.2e}, js rel {e['js_loss_rel']:.2e}, logits abs "
                    f"{e['logits_abs']:.2e}, step loss rel {e['step_loss_rel']:.2e}"
                    + (f", gradients beyond: {e['grads_beyond_tol']}, parameters beyond: "
                       f"{e['params_beyond_tol']} (excused {e['params_excused']})"
                       if "params_total" in e else "")
                    + (f", share of gradient elements beyond 2/127 of their leaf's max "
                       f"{e['grads_share_beyond_bound']:.3g}"
                       if "grads_share_beyond_bound" in e else "")
                    + f"; fabric {e['fabric_ms']:.2f} ms (plain {r['fp32']['fabric_ms']:.2f}),"
                    f" step peak {e['step_peak_gb']:.2f} GB (plain "
                    f"{r['fp32']['step_peak_gb']:.2f})")
            if "quant_dot" in r:
                log(f"[{name} {label}] rank {r['rank']} quant_dot split over the model "
                    f"group, equal to one process's bits: {json.dumps(r['quant_dot'])}")
        seeds = check_mesh(shape, ranks, spec)
        # the masks of the first BERT site on two ranks, from the kernels'
        # bits: each the one-process mask of the whole batch and heads cut
        # at the rank's rows and heads, and so different from the other's
        first = next(iter(seeds.values()))
        tp = shape[-1] if len(shape) > 1 else 1
        m0 = next(iter(ranks[0]["bf16"]))
        rows = TRAIN_BATCH // shape[0] // (max(m0, 1) if spec.get("stages", 1) > 1 else 1)
        masks = []
        for r in ranks[:2]:
            seed, site, b0, h0 = first[(r["data_index"], r["stage_index"], r["model_index"])][0]
            at = DropoutSeed(seed_tensor(seed, "cuda"), site, b0, h0)
            masks.append(dropout_keep_mask(at, rows, 12 // tp, 64, 64, 0.1, "cuda"))
            whole = dropout_keep_mask(at._replace(b0=0, h0=0), rows * shape[0], 12, 64, 64, 0.1,
                                      "cuda")
            assert torch.equal(masks[-1], whole[b0:b0 + rows, h0:h0 + 12 // tp]), (b0, h0)
        differ = result[label]["mask_share_differing"] = (
            (masks[0] != masks[1]).float().mean().item())
        assert differ > 0.05, differ
        log(f"[{name} {label}] {world} ranks on one card over gloo in {wall:.1f} s; first "
            f"BERT site masks of ranks 0 and 1 equal one process's at their global rows "
            f"and heads, and differ from each other in {differ:.1%} of elements")
    return total


# the meshes of :data:`BACKGROUND_MESHES`, by name, as the background
# thread of phase mesh_start leaves them: "done" (an Event), then "runs"
# (mesh_spawn's) or "error"
LANE = {}


def phase_mesh_start(report):
    """Phase ``mesh_start``, between phases 13 and 14: the
    one-process runs of :data:`BACKGROUND_MESHES` here (:func:`mesh_refs`)
    and ``serve_mesh``'s checkpoint and posts (:func:`serve_mesh_prepare`),
    then their ranks, one mesh after the other, and ``serve_mesh``'s
    servers last, from a thread of this process, beside the phases that
    follow; phases 21, 23 and ``serve_mesh`` collect them
    (:func:`mesh_collect`, :func:`lane_wait`)."""
    import shutil
    import threading
    roots = {name: mesh_refs(report, name) for name in BACKGROUND_MESHES}
    serving = serve_mesh_prepare(report)
    names = BACKGROUND_MESHES + ("serve_mesh",)
    LANE.update({name: {"done": threading.Event(), "started": time.perf_counter()}
                 for name in names})
    LANE["serve_mesh"]["inputs"] = serving

    def run():
        for name in names:
            lane = LANE[name]
            try:
                lane["runs"] = (serve_mesh_lane(*serving) if name == "serve_mesh"
                                else mesh_spawn(name, roots[name]))
            except Exception as e:  # noqa: BLE001 - raised again by its collecting phase
                lane["error"] = e
            finally:
                if name in roots:
                    shutil.rmtree(roots[name], ignore_errors=True)
                lane["ended"] = time.perf_counter()
                lane["done"].set()

    threading.Thread(target=run, name="meshes", daemon=True).start()
    log(f"[mesh_start] one-process runs of {list(BACKGROUND_MESHES)} saved; their ranks "
        f"and serve_mesh's servers started beside the next phases")


def lane_wait(report, name):
    """The background lane ``name``'s result, once it has ended."""
    lane = LANE.get(name)
    if lane is None:
        raise RuntimeError(f"{name}: phase mesh_start did not start it")
    t0 = time.perf_counter()
    if not lane["done"].wait(MESH_WAIT_S):
        raise TimeoutError(f"{name}: its ranks gave no result within {MESH_WAIT_S} s")
    if "error" in lane:
        raise lane["error"]
    report.setdefault(name, {}).update(waited_s=time.perf_counter() - t0,
                                       ranks_s=lane["ended"] - lane["started"])
    log(f"[{name}] its ranks ran in the background ({lane['ended'] - lane['started']:.1f} s "
        f"from mesh_start, the lanes before it included); waited "
        f"{report[name]['waited_s']:.1f} s for them here")
    return lane["runs"]


SERVE_MESH_ROOT = os.path.join("build", "chip_smoke_serve_mesh")


def serve_mesh_prepare(report):
    """``serve_mesh``'s inputs, made in the foreground: a D2R-base
    checkpoint (bf16 serving config, seed 2) under ``build/``, 32 posts
    and their arrays as the service's preprocessing makes them
    (``encode_text``, ``decode_image_bytes``; uint8 pixels)."""
    import shutil
    import types
    import numpy as np
    from d2r_tpu_torch.config import save_config_json
    from d2r_tpu_torch.data.dataset import encode_text
    from d2r_tpu_torch.data.image import decode_image_bytes
    from d2r_tpu_torch.data.tokenizer import load_tokenizer
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.train.checkpoint import save_checkpoint
    import base64
    t0 = time.perf_counter()
    shutil.rmtree(SERVE_MESH_ROOT, ignore_errors=True)
    cfg = model_config("base", compute_dtype="bfloat16")
    best = os.path.join(SERVE_MESH_ROOT, "best_model")
    save_checkpoint(best, types.SimpleNamespace(model=build_model(cfg, device="cpu", seed=2)))
    save_config_json(cfg, os.path.join(SERVE_MESH_ROOT, "config.json"))
    posts = make_posts(max(SERVE_MESH_ROWS), 256, 50, seed=17)
    tok = load_tokenizer(cfg.bert_name, vocab_size=cfg.text_config().vocab_size)
    size = cfg.vision_config().image_size
    rows = [(*encode_text(tok, p["text"], cfg.max_seq),
             decode_image_bytes(base64.b64decode(p["image_b64"]), size, raw_uint8=True))
            for p in posts]
    arrays = [np.stack([r[i] for r in rows]) for i in range(4)]
    report["serve_mesh"] = {"prepare_s": time.perf_counter() - t0}
    return best, posts, arrays


def serve_mesh_server(best, posts):
    """``python -m d2r_tpu_torch.server --dp 2`` on ``best``: one
    /predict_batch of each of :data:`SERVE_MESH_ROWS` first posts, then
    Ctrl-C. Returns (answers by rows, startup s, request ms by rows, exit
    code)."""
    import signal
    import threading
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "d2r_tpu_torch.server", "--load_path", best, "--dp", "2",
         "--port", "0", "--batch_buckets", ",".join(map(str, BUCKETS)), "--max_wait_ms", "5"],
        stdout=subprocess.PIPE, text=True, env=dict(os.environ, PYTHONPATH=os.getcwd()))
    STARTED.append(proc)
    url = None
    for line in proc.stdout:
        found = re.search(r"serving on (http://\S+)", line)
        if found:
            url = found.group(1)
            break
    if url is None:
        raise RuntimeError(f"the --dp 2 server exited with {proc.wait()} before serving")
    # the ranks' later lines, read so that the pipe never fills
    threading.Thread(target=proc.stdout.read, daemon=True).start()
    startup = time.perf_counter() - t0
    answers, ms = {}, {}
    try:
        for n in SERVE_MESH_ROWS:
            status, body, ms[n] = http_post(url + "/predict_batch", {"items": posts[:n]},
                                            timeout=300)
            if status != 200:
                raise RuntimeError(f"--dp 2 server: {n} posts answered {status}: {body}")
            answers[n] = body["results"]
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return answers, startup, ms, rc


def serve_mesh_rank(rank, world, best, arrays):
    """One rank of the :data:`SERVE_MESH_SHAPE` Predictor on the card
    (gloo): built from the checkpoint, warmed, then the first rows of
    ``arrays`` at each of :data:`SERVE_MESH_ROWS`, counts set to 0 just
    before them and read after; each request's ms (host clock), and
    ``latency_stats``'s p50 at bucket 8."""
    import torch
    from d2r_tpu_torch.parallel.mesh import make_mesh
    from d2r_tpu_torch.serve import Predictor, latency_stats
    from d2r_tpu_torch.train.checkpoint import restore_model
    torch.cuda.set_device(0)
    mesh = make_mesh(SERVE_MESH_SHAPE, ("data", "model"), device="cuda")
    cfg = model_config("base", compute_dtype="bfloat16")
    t0 = time.perf_counter()
    pred = Predictor(cfg, restore_model(best, cfg, "cpu"), batch_buckets=BUCKETS, mesh=mesh)
    pred.warmup()
    build_s = time.perf_counter() - t0
    zero_counts()
    probs, ms = {}, {}
    for n in SERVE_MESH_ROWS:
        t0 = time.perf_counter()
        probs[n] = pred.predict(*[a[:n] for a in arrays])["probs"]
        ms[n] = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    counts = read_counts()
    # latency_stats on the mesh (every rank calls it), at bucket 8
    ms["latency_stats_8"] = 1e3 * latency_stats(
        pred, dict(zip(("input_ids", "attention_mask", "token_type_ids", "pixel_values"),
                       [a[:8] for a in arrays])), iters=2, warmup=0)["p50"]
    return {"probs": probs, "launches": counts, "build_s": build_s, "ms": ms,
            "qkv_hidden": pred.model.model.encoder_text_layers.layer_0.attention_self.qkv.hidden}


def serve_mesh_lane(best, posts, arrays):
    """``serve_mesh``'s background work: the ``--dp 2`` server, then the
    :data:`SERVE_MESH_SHAPE` Predictor's ranks (``launch.spawn``)."""
    from d2r_tpu_torch.parallel.launch import spawn
    out = {"server": serve_mesh_server(best, posts)}
    t0 = time.perf_counter()
    out["ranks"] = spawn(serve_mesh_rank, math.prod(SERVE_MESH_SHAPE), (best, arrays),
                         backend="gloo", timeout_s=600)
    out["ranks_s"] = time.perf_counter() - t0
    return out


def phase_serve_mesh(report):
    """Serving over a mesh, D2R-base at full width (bf16, buckets
    1/8/32), whose servers ran in the background since ``mesh_start``: the
    answers of ``server.py --dp 2`` (HTTP) and of the (1, 2) Predictor
    against one process's replay of the same arrays (a ``Predictor`` here
    on the same checkpoint), within :data:`QUANT_LOGITS_TOL`, labels
    equal; the (1, 2) ranks launch K1 on their own heads (34 sites a
    forward), counted over the three requests. Not a scaling figure: two
    processes share one card."""
    import shutil
    import numpy as np
    from d2r_tpu_torch.serve import Predictor
    from d2r_tpu_torch.train.checkpoint import restore_model
    try:
        runs = lane_wait(report, "serve_mesh")
        best, posts, arrays = LANE["serve_mesh"]["inputs"]
        result = report["serve_mesh"]
        cfg = model_config("base", compute_dtype="bfloat16")
        pred = Predictor(cfg, restore_model(best, cfg, "cuda"), batch_buckets=BUCKETS)
        pred.warmup()
        want = {n: pred.predict(*[a[:n] for a in arrays])["probs"] for n in SERVE_MESH_ROWS}
        del pred
        answers, startup, ms, rc = runs["server"]
        result["server"] = {"startup_s": startup, "request_ms": ms, "exit_code": rc}
        assert rc == 0, f"the --dp 2 server exited with {rc} at Ctrl-C"
        ranks = runs["ranks"]
        result["predictor"] = {"shape": list(SERVE_MESH_SHAPE), "ranks_s": runs["ranks_s"],
                               "build_s": [r["build_s"] for r in ranks],
                               "forward_ms": [r["ms"] for r in ranks],
                               "launches": [r["launches"] for r in ranks]}
        errors = {"server": {}, "predictor": {}}
        for n in SERVE_MESH_ROWS:
            got = np.array([a["probs"] for a in answers[n]], np.float32)
            labels = np.array([a["label"] for a in answers[n]])
            errors["server"][n] = float(np.abs(got - want[n]).max())
            assert np.array_equal(labels, want[n].argmax(-1)), ("server", n)
            for r in ranks:
                assert np.array_equal(r["probs"][n], ranks[0]["probs"][n]), "ranks differ"
            errors["predictor"][n] = float(np.abs(ranks[0]["probs"][n] - want[n]).max())
            assert np.array_equal(ranks[0]["probs"][n].argmax(-1), want[n].argmax(-1))
        result["max_abs_err"] = errors
        log(f"[serve_mesh] server --dp 2 (2 ranks on one card, gloo; startup {startup:.1f} s, "
            f"/predict_batch ms by rows { {n: round(v, 1) for n, v in ms.items()} }): max abs "
            f"err against one process's replay {errors['server']}; (1, 2) Predictor "
            f"(eager, 2 ranks): {errors['predictor']}, request ms by rows (rank 0, host "
            f"clock) { {n: round(v, 1) for n, v in ranks[0]['ms'].items()} }, K1 a "
            f"rank over the three requests {[r['launches']['k1'] for r in ranks]}")
        assert all(v <= QUANT_LOGITS_TOL for e in errors.values() for v in e.values()), errors
        k1 = MODELS["base"]["k1"] * len(SERVE_MESH_ROWS)
        for r in ranks:
            assert r["qkv_hidden"] == 768 // 2, r["qkv_hidden"]
            assert r["launches"] == {**no_counts(), "k1": k1}, r["launches"]
        total = no_counts()
        for r in ranks:
            for name in total:
                total[name] += r["launches"][name]
        return total
    finally:
        shutil.rmtree(SERVE_MESH_ROOT, ignore_errors=True)


def mesh_collect(report, name):
    """The background mesh ``name`` (:func:`phase_mesh_start`): wait for its
    ranks (:func:`lane_wait`), then log and check them
    (:func:`mesh_report`)."""
    return mesh_report(report, name, lane_wait(report, name))


def phase_train_dp(report):
    """Phase 20: data parallelism, dp = 2, then the dropout step; its
    ranks ran in the background since ``mesh_start``
    (:func:`mesh_collect`)."""
    return mesh_collect(report, "train_dp")


def phase_train_tp(report):
    """Phase 21: tensor parallelism, (2, 2), then ``seq_shard``,
    ``fabric_shard`` and int8 training on the same ranks; its ranks ran in
    the background since ``mesh_start`` (:func:`mesh_collect`)."""
    return mesh_collect(report, "train_tp")


def phase_train_pp(report):
    """Phase 23: pipeline stages. First in one process at full width and
    depth (D2R-base, bf16, batch 64, :data:`PP_LOCAL`): the captured
    pipelined step against the sequential one (dropout off, the train-step
    tolerances), its replays against its eager steps
    (:func:`replay_checks`), its launches (every block a microbatch), and
    its checkpoint served unpipelined through ``restore_model`` at bucket
    8, bit for bit the unpipelined model's; then the stage mesh (1, 2, 2)
    on the one card over gloo, whose ranks ran in the background since
    ``mesh_start`` (:func:`mesh_collect`)."""
    import dataclasses
    import torch
    from d2r_tpu_torch.models.unimo import D2RClassifier, build_model
    from d2r_tpu_torch.serve import Predictor
    from d2r_tpu_torch.train import checkpoint as ckpt
    from d2r_tpu_torch.train import state as st
    result = report["train_pp_local"] = {}
    total = no_counts()
    cfg = model_config("base", batch_size=TRAIN_BATCH, compute_dtype="bfloat16")
    piped = dataclasses.replace(cfg, **PP_LOCAL)
    weights = {k: v.clone() for k, v in build_model(cfg, device="cpu", seed=3).state_dict().items()}
    batch = {k: torch.from_numpy(v).cuda() for k, v in model_batch(cfg, TRAIN_BATCH, 0).items()}
    # the recipe (bf16, dropout on): captured steps, sequential and pipelined
    for tag, c in (("sequential", cfg), ("pipelined", piped)):
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = fresh_state(c, weights)
        zero_counts()
        state, timed = timed_steps(state, batch)
        counts = read_counts()
        result[tag] = {"launches": counts, "step_ms": timed["step_ms_median"],
                       "losses": timed["losses"],
                       "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9}
        if tag == "pipelined":
            check_step_counts(counts, timed["steps"],
                              k1=k1_per_step(12, 1, PP_LOCAL["pipeline_microbatches"]))
            total = {n: total[n] + counts[n] for n in total}
        del state
    # the math: fp32 (TF32 off), dropout off, the conditioned fabric, as
    # phase 7 holds a train step; two eager steps, the capture, a replay.
    # Held: each loss within 1e-4; the first step's gradients within 1e-3
    # of each leaf's max (a leaf whose gradient is rounding noise, the
    # SAF's loss-invariant softmax bias, against 1e-4 of the largest
    # leaf's max); the parameters after the first step within rtol 2e-4 /
    # atol 2e-6, excused only where that gradient bound leaves Adam's sign
    # free (params_after_one_step). Every step's gradient and parameter
    # gaps are recorded: after the first, the two runs' weights differ, and
    # Adam's normalised step g / (|g| + eps) turns a gradient's last digits
    # into a step of up to lr wherever g is near 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c32 = nodrop_base_config(batch_size=TRAIN_BATCH, compute_dtype="float32", warmup_ratio=0.0)
    w32 = {k: v.clone() for k, v in
           condition_fabric(build_model(c32, device="cpu", seed=3)).state_dict().items()}
    steps = st.WARMUP_STEPS + 2
    losses, ref_grads, ref_params = {}, [], []
    gaps, first = {"grad_rel": [], "param_abs": []}, None

    def grad_gap(grads, want):
        floor = 1e-4 * max(g.abs().max().item() for g in want.values())
        return max((grads[n] - g).abs().max().item() / max(g.abs().max().item(), floor)
                   for n, g in want.items())

    for tag, c in (("sequential", c32), ("pipelined", dataclasses.replace(c32, **PP_LOCAL))):
        state, step = fresh_state(c, w32), st.make_train_step()
        losses[tag] = []
        for i in range(steps):
            state, m = step(state, batch, 1)
            losses[tag].append(m["loss"].item())
            grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
            params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            if tag == "sequential":
                ref_grads.append(grads)
                ref_params.append(params)
            else:
                gaps["grad_rel"].append(grad_gap(grads, ref_grads[i]))
                gaps["param_abs"].append(max((params[n] - p).abs().max().item()
                                             for n, p in ref_params[i].items()))
                if i == 0:
                    first = params
            del grads, params
        if tag == "sequential":
            lr = {n: g["lr"] for g in state.optimizer.param_groups
                  for n, p in state.model.named_parameters() if any(p is q for q in g["params"])}
        del state, step
        torch.cuda.empty_cache()
    loss_diff = max(abs(a - b) for a, b in zip(losses["sequential"], losses["pipelined"]))
    want = ref_grads[0]
    floor = 1e-4 * max(g.abs().max().item() for g in want.values())
    limit = {n: 1e-3 * max(g.abs().max().item(), floor) for n, g in want.items()}
    beyond, excused, worst, n_params = params_after_one_step(
        first, ref_params[0], sign_free_steps(want, lr, lambda n, g: g.abs() <= limit[n]))
    grad_rel = gaps["grad_rel"][0]
    result.update(fp32_losses=losses, loss_max_abs_diff=loss_diff, grad_max_rel_diff=grad_rel,
                  step_gaps=gaps, first_step_params_beyond_tol=beyond,
                  first_step_params_excused=excused, first_step_params_max_abs=worst,
                  params_total=n_params)
    log(f"[train_pp local] D2R-base batch 64, 2 stages x 4 microbatches in one process: bf16 "
        f"replayed step {result['pipelined']['step_ms']:.2f} ms against the sequential "
        f"{result['sequential']['step_ms']:.2f} ms (CUDA events, median of {TIMED_STEPS}), peak "
        f"{result['pipelined']['peak_gb']:.2f} / {result['sequential']['peak_gb']:.2f} GB, "
        f"launches {result['pipelined']['launches']}; fp32, {steps} steps (the last two "
        f"replayed) against the sequential ones: losses max abs diff {loss_diff:.3g}, the first "
        f"step's gradients max diff {grad_rel:.3g} of the leaf's max, its parameters beyond "
        f"rtol 2e-4 / atol 2e-6: {beyond} of {n_params} (excused where the gradient bound leaves "
        f"Adam's sign free: {excused}, max abs {worst:.3g}); gradient gaps by step "
        f"{[f'{x:.3g}' for x in gaps['grad_rel']]} of the leaf's max, parameter gaps by step "
        f"{[f'{x:.3g}' for x in gaps['param_abs']]}")
    assert loss_diff <= 1e-4 * max(1.0, max(abs(x) for x in losses["sequential"])), result
    assert grad_rel <= 1e-3 and beyond == 0, result
    del ref_grads, ref_params, first, want
    # dropout on only: the off case is the fp32 comparison's replays above
    result["replay_checks"] = replay_checks("[train_pp local replay]", piped, weights, batch,
                                            dropouts=("on",))
    # a pipelined checkpoint, served unpipelined: bit for bit the
    # unpipelined model's answers at bucket 8
    root = os.path.join("build", "chip_smoke_train_pp")
    try:
        model = D2RClassifier(piped)
        model.load_state_dict(weights)
        ckpt.save_checkpoint(os.path.join(root, "best_model"),
                             type("S", (), {"model": model})())
        served = ckpt.restore_model(os.path.join(root, "best_model"), piped, "cuda")
        assert served.model.encoder_text_layers.stages == 1
        plain = D2RClassifier(cfg)
        plain.load_state_dict(weights)
        rows = next(r for r in make_requests(cfg) if len(r[0]) == 8)
        zero_counts()
        got = Predictor(piped, served, batch_buckets=(8,)).predict(*rows)
        want = Predictor(cfg, plain, batch_buckets=(8,)).predict(*rows)
        served_counts = read_counts()
        equal = bool((got["probs"] == want["probs"]).all())
        result["served_unpipelined_equal"] = equal
        log(f"[train_pp local] pipelined checkpoint through restore_model, bucket 8: "
            f"probabilities equal to the unpipelined model's bit for bit: {equal}")
        assert equal
        total = {n: total[n] + served_counts[n] for n in total}
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = mesh_collect(report, "train_pp")
    return {n: total[n] + mesh[n] for n in total}


def phase_train_cli_mp(report):
    """Phase 22: the CLI as one NCCL process, ``--coordinator_address
    127.0.0.1:<free> --num_processes 1 --process_id 0``, at run.sh's recipe
    for :data:`MP_EPOCHS` epochs on :data:`EXTRAS_DATA`: a world of one
    captures its step (34 K1 + 34 K2 host calls a warm-up step and the
    capture), 34 K1 an eval batch, the process group up under NCCL and
    ended at exit;
    then its restore probe in a process group of its own, whose test loss
    equals the run's bit for bit. With two cards or more, also two NCCL
    processes (dp = 2); with one, that is logged as not run."""
    import shutil
    import torch
    import torch.distributed as dist
    from d2r_tpu_torch.data.dataset import write_fake_dataset
    from d2r_tpu_torch.parallel import distributed
    from d2r_tpu_torch.parallel.launch import free_port

    root = os.path.join("build", "chip_smoke_cli_mp")
    shutil.rmtree(root, ignore_errors=True)
    result = report["train_cli_mp"] = {}
    backends = []
    initialize = distributed.initialize

    def recording(*args, **kwargs):   # the backend of the group the CLI makes
        owned = initialize(*args, **kwargs)
        backends.append((dist.get_backend(), dist.get_world_size()))
        return owned

    distributed.initialize = recording
    try:
        # two epochs, four steps: the warm-up steps, the capture and a replay
        paths = write_fake_dataset(os.path.join(root, "data"), **EXTRAS_DATA)
        flags = TRAINER_RECIPE + [
            "--num_epochs", str(MP_EPOCHS), "--train_json", paths["train"], "--dev_json", paths["dev"],
            "--test_json", paths["test"], "--img_dir", paths["img_dir"],
            "--steps_per_dispatch", "1"]
        world = lambda: ["--coordinator_address", f"127.0.0.1:{free_port()}",
                         "--num_processes", "1", "--process_id", "0"]
        out = os.path.join(root, "out")
        records, counts, wall = cli_run(flags + world(), out, "nccl_world_1")
        assert not dist.is_initialized(), "the CLI left its process group up"
        assert backends == [("nccl", 1)], backends
        steps, evals = cli_counts(records, TRAIN_BATCH, EXTRAS_DATA["n"])
        test = next(r for r in records if r["kind"] == "test")
        check_step_counts(counts, steps, eval_batches=evals)
        assert math.isfinite(test["loss"]), test
        best = os.path.join(out, "nccl_world_1", "best_model")
        probe, probe_counts, probe_s = cli_run(flags + world(), out, "probe",
                                               ["--only_test", "--load_path", best])
        probe_test = next(r for r in probe if r["kind"] == "test")
        assert probe_test["loss"] == test["loss"], (probe_test["loss"], test["loss"])
        assert backends[1:] == [("nccl", 1)], backends
        for n in counts:
            counts[n] += probe_counts[n]
        result.update(wall_s=wall, steps=steps, eval_batches=evals, test_loss=test["loss"],
                      probe_test_loss=probe_test["loss"], probe_s=probe_s,
                      samples_per_s=next(r for r in records
                                         if r["kind"] == "summary")["samples_per_sec"])
        log(f"[train_cli_mp] the CLI as a world of one under NCCL: {steps} steps, {evals} eval "
            f"batches in {wall:.1f} s; K1/K2/K3 {counts}; test loss {test['loss']:.6f}, the "
            f"restore probe's {probe_test['loss']:.6f} (equal)")
        if torch.cuda.device_count() >= 2:
            port = free_port()
            procs = [subprocess.Popen(
                [sys.executable, "-m", "d2r_tpu_torch.cli"] + flags + [
                    "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
                    "--process_id", str(r), "--save_path", os.path.join(out, "nccl_dp2")],
                text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for r in range(2)]
            outs = [p.communicate(timeout=600)[0] for p in procs]
            assert all(p.returncode == 0 for p in procs), outs[0][-3000:] + outs[1][-3000:]
            result["nccl_dp2"] = "ran"
            log("[train_cli_mp] NCCL dp = 2 on two cards: ran")
        else:
            result["nccl_dp2"] = "not run: one card"
            log("[train_cli_mp] NCCL dp = 2: not run, this machine has one card")
        return counts
    finally:
        distributed.initialize = initialize
        shutil.rmtree(root, ignore_errors=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    import d2r_tpu_torch  # noqa: F401  (fails when run outside the repo)

    t_start = time.perf_counter()
    report = {"card": card_line()}
    log(f"[card] {report['card']}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    paths = {}   # launch counts of each path's run, by phase
    phases = [("build", phase_build), ("kernels", phase_kernels), ("k3", phase_k3),
              ("step_kernels", phase_step_kernels), ("export_start", phase_export_start)]
    for key in MODELS:
        suffix = MODELS[key]["suffix"]
        phases += [("main_path" + suffix, lambda r, k=key: phase_main_path(r, k)),
                   ("card_vs_cpu" + suffix, lambda r, k=key: phase_card_vs_cpu(r, k)),
                   ("train" + suffix, lambda r, k=key: phase_train(r, k)),
                   ("train_card_vs_cpu" + suffix,
                    lambda r, k=key: phase_train_card_vs_cpu(r, k))]
    phases.append(("train_cli", phase_train_cli))
    phases.append(("serve_http", phase_serve_http))
    phases.append(("mesh_start", phase_mesh_start))
    phases += [("pretrained", phase_pretrained), ("train_scaled", phase_train_scaled),
               ("serve_export", phase_serve_export),
               ("card_vs_cpu_alpha", lambda r: phase_card_vs_cpu(r, "base", alpha=CCR_ALPHA))]
    phases += [("train_sentic", phase_sentic), ("train_int8", phase_int8)]
    phases += [("train_dp", phase_train_dp), ("train_tp", phase_train_tp),
               ("train_cli_mp", phase_train_cli_mp), ("train_pp", phase_train_pp),
               ("serve_mesh", phase_serve_mesh), ("train_extras", phase_extras_collect)]
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

    for proc in STARTED:          # one that a failed phase left running
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    report["total_s"] = time.perf_counter() - t_start
    log(f"[total] every phase in {report['total_s']:.1f} s")
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
    launches = {n: sum(c.get(n, 0) for c in paths.values()) for n in counters()}
    step_kernels = report["step_kernels"]["kernels_line"]
    # W8A16 at the FFN-in site of bucket 1 in bf16; the quantize and rescale
    # kernels at the FFN shape in bf16 (their outputs equal the plain
    # versions' bit for bit in every check, so their error is 0)
    w8 = next(r for r in report["w8a16_sites"]
              if (r["site"], r["bucket"], r["dtype"]) == ("ffn_in", 1, "bfloat16"))
    quant_timed = report["int8"]["kernels"]["timed"]
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
         "max_abs_err": max(r["max_abs_err"] for r in report["k3_sites"]), **row(k3)},
        {"name": "adamw", "route": "cuda", "source": "d2r_tpu_torch/csrc/adamw.cu",
         "replaces": "none: d2r_tpu/train/optimizer.py:112,181 (fused_adamw, fused_leaf_adamw;"
                     " XLA fusions, no pl.pallas_call)",
         "launches": launches["adamw"],
         "max_abs_err": max(r["max_abs_err"] for r in report["step_kernels"]["adamw"]),
         **row({**step_kernels["adamw"], "ms": step_kernels["adamw"]["kernel_ms"]})},
        {"name": "hidden_dropout", "route": "cuda", "source": "d2r_tpu_torch/csrc/dropout.cu",
         "replaces": "none: d2r_tpu/models/bert.py:99,144,173 (nn.Dropout, jax.random;"
                     " no pl.pallas_call)",
         "launches": launches["dropout"],
         "max_abs_err": max(r["max_abs_err"] for r in report["step_kernels"]["dropout"]),
         **row({**step_kernels["dropout"], "ms": step_kernels["dropout"]["kernel_ms"]})},
        {"name": "w8a16_linear", "route": "cuda", "source": "d2r_tpu_torch/csrc/w8a16_linear.cu",
         "replaces": "none: d2r_tpu/quant.py:37,91 (QuantLeaf.dequant, which XLA fuses into"
                     " the consuming dot; no pl.pallas_call)",
         "launches": launches["w8a16"],
         "max_abs_err": max(r["max_abs_err"] for r in report["w8a16_sites"]), **row(w8)},
        *({"name": name, "route": "cuda", "source": "d2r_tpu_torch/csrc/quantize.cu",
           "replaces": "none: d2r_tpu/ops/qdot.py:58,70 (_quantize and _int8_matmul's rescale,"
                       " XLA fusions around lax.dot_general; no pl.pallas_call)",
           "launches": launches[name], "max_abs_err": quant_timed[name]["max_abs_err"],
           **row(quant_timed[name])} for name in ("quantize_rows", "quantize_cols", "rescale"))]}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
