"""Command-line entry point for experiments (counterpart of ``d2r_tpu/cli.py``).

    python -m d2r_tpu_torch.cli --train_json ... --img_dir ... [flags]

The JAX package's flags with its defaults, except ``--device``, which is
``cuda`` (the port's kernels) unless ``cpu`` (the plain PyTorch path) is
asked for; without a GPU ``cuda`` raises. It trains, evaluates on dev every
epoch, saves the best dev weighted-F1 model under ``save_path/best_model``
with ``config.json`` beside it, and tests it; ``--only_test --load_path
<best_model>`` tests a saved model.

``--dry_run`` builds the model and train state on the device, runs one
real train step on ``synthetic_batch`` and prints one JSON line with the
JAX package's keys (:func:`_dry_run`).

Every flag the port cannot honour yet (the parallel ones) raises
``NotImplementedError`` naming the flag and the ROADMAP.md item that ports
it: those without a config field here (:data:`REFUSED`), the others in
``D2RConfig.check_supported``, which the trainer and the model also call.
None is accepted and then ignored.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict

import numpy as np
import torch

from d2r_tpu_torch.config import D2RConfig, resolve_device

logger = logging.getLogger(__name__)

_PARALLEL = "Queue 1 item 9 (parallel)"
# (flag, test of the parsed args that the flag is in use, the ROADMAP.md
# item that ports it): the flags with no config field; those with one are
# refused by D2RConfig.check_supported (config.UNPORTED)
REFUSED = (
    ("--coordinator_address", lambda a: a.coordinator_address is not None, _PARALLEL),
    ("--num_processes", lambda a: a.num_processes is not None, _PARALLEL),
    ("--process_id", lambda a: a.process_id is not None, _PARALLEL),
)


def refuse_unsupported(args) -> None:
    """Raise ``NotImplementedError`` naming every flag of :data:`REFUSED` in
    use, and ``--no_pallas`` off the CPU: the card has no path without the
    kernels, and the port hides none behind a flag."""
    bad = [f"{flag} (ROADMAP.md {item})" for flag, used, item in REFUSED if used(args)]
    if args.no_pallas and args.device != "cpu":
        bad.append("--no_pallas off the CPU (the card runs the kernels; "
                   "--device cpu runs the plain path)")
    if bad:
        raise NotImplementedError("d2r_tpu_torch.cli does not support " + ", ".join(bad)
                                  + " yet")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # --- the reference's flags ---
    p.add_argument("--bert_name", default="bert-base-uncased", type=str)
    p.add_argument("--vit_name", default="clip-vit-base-patch32", type=str)
    p.add_argument("--num_epochs", default=30, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the kernels) or cpu (the plain PyTorch path)")
    p.add_argument("--batch_size", default=32, type=int)
    p.add_argument("--lr", default=3e-5, type=float)
    p.add_argument("--warmup_ratio", default=0.01, type=float)
    p.add_argument("--eval_begin_epoch", default=1, type=int)
    p.add_argument("--seed", default=2023, type=int)
    p.add_argument("--load_path", default=None, type=str)
    p.add_argument("--save_path", default="./output/", type=str)
    p.add_argument("--write_path", default=None, type=str)
    p.add_argument("--notes", default="", type=str)
    p.add_argument("--do_train", action="store_true", default=True)
    p.add_argument("--only_test", action="store_true")
    p.add_argument("--max_seq", default=128, type=int)
    p.add_argument("--ignore_idx", default=0, type=int)
    p.add_argument("--sample_ratio", default=1.0, type=float)
    p.add_argument("--alpha", default=0.0, type=float, help="CCR")
    p.add_argument("--margin", default=0.1, type=float, help="CCR")
    p.add_argument("--beta", default=0.1, type=float)
    p.add_argument("--mild_margin", default=0.7, type=float)
    p.add_argument("--hetero", default=0.9, type=float)
    p.add_argument("--homo", default=0.9, type=float)
    p.add_argument("--DR_step", default=3, type=int)
    p.add_argument("--weight_js_1", default=0.1, type=float)
    p.add_argument("--weight_js_2", default=0.1, type=float)
    p.add_argument("--weight_diff", default=0.1, type=float)
    p.add_argument("--embed_size", default=768, type=int)
    p.add_argument("--num_head_IMRC", default=16, type=int)
    p.add_argument("--hid_IMRC", default=768, type=int)
    p.add_argument("--raw_feature_norm_CMRC", default="clipped_l2norm")
    p.add_argument("--lambda_softmax_CMRC", default=4.0, type=float)
    p.add_argument("--hid_router", default=768, type=int)
    p.add_argument("--num_classes", default=None, type=int,
                   help="classifier width; default 3 (2 for --dataset hfm)")
    # --- dataset locations ---
    p.add_argument("--dataset", default="mvsa-single",
                   choices=["mvsa-single", "mvsa-multiple", "hfm", "custom"])
    p.add_argument("--data_dir", default="data", type=str)
    p.add_argument("--train_json", default=None, type=str)
    p.add_argument("--dev_json", default=None, type=str)
    p.add_argument("--test_json", default=None, type=str)
    p.add_argument("--img_dir", default=None, type=str)
    # --- the JAX package's flags; REFUSED lists those the port cannot honour ---
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--no_pallas", action="store_true",
                   help="the JAX package's einsum attention; here only with "
                        "--device cpu, whose plain path is the only one")
    p.add_argument("--remat", action="store_true",
                   help="rematerialise each tower layer in the backward")
    p.add_argument("--mesh_data", default=-1, type=int,
                   help="data-parallel axis size (-1 = all devices; the port "
                        "trains on one, and refuses any size but -1 and 1)")
    p.add_argument("--mesh_model", default=1, type=int,
                   help="tensor-parallel axis size (refused)")
    p.add_argument("--mesh_stage", default=1, type=int,
                   help="pipeline-parallel axis size (refused)")
    p.add_argument("--pipeline_microbatches", default=0, type=int,
                   help="microbatches per batch for --mesh_stage (refused)")
    p.add_argument("--mesh_topology", action="store_true",
                   help="order mesh axes along the interconnect (refused)")
    # multi-process training (refused: the port trains on one device)
    p.add_argument("--coordinator_address", default=None, type=str,
                   help="host:port of process 0")
    p.add_argument("--num_processes", default=None, type=int, help="world size")
    p.add_argument("--process_id", default=None, type=int,
                   help="this process's rank in [0, num_processes)")
    p.add_argument("--num_workers", default=16, type=int)
    p.add_argument("--pretrained_dir", default=None, type=str,
                   help="dir with bert.pt and clip_vit.pt, the towers' HF state "
                        "dicts (d2r_tpu_torch/utils/weights.py)")
    p.add_argument("--debug_nans", action="store_true",
                   help="raise FloatingPointError at the first step whose loss "
                        "or any gradient is not finite, naming the step and "
                        "the parameter")
    p.add_argument("--profile_dir", default=None, type=str,
                   help="write a torch.profiler trace of the second dispatch "
                        "to this directory (trace.json)")
    p.add_argument("--cleanup_output", action="store_true",
                   help="reference behaviour: delete save_path after test")
    p.add_argument("--save_opt_state", action="store_true",
                   help="checkpoint the optimizer and schedule state too")
    p.add_argument("--auto_resume", action="store_true",
                   help="write a full-state checkpoint every epoch under "
                        "save_path/resume/ and continue an interrupted run "
                        "from it bit-exactly (rerun the same command)")
    p.add_argument("--patience", default=0, type=int,
                   help="stop early when dev F1 has not improved for N "
                        "evaluated epochs (0 = train all epochs)")
    p.add_argument("--metrics_jsonl", default=None, type=str,
                   help="append per-window/eval/summary metrics as JSON "
                        "lines to this file")
    p.add_argument("--dry_run", action="store_true",
                   help="validate the config without data: build the model "
                        "and train state, run ONE real train step on a "
                        "synthetic batch, print a JSON line with the "
                        "parameter count and the step's FLOPs, then exit")
    p.add_argument("--freeze_towers", action="store_true",
                   help="linear-probe mode: freeze the pretrained text and "
                        "vision towers; train only the routing fabric, "
                        "fusion head, and classifier")
    p.add_argument("--tensorboard_dir", default=None, type=str,
                   help="write TensorBoard event files (train loss and "
                        "dev/test metrics)")
    p.add_argument("--use_sentic_graph", action="store_true",
                   help="enable SenticNet affective-graph GCN refinement")
    p.add_argument("--sentic_lexicon", default=None, type=str,
                   help="path to senticnet_word.txt (default: the port's "
                        "copy, d2r_tpu_torch/data/assets/)")
    p.add_argument("--steps_per_dispatch", default=16, type=int,
                   help="train steps a dispatch: their batches are stacked "
                        "and their losses fetched together")
    p.add_argument("--grad_accum_steps", default=1, type=int,
                   help="average grads over K microbatches per optimizer "
                        "step (effective batch K*batch_size at one "
                        "microbatch's activation memory)")
    p.add_argument("--optimizer_impl", default="grouped",
                   choices=["grouped", "fused", "fused_leaf", "multi_transform"],
                   help="the JAX package's four lowerings of one 4-group "
                        "AdamW; all four are that AdamW here")
    p.add_argument("--adam_mu_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="Adam first-moment storage (bfloat16 with "
                        "--optimizer_impl grouped only, as in the JAX package)")
    p.add_argument("--scan_layers", action="store_true",
                   help="the JAX package's scanned tower layout for weights "
                        "and checkpoints (the towers run the same loop)")
    p.add_argument("--seq_shard", action="store_true",
                   help="sequence parallelism (refused)")
    p.add_argument("--fabric_shard", action="store_true",
                   help="fabric work-sharing under tensor parallelism (refused)")
    p.add_argument("--async_checkpoint", action="store_true",
                   help="overlap best-model checkpoint writes with the next "
                        "epoch's compute (awaited before the test reload)")
    p.add_argument("--cache_items", action="store_true",
                   help="memoise finished dataset items in RAM so epochs "
                        ">=2 skip all host-side tokenise/decode work "
                        "(~image_size^2*3 bytes/item at the uint8 default)")
    p.add_argument("--pixel_transfer", default="uint8",
                   choices=["uint8", "float32"],
                   help="image host->device format: uint8 ships raw resized "
                        "pixels (4x fewer bytes, normalised on device), "
                        "float32 = host-side CLIP normalisation")
    p.add_argument("--prng_impl", default="rbg",
                   choices=["rbg", "threefry2x32"],
                   help="the JAX package's dropout bit generator; the port "
                        "draws Philox4x32-10 bits under either name (one card "
                        "has no sharding for threefry's bits to be stable across)")
    p.add_argument("--quant_train", default="none",
                   choices=["none", "int8", "int8_all"],
                   help="run the projection products as int8 x int8 -> int32 "
                        "(dynamic symmetric scales, straight-through backward; "
                        "int8_all also quantizes the two backward products). "
                        "Not the reference's numerics")
    return p


def dataset_paths(args) -> Dict[str, str]:
    """The reference's dataset path conventions."""
    if args.train_json:
        return {"train": args.train_json, "dev": args.dev_json,
                "test": args.test_json, "img": args.img_dir}
    d = args.data_dir
    if args.dataset == "mvsa-single":
        base = os.path.join(d, "MVSA-single", "10-flod-1")
        img = os.path.join(d, "MVSA-single", "MVSA_Single", "data")
    elif args.dataset == "mvsa-multiple":
        base = os.path.join(d, "MVSA-multiple", "10-flod-1")
        img = os.path.join(d, "MVSA-multiple", "MVSA", "data")
    else:  # hfm
        base = os.path.join(d, "HFM")
        img = os.path.join(d, "HFM", "dataset_image")
    dev = "valid.json" if args.dataset == "hfm" else "dev.json"
    return {"train": os.path.join(base, "train.json"),
            "dev": os.path.join(base, dev),
            "test": os.path.join(base, "test.json"),
            "img": img}


def config_from_args(args) -> D2RConfig:
    """The JAX package's mapping of flags to config fields, field for
    field (the mesh axes in ("data", "stage", "model") order, size-1 axes
    dropped), so that ``config.json`` reads the same in both packages."""
    mesh_shape, axis_names = [args.mesh_data], ["data"]
    if args.mesh_stage > 1:
        mesh_shape.append(args.mesh_stage)
        axis_names.append("stage")
    if args.mesh_model > 1:
        mesh_shape.append(args.mesh_model)
        axis_names.append("model")
    if args.num_classes is not None:
        num_classes = args.num_classes
    else:
        num_classes = 2 if args.dataset == "hfm" else 3   # HFM sarcasm is binary
    return D2RConfig(
        num_classes=num_classes,
        bert_name=args.bert_name, vit_name=args.vit_name,
        num_epochs=args.num_epochs, device=args.device,
        batch_size=args.batch_size, lr=args.lr,
        warmup_ratio=args.warmup_ratio, eval_begin_epoch=args.eval_begin_epoch,
        seed=args.seed, load_path=args.load_path, save_path=args.save_path,
        write_path=args.write_path, notes=args.notes, do_train=args.do_train,
        only_test=args.only_test, max_seq=args.max_seq,
        ignore_idx=args.ignore_idx, sample_ratio=args.sample_ratio,
        alpha=args.alpha, margin=args.margin, beta=args.beta,
        mild_margin=args.mild_margin, hetero=args.hetero, homo=args.homo,
        DR_step=args.DR_step, weight_js_1=args.weight_js_1,
        weight_js_2=args.weight_js_2, weight_diff=args.weight_diff,
        embed_size=args.embed_size, num_head_IMRC=args.num_head_IMRC,
        hid_IMRC=args.hid_IMRC,
        raw_feature_norm_CMRC=args.raw_feature_norm_CMRC,
        lambda_softmax_CMRC=args.lambda_softmax_CMRC,
        hid_router=args.hid_router,
        save_opt_state=args.save_opt_state,
        auto_resume=args.auto_resume,
        patience=args.patience,
        metrics_jsonl=args.metrics_jsonl,
        tensorboard_dir=args.tensorboard_dir,
        freeze_towers=args.freeze_towers,
        use_sentic_graph=args.use_sentic_graph,
        sentic_lexicon_path=args.sentic_lexicon,
        compute_dtype=args.compute_dtype,
        use_pallas=not args.no_pallas, remat=args.remat,
        mesh_shape=tuple(mesh_shape), mesh_axis_names=tuple(axis_names),
        debug_nans=args.debug_nans, profile_dir=args.profile_dir,
        steps_per_dispatch=args.steps_per_dispatch,
        grad_accum_steps=args.grad_accum_steps,
        optimizer_impl=args.optimizer_impl,
        adam_mu_dtype=args.adam_mu_dtype,
        prng_impl=args.prng_impl,
        quant_train=args.quant_train,
        pixel_transfer=args.pixel_transfer,
        cache_items=args.cache_items,
        async_checkpoint=args.async_checkpoint,
        scan_layers=args.scan_layers,
        seq_shard=args.seq_shard,
        fabric_shard=args.fabric_shard,
        pipeline_stages=args.mesh_stage,
        pipeline_microbatches=args.pipeline_microbatches,
        mesh_topology=args.mesh_topology,
    )


def _count_int_mm(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """torch.utils.flop_counter's formula for ``torch._int_mm`` (it has none):
    2 m k n, at the padded shape the product runs at."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


def _dry_run(cfg: D2RConfig, device: torch.device) -> Dict:
    """``--dry_run``: the model and train state on ``device``, ONE real train
    step on ``synthetic_batch`` (plus the JAX package's random adjacency
    when ``use_sentic_graph`` is on, so the GCN runs), and one JSON line with
    the JAX package's keys. The port has no compiler cost model:
    ``flops_per_step`` is the FLOPs of the step's products (matrix products,
    convolutions, the int8 products at their padded shapes) that
    ``torch.utils.flop_counter`` counts over the step, plus those of the
    attention kernels' launches (K1, K2, K3), which it cannot see; on the
    CPU the attention's plain version is counted by the counter itself.
    Elementwise work is not counted. ``bytes_accessed_per_step`` is null."""
    from torch.utils.flop_counter import FlopCounterMode, flop_registry, register_flop_formula

    from d2r_tpu_torch.data.dataset import synthetic_batch
    from d2r_tpu_torch.ops.kernels.flash_attention import flash_attention
    from d2r_tpu_torch.ops.kernels.fused_attention import (
        fused_attention_small,
        fused_attention_small_bwd,
    )
    from d2r_tpu_torch.train.state import create_train_state, make_train_step

    if torch.ops.aten._int_mm not in flop_registry:
        register_flop_formula(torch.ops.aten._int_mm)(_count_int_mm)
    vc = cfg.vision_config()
    batch = synthetic_batch(cfg.batch_size, cfg.max_seq, vc.image_size,
                            vocab_size=cfg.text_config().vocab_size, seed=0)
    if cfg.use_sentic_graph:
        batch["sentic_adj"] = np.random.RandomState(1).uniform(
            0.0, 2.0, size=(cfg.batch_size, cfg.max_seq, cfg.max_seq)).astype(np.float32)
    state = create_train_state(cfg, total_steps=max(cfg.num_epochs, 1), device=device,
                               seed=cfg.seed)
    kernels = (fused_attention_small, fused_attention_small_bwd, flash_attention)
    for k in kernels:
        k.flops = 0
    with FlopCounterMode(display=False) as counter:
        state, metrics = make_train_step(cfg.debug_nans)(state, batch, cfg.seed + 1)
    loss = float(metrics["loss"])
    line = {
        "dry_run": True,
        "params": sum(p.numel() for p in state.model.parameters()),
        "flops_per_step": counter.get_total_flops() + sum(k.flops for k in kernels),
        "bytes_accessed_per_step": None,
        "devices": 1,
        "mesh": {"data": 1},
        "batch_size": cfg.batch_size,
        "max_seq": cfg.max_seq,
        "compute_dtype": cfg.compute_dtype,
    }
    print(json.dumps(line), flush=True)
    logger.info("dry run OK: one step on %s, loss %.5f", device, loss)
    return line


def main(argv=None) -> None:
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s -   %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO)
    args = build_arg_parser().parse_args(argv)
    refuse_unsupported(args)
    cfg = config_from_args(args)
    cfg.check_supported()
    device = resolve_device(args.device)
    logger.info(args)

    # the reference seeds numpy and torch; the port's init, shuffle and
    # dropout draw from generators of their own, seeded from cfg.seed
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)

    if args.dry_run:
        return _dry_run(cfg, device)

    if cfg.save_path is not None:
        os.makedirs(cfg.save_path, exist_ok=True)

    paths = dataset_paths(args)
    from d2r_tpu_torch.data.dataset import DataLoader, MSDDataset, MSDProcessor
    from d2r_tpu_torch.data.sentic import load_sentic_lexicon
    from d2r_tpu_torch.train import checkpoint as ckpt
    from d2r_tpu_torch.train.trainer import Trainer

    processor = MSDProcessor({k: paths[k] for k in ("train", "dev", "test")},
                             cfg.bert_name, vocab_size=cfg.text_config().vocab_size)
    vc = cfg.vision_config()
    # the port's own lexicon unless --sentic_lexicon names another
    lexicon = load_sentic_lexicon(cfg.sentic_lexicon_path) if cfg.use_sentic_graph else None
    mk = lambda mode: MSDDataset(
        processor, paths["img"], max_seq=cfg.max_seq, mode=mode,
        image_size=vc.image_size, num_vision_tokens=vc.num_tokens,
        sample_ratio=cfg.sample_ratio if mode == "train" else 1.0,
        pixel_transfer=cfg.pixel_transfer, cache_items=cfg.cache_items,
        sentic_lexicon=lexicon)
    train_loader = DataLoader(mk("train"), cfg.batch_size, shuffle=True,
                              num_workers=args.num_workers, seed=cfg.seed)
    dev_loader = DataLoader(mk("dev"), cfg.batch_size, shuffle=False,
                            num_workers=max(args.num_workers // 2, 1))
    test_loader = DataLoader(mk("test"), cfg.batch_size, shuffle=False,
                             num_workers=max(args.num_workers // 2, 1))

    trainer = Trainer(train_data=train_loader, dev_data=dev_loader,
                      test_data=test_loader, cfg=cfg, logger=logger,
                      cleanup_output=args.cleanup_output, device=device)
    if args.pretrained_dir:
        # into the live parameters, after the optimizer exists and before
        # the first step (d2r_tpu/cli.py:412-419)
        from d2r_tpu_torch.utils.weights import load_pretrained_params
        trainer.init_state()
        load_pretrained_params(args.pretrained_dir, trainer.state.model)
        logger.info("Loaded pretrained towers from %s", args.pretrained_dir)
    try:
        if cfg.only_test:
            if cfg.load_path:
                ckpt.check_checkpoint_geometry(cfg.load_path, cfg)
            if trainer.state is None:
                trainer.init_state()
            if cfg.load_path:
                ckpt.restore_checkpoint(cfg.load_path, trainer.state)
            trainer.test(0)
        elif cfg.do_train:
            trainer.train()
    finally:
        ckpt.wait_for_async_saves()     # --async_checkpoint: durable before exit


if __name__ == "__main__":
    main()
