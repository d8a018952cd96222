"""Serving export (counterpart of ``d2r_tpu/export.py``): each batch bucket's
forward as one ``torch.export`` program on disk.

The JAX package serializes ``jax.jit`` of each (batch bucket, seq) forward
as StableHLO; here each bucket's forward, the one ``serve.Predictor`` runs,
is traced once by ``torch.export.export`` and saved with
``torch.export.save``. A serving host loads the programs and runs them
through ``ExportedProgram.module()``, inside the same per-bucket CUDA graphs
that ``Predictor`` replays: the numerics are pinned by the artifact, not by
whatever model code is installed beside it.

Artifact layout (``export_predictor`` writes, ``load_exported`` reads)::

    out_dir/
      manifest.json            buckets, seq len, pixel dtype, torch version,
                               platforms, quantize, program filenames
      config.json              the D2RConfig (the trainer's writer)
      fwd_b{B}.{platform}.pt2  one ExportedProgram per (bucket, platform)

Notes:
  * A ``cuda`` program is exported on the card. Its attention sites are the
    kernels' ``torch.library`` custom ops (``d2r_torch::fused_attention_fwd``
    for K1, ``d2r_torch::flash_attention_fwd`` for K3), one node a site, and
    under ``--quantize int8`` each quantized product is the W8A16 op
    (``d2r_torch::w8a16_linear``), so the loaded program launches the port's
    kernels. A ``cpu`` program bakes
    the plain einsum attention in, as the JAX package's CPU-host export
    bakes the XLA path; a loader on the card refuses it rather than run it
    and bypass the kernels unseen. ``platforms=("cpu", "cuda")`` writes one
    program for each.
  * Parameters are NOT in the artifact: the program takes the predictor's
    parameters and buffers (after the compute cast; under ``quantize``, the
    int8 codes and scales) as a dict input, through
    ``torch.func.functional_call`` on a model that is not a submodule of the
    exported wrapper, and the example inputs are dropped before saving. So
    an artifact pairs with any checkpoint of the same geometry, and one of
    another geometry raises at call time.
  * Nothing here compiles the model: the program runs its ATen operations
    and the custom ops eagerly (``torch.compile`` and AOTInductor would
    generate kernels of their own in place of the port's).

Run it as ``python -m d2r_tpu_torch.export --load_path <best_model>
--out_dir <dir>`` (``--device cpu`` on a host without a card).
"""

from __future__ import annotations

import copy
import json
import logging
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from d2r_tpu_torch.config import D2RConfig, load_config_json, resolve_device, save_config_json
# the custom ops must be registered before torch.export.load reads a program
from d2r_tpu_torch.ops.kernels import flash_attention, fused_attention, w8a16  # noqa: F401
from d2r_tpu_torch.serve import Predictor, bucket_probs

logger = logging.getLogger(__name__)

_MANIFEST = "manifest.json"
_CONFIG = "config.json"
_MANIFEST_VERSION = 1
PLATFORMS = ("cpu", "cuda")


class _BucketForward(nn.Module):
    """The exported function: (tensors, input_ids, attention_mask,
    token_type_ids, pixel_values) -> fp32 probabilities. The model is held
    outside the module tree, so that none of its tensors is lifted into the
    program."""

    def __init__(self, model: nn.Module):
        super().__init__()
        object.__setattr__(self, "_model", model)

    def forward(self, tensors, input_ids, attention_mask, token_type_ids, pixel_values):
        return bucket_probs(self._model, input_ids, attention_mask, token_type_ids,
                            pixel_values, tensors=tensors)


def _example(cfg: D2RConfig, b: int, seq: int, pixel_dtype: np.dtype, device) -> tuple:
    vc = cfg.vision_config()
    ids = torch.zeros((b, seq), dtype=torch.int32, device=device)
    pixels = torch.zeros((b, vc.num_channels, vc.image_size, vc.image_size),
                         dtype=torch.from_numpy(np.zeros(0, pixel_dtype)).dtype, device=device)
    return ids, torch.ones_like(ids), torch.zeros_like(ids), pixels


def export_bucket(pred: Predictor, b: int, pixel_dtype) -> "torch.export.ExportedProgram":
    """The ``torch.export`` program of ``pred``'s forward at batch bucket
    ``b``, on ``pred``'s device, without example inputs."""
    args = (pred.tensors(),) + _example(pred.cfg, b, pred.seq_len, np.dtype(pixel_dtype),
                                        pred.device)
    # the nodes' Python stack traces are debugging metadata: without them a
    # trace takes about a quarter less time and a program half the bytes
    # (on a torch whose torch.fx.config has the switch)
    had = getattr(torch.fx.config, "do_not_emit_stack_traces", None)
    if had is not None:
        torch.fx.config.do_not_emit_stack_traces = True
    try:
        with torch.no_grad():
            ep = torch.export.export(_BucketForward(pred.model), args, strict=False)
    finally:
        if had is not None:
            torch.fx.config.do_not_emit_stack_traces = had
    ep.example_inputs = None      # they would carry every parameter into the file
    return ep


def _random_request(cfg: D2RConfig, b: int, seq: int, pixel_dtype: np.dtype):
    rng = np.random.default_rng(0)
    vc = cfg.vision_config()
    ids = rng.integers(0, cfg.text_config().vocab_size, (b, seq)).astype(np.int32)
    shape = (b, vc.num_channels, vc.image_size, vc.image_size)
    pix = (rng.integers(0, 256, shape).astype(np.uint8) if pixel_dtype == np.uint8
           else rng.normal(size=shape).astype(pixel_dtype))
    return ids, np.ones((b, seq), np.int32), np.zeros((b, seq), np.int32), pix


def export_predictor(
    cfg: D2RConfig,
    model: nn.Module,
    out_dir: str,
    batch_buckets: Sequence[int] = (1, 8, 32),
    pixel_dtype=np.uint8,
    platforms: Optional[Sequence[str]] = None,
    self_check: bool = True,
    quantize: Optional[str] = None,
) -> Dict:
    """Save one program per (batch bucket, platform); returns the manifest.

    ``model`` is a ``D2RClassifier(cfg)`` holding the weights (left as it
    is: each platform's predictor takes a copy). ``pixel_dtype`` must match
    what requests will carry (uint8 for the default clients).
    ``platforms=None`` exports for the card only (``("cuda",)``); a ``cuda``
    program needs the card. ``quantize='int8'`` bakes the weight-only int8 forward
    in: the program then takes the quantized tensors, and ``load_exported``
    quantizes the paired checkpoint the same way, as the manifest records.
    ``self_check`` reloads the artifact from disk and holds its
    probabilities at the smallest bucket to the live ``Predictor``'s on
    each platform: within 1e-6, labels equal."""
    platforms = list(platforms) if platforms else ["cuda"]
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"unknown platform {p!r}; the port exports for {PLATFORMS}")
        resolve_device(p)       # a cuda program is traced on the card
    pixel_dtype = np.dtype(pixel_dtype)
    os.makedirs(out_dir, exist_ok=True)
    files: Dict[str, Dict[str, str]] = {}
    preds = {}
    for p in platforms:
        pred = Predictor(cfg, copy.deepcopy(model), batch_buckets=batch_buckets,
                         device=p, quantize=quantize)
        preds[p] = pred
        for b in pred.batch_buckets:
            fname = f"fwd_b{b}.{p}.pt2"
            t0 = time.perf_counter()
            ep = export_bucket(pred, b, pixel_dtype)
            t1 = time.perf_counter()
            torch.export.save(ep, os.path.join(out_dir, fname))
            files.setdefault(str(b), {})[p] = fname
            logger.info("exported bucket %d for %s: trace %.2f s, save %.2f s, %d bytes",
                        b, p, t1 - t0, time.perf_counter() - t1,
                        os.path.getsize(os.path.join(out_dir, fname)))
    pred = preds[platforms[0]]
    vc = cfg.vision_config()
    manifest = {
        "version": _MANIFEST_VERSION,
        "seq_len": pred.seq_len,
        "batch_buckets": list(pred.batch_buckets),
        "num_classes": cfg.num_classes,
        "pixel_dtype": pixel_dtype.name,
        "pixel_shape": [vc.num_channels, vc.image_size, vc.image_size],
        "platforms": platforms,
        "torch_version": torch.__version__,
        "quantize": quantize,
        "files": files,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    save_config_json(cfg, os.path.join(out_dir, _CONFIG))

    if self_check:
        # the artifact must round-trip before anyone deploys it
        for p, live in preds.items():
            loaded = load_exported(out_dir, copy.deepcopy(model), device=p)
            request = _random_request(cfg, live.batch_buckets[0], live.seq_len, pixel_dtype)
            want, got = live.predict(*request), loaded.predict(*request)
            np.testing.assert_array_equal(got["label"], want["label"])
            np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-6, rtol=0)
    return manifest


class ExportedPredictor(Predictor):
    """``serve.Predictor`` whose bucket forwards come from disk.

    Inherits all the request plumbing (bucket choice, padding, chunking,
    staging, the per-bucket CUDA graphs, ``latency_stats``) but never runs
    the model's code: ``_program`` loads the bucket's exported program, which
    reads the predictor's tensors. ``model`` is None after construction."""

    def __init__(self, cfg: D2RConfig, model: nn.Module, manifest: Dict, artifact_dir: str,
                 device="cuda"):
        platform = resolve_device(device).type
        if platform not in manifest["platforms"]:
            raise ValueError(
                f"{artifact_dir} holds programs for {manifest['platforms']}, none for "
                f"{platform}" + (": a cpu program bakes the plain attention in and would "
                                 "bypass the kernels; export on the card (--device cuda)"
                                 if platform == "cuda" else ""))
        super().__init__(cfg, model, batch_buckets=manifest["batch_buckets"],
                         seq_buckets=(manifest["seq_len"],), device=device,
                         quantize=manifest.get("quantize"))
        self._tensors = super().tensors()
        self.model = None    # the artifact replaces the model's code
        self.quantize = manifest.get("quantize")
        self.manifest = manifest
        self._dir = artifact_dir
        self._pixel_dtype = torch.from_numpy(np.zeros(0, manifest["pixel_dtype"])).dtype
        # the loaded programs by bucket, read from disk at the bucket's first use
        self.programs: Dict[int, "torch.export.ExportedProgram"] = {}
        self._fns: Dict[int, Callable] = {}

    def tensors(self) -> Dict[str, torch.Tensor]:
        return self._tensors

    def warmup(self, pixel_dtype=None) -> None:
        """Load and prepare every bucket, for the artifact's own pixel dtype
        by default (the manifest pins it)."""
        super().warmup(pixel_dtype if pixel_dtype is not None
                       else np.dtype(self.manifest["pixel_dtype"]))

    def _program(self, b: int) -> Callable:
        if b not in self._fns:
            fname = self.manifest["files"][str(b)][self.device.type]
            self.programs[b] = torch.export.load(os.path.join(self._dir, fname))
            module = self.programs[b].module()

            def fwd(input_ids, attention_mask, token_type_ids, pixel_values):
                if pixel_values.dtype != self._pixel_dtype:
                    raise ValueError(
                        f"artifact was exported for pixel dtype {self.manifest['pixel_dtype']}, "
                        f"got {pixel_values.dtype}; re-export with --pixel matching the "
                        f"requests or convert the request")
                return module(self._tensors, input_ids, attention_mask, token_type_ids,
                              pixel_values)

            self._fns[b] = fwd
        return self._fns[b]


def load_exported(artifact_dir: str, model: nn.Module, device="cuda") -> ExportedPredictor:
    """Open an ``export_predictor`` directory with a checkpoint's model (a
    ``D2RClassifier`` of the artifact's geometry; the predictor takes
    ownership of it, as ``Predictor`` does)."""
    with open(os.path.join(artifact_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("version") != _MANIFEST_VERSION:
        raise ValueError(
            f"unsupported export manifest version {manifest.get('version')} in "
            f"{artifact_dir} (this build reads version {_MANIFEST_VERSION})")
    cfg = load_config_json(os.path.join(artifact_dir, _CONFIG))
    return ExportedPredictor(cfg, model, manifest, artifact_dir, device=device)


def main(argv=None):
    """``python -m d2r_tpu_torch.export``: checkpoint -> serving artifact."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--load_path", required=True,
                    help="checkpoint dir (e.g. .../best_model, holding model.pth)")
    ap.add_argument("--out_dir", required=True, help="artifact directory to write")
    ap.add_argument("--config_json", default=None,
                    help="training-time config.json (default: found inside or next to "
                         "--load_path)")
    ap.add_argument("--batch_buckets", default="1,8,32")
    ap.add_argument("--pixel", default="uint8", choices=["uint8", "float32"])
    ap.add_argument("--platforms", default=None,
                    help="comma list of programs to write, e.g. 'cpu,cuda' (default: "
                         "--device's only; a cuda program needs the card)")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="bake weight-only int8 serving into the artifact "
                         "(d2r_tpu_torch/quant.py); the loader quantizes the paired "
                         "checkpoint per the manifest")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--format", default="program", choices=["program", "torch"],
                    help="'program': the serving artifact of torch.export programs "
                         "(default; it takes the place of the JAX package's "
                         "'stablehlo'). 'torch': write <out_dir>/best_model.pth, the "
                         "reference's state_dict (utils/export_torch.py)")
    args = ap.parse_args(argv)
    logging.basicConfig(format="%(asctime)s - %(levelname)s - %(name)s -   %(message)s",
                        datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO)

    from d2r_tpu_torch.server import resolve_serve_config
    from d2r_tpu_torch.train.checkpoint import restore_model

    device = resolve_device(args.device)
    cfg = resolve_serve_config(args.load_path, config_json=args.config_json)
    model = restore_model(args.load_path, cfg, device)

    if args.format == "torch":
        from d2r_tpu_torch.utils.export_torch import save_reference_checkpoint
        from d2r_tpu_torch.weights import to_jax_variables
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "best_model.pth")
        sd = save_reference_checkpoint(path, to_jax_variables(model))
        print(json.dumps({"out_dir": args.out_dir, "format": "torch", "file": path,
                          "keys": len(sd)}))
        return
    manifest = export_predictor(
        cfg, model, args.out_dir,
        batch_buckets=tuple(int(b) for b in args.batch_buckets.split(",")),
        pixel_dtype=np.uint8 if args.pixel == "uint8" else np.float32,
        platforms=args.platforms.split(",") if args.platforms else [device.type],
        quantize=args.quantize)
    print(json.dumps({"out_dir": args.out_dir, "buckets": manifest["batch_buckets"],
                      "platforms": manifest["platforms"], "quantize": manifest["quantize"],
                      "self_check": "ok"}))


if __name__ == "__main__":
    main()
