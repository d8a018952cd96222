"""Configuration for the PyTorch port.

A copy of ``d2r_tpu/config.py``'s dataclasses, presets and JSON loader, so
that a ``config.json`` written by the JAX package loads here unchanged. Every
field of the JAX config is kept, including those that mean nothing on this
path (``device``, ``use_pallas``): a checkpoint's config must load whole.
The mesh fields name the processes a run trains on (``parallel/mesh.py``);
a model is never split from them alone, so a checkpoint trained on a mesh
serves in one process. ``scan_layers`` sets only the layout of the JAX
weight trees the port reads and writes (``weights.py``);
``pipeline_stages`` and ``pipeline_microbatches`` set how the towers run
(``models/pipeline.py``) and that layout, not the port's parameters: a
pipelined checkpoint serves unpipelined (:func:`serving_config`).
:meth:`D2RConfig.check_supported` raises on the values the port cannot
honour yet.

Differences from the JAX package: :attr:`D2RConfig.dtype` is a
``torch.dtype``, and the port keeps its own copy of everything it needs.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import torch

from d2r_tpu_torch.ops.qdot import check_mode


@dataclasses.dataclass(frozen=True)
class TextEncoderConfig:
    """BERT-family text tower; defaults pin ``bert-base-uncased``."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # "absolute" (BERT) or "roberta" (HF RoBERTa position ids, derived from
    # the attention mask; rows 0..pad_token_id reserved)
    position_style: str = "absolute"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclasses.dataclass(frozen=True)
class VisionEncoderConfig:
    """CLIP-ViT vision tower; defaults pin ``openai/clip-vit-base-patch32``
    (224/32 -> 49 patches + CLS = 50 tokens)."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "quick_gelu"
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    attention_dropout: float = 0.0
    dropout: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:
        return self.num_patches + 1


def bert_base_config() -> TextEncoderConfig:
    return TextEncoderConfig()


def roberta_large_config() -> TextEncoderConfig:
    return TextEncoderConfig(
        vocab_size=50265,
        hidden_size=1024,
        num_hidden_layers=24,
        num_attention_heads=16,
        intermediate_size=4096,
        max_position_embeddings=514,
        type_vocab_size=1,
        layer_norm_eps=1e-5,
        pad_token_id=1,
        position_style="roberta",
    )


def clip_vit_b32_config() -> VisionEncoderConfig:
    return VisionEncoderConfig()


def clip_vit_l14_config() -> VisionEncoderConfig:
    return VisionEncoderConfig(
        hidden_size=1024,
        num_hidden_layers=24,
        num_attention_heads=16,
        intermediate_size=4096,
        patch_size=14,
    )


_TEXT_PRESETS = {
    "bert-base-uncased": bert_base_config,
    "roberta-large": roberta_large_config,
    "tiny-bert": lambda: TextEncoderConfig(
        vocab_size=128,
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=128,
        max_position_embeddings=64,
    ),
    "tiny-roberta": lambda: TextEncoderConfig(
        vocab_size=384,
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=128,
        max_position_embeddings=66,
        type_vocab_size=1,
        layer_norm_eps=1e-5,
        pad_token_id=1,
        position_style="roberta",
    ),
}
_VISION_PRESETS = {
    "clip-vit-base-patch32": clip_vit_b32_config,
    "openai/clip-vit-base-patch32": clip_vit_b32_config,
    "clip-vit-large-patch14": clip_vit_l14_config,
    "openai/clip-vit-large-patch14": clip_vit_l14_config,
    "tiny-vit": lambda: VisionEncoderConfig(
        hidden_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=128,
        image_size=32,
        patch_size=16,
    ),
}


def register_text_preset(name: str, factory) -> None:
    """Register a custom text-tower preset resolvable via ``bert_name``."""
    _TEXT_PRESETS[name] = factory


def register_vision_preset(name: str, factory) -> None:
    """Register a custom vision-tower preset resolvable via ``vit_name``."""
    _VISION_PRESETS[name] = factory


# The JAX package's four optimizer lowerings (d2r_tpu/train/optimizer.py,
# make_optimizer) compute one function, the reference's 4-group AdamW; the
# port has one implementation for all four names.
OPTIMIZER_IMPLS = ("grouped", "fused", "fused_leaf", "multi_transform")
# Adam first-moment storage types; the JAX package honours bfloat16 on the
# "grouped" path only, and so does the port (train/optimizer.py)
ADAM_MU_DTYPES = ("float32", "bfloat16")


# The JAX package's dropout bit generators (``--prng_impl``). The port draws
# Philox4x32-10 bits under either name, keyed on each element's global
# coordinates (batch row, head, position), so they are the same whatever
# the process mesh: what threefry2x32's sharding-stable bits give in JAX,
# both names give here, in one process and across many.
PRNG_IMPLS = ("rbg", "threefry2x32")


@dataclasses.dataclass(frozen=True)
class D2RConfig:
    """Full experiment config; field names and defaults are the JAX
    package's, which mirror the reference CLI flags."""

    # --- pretrained names ---
    bert_name: str = "bert-base-uncased"
    vit_name: str = "clip-vit-base-patch32"

    # --- training ---
    num_epochs: int = 30
    device: str = "tpu"
    batch_size: int = 32
    lr: float = 3e-5
    warmup_ratio: float = 0.01
    eval_begin_epoch: int = 1
    seed: int = 2023
    load_path: Optional[str] = None
    save_path: Optional[str] = "./output/"
    write_path: Optional[str] = None
    notes: str = ""
    do_train: bool = True
    only_test: bool = False
    max_seq: int = 128
    ignore_idx: int = 0
    sample_ratio: float = 1.0

    # --- CCR contrastive (alpha=0 disables it) ---
    alpha: float = 0.0
    margin: float = 0.1

    # --- SoftContrastiveLoss (unused on the live path) ---
    beta: float = 0.1
    mild_margin: float = 0.7
    hetero: float = 0.9
    homo: float = 0.9

    # --- dynamic routing ---
    DR_step: int = 3
    weight_js_1: float = 0.1
    weight_js_2: float = 0.1
    weight_diff: float = 0.1

    # --- model dims ---
    embed_size: int = 768
    num_head_IMRC: int = 16
    hid_IMRC: int = 768
    raw_feature_norm_CMRC: str = "clipped_l2norm"
    lambda_softmax_CMRC: float = 4.0
    hid_router: int = 768

    # --- hidden constants of the reference ---
    num_cells: int = 6
    path_hid: int = 128
    num_classes: int = 3
    fc_lr: float = 5e-2
    weight_decay: float = 1e-2
    router_bias_init: float = 1.5
    routing_threshold: float = 1e-4
    cma_temperature: float = 100.0

    # --- SenticNet affective graph ---
    use_sentic_graph: bool = False
    sentic_lexicon_path: Optional[str] = None

    # --- knobs of the JAX package (kept so its config.json loads) ---
    save_opt_state: bool = False
    auto_resume: bool = False
    patience: int = 0
    metrics_jsonl: Optional[str] = None
    freeze_towers: bool = False
    tensorboard_dir: Optional[str] = None
    async_checkpoint: bool = False
    cache_items: bool = False
    compute_dtype: str = "float32"
    use_pallas: bool = True
    remat: bool = False
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axis_names: Tuple[str, ...] = ("data",)
    mesh_topology: bool = False
    seq_shard: bool = False
    log_steps: int = 2
    debug_nans: bool = False
    profile_dir: Optional[str] = None
    steps_per_dispatch: int = 16
    grad_accum_steps: int = 1
    optimizer_impl: str = "grouped"
    adam_mu_dtype: str = "float32"
    prng_impl: str = "rbg"
    scan_layers: bool = False
    fabric_shard: bool = False
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    remat_ffn_act: bool = False
    pixel_transfer: str = "uint8"
    quant_train: str = "none"

    def text_config(self) -> TextEncoderConfig:
        key = self.bert_name.split("/")[-1]
        factory = _TEXT_PRESETS.get(key) or _TEXT_PRESETS.get(self.bert_name)
        if factory is None:
            raise ValueError(
                f"unknown text encoder preset {self.bert_name!r}; known: "
                f"{sorted(_TEXT_PRESETS)}")
        return factory()

    def vision_config(self) -> VisionEncoderConfig:
        key = self.vit_name.split("/")[-1]
        factory = _VISION_PRESETS.get(key) or _VISION_PRESETS.get(self.vit_name)
        if factory is None:
            raise ValueError(
                f"unknown vision encoder preset {self.vit_name!r}; known: "
                f"{sorted(_VISION_PRESETS)}")
        return factory()

    def model_axis_size(self) -> int:
        """The size of the ``model`` axis of ``mesh_shape`` (1 without one)."""
        return dict(zip(self.mesh_axis_names, self.mesh_shape)).get("model", 1)

    @property
    def dtype(self) -> torch.dtype:
        dt = getattr(torch, self.compute_dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        return dt

    def check_supported(self) -> None:
        """Raise on the values below, which the port cannot honour (it
        never ignores one silently), in one process and across many. An
        unknown ``quant_train`` mode raises the JAX package's
        ``ValueError``."""
        check_mode(self.quant_train)
        bad = []
        if self.prng_impl not in PRNG_IMPLS:
            bad.append(f"prng_impl={self.prng_impl!r}")
        if self.adam_mu_dtype not in ADAM_MU_DTYPES:
            bad.append(f"adam_mu_dtype={self.adam_mu_dtype!r}")
        if self.optimizer_impl not in OPTIMIZER_IMPLS:
            bad.append(f"optimizer_impl={self.optimizer_impl!r}")
        # the JAX package reads no CLIP hidden dropout (only
        # attention_dropout), so a non-zero one has no defined place
        if self.vision_config().dropout != 0.0:
            bad.append(f"vision dropout={self.vision_config().dropout}")
        if bad:
            raise NotImplementedError(
                "d2r_tpu_torch does not support " + ", ".join(bad)
                + " yet (see ROADMAP.md, Queue 1)")


def serving_config(cfg: D2RConfig) -> D2RConfig:
    """``cfg`` with its towers unpipelined: a pipelined checkpoint serves
    as one stack, as the JAX package's ``Predictor`` relayouts it
    (``d2r_tpu/serve.py:41-55``); the parameters are the same, and so is
    the math of an eval forward."""
    if cfg.pipeline_stages == 1 and cfg.pipeline_microbatches == 0:
        return cfg
    return dataclasses.replace(cfg, pipeline_stages=1, pipeline_microbatches=0)


def save_config_json(cfg: D2RConfig, path: str) -> None:
    """Write ``cfg`` as JSON, the JAX package's ``save_config_json`` format
    (which its ``load_config_json`` reads), so checkpoints describe their
    own geometry."""
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1, sort_keys=True)


def load_config_json(path: str) -> D2RConfig:
    """Read a ``config.json`` written by :func:`save_config_json` or the JAX
    package's. Unknown keys are dropped; tuple fields are coerced
    back from lists."""
    with open(path) as f:
        d = json.load(f)
    known = {f.name for f in dataclasses.fields(D2RConfig)}
    d = {k: v for k, v in d.items() if k in known}
    for t in ("mesh_shape", "mesh_axis_names"):
        if isinstance(d.get(t), list):
            d[t] = tuple(d[t])
    return D2RConfig(**d)


def tiny_test_config(**overrides) -> D2RConfig:
    """A miniature config for CPU unit tests: 2-layer towers, dim 64."""
    defaults = dict(
        bert_name="tiny-bert",
        vit_name="tiny-vit",
        batch_size=4,
        max_seq=16,
        embed_size=64,
        num_head_IMRC=4,
        hid_IMRC=64,
        hid_router=32,
        DR_step=3,
        compute_dtype="float32",
        use_pallas=False,
    )
    defaults.update(overrides)
    return D2RConfig(**defaults)


def resolve_device(device) -> torch.device:
    """The entry points' device check: a CUDA device with no GPU present
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "d2r_tpu_torch: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
