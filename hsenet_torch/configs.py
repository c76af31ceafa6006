"""Typed configuration for the PyTorch port.

The port's own copy of the dataclasses its paths need from the JAX
package's `configs.py`, with the same fields, defaults and derived
properties, so one configuration describes the same model in both packages.
Fields of the JAX copy that the port has no use for yet are left out:
`ViT3DConfig.attn_block_q` (a TPU VMEM block size),
`Phi3Config.remat_policy` (the port's `remat` recomputes each Phi block in
full, the JAX package's default "full" policy) and, in `TrainConfig`,
those of the CLI and of later slices (`batch_size`, `dtype`, `remat`,
`checkpoint_every`, `zero1`, `device_prefetch`, the device-trace window).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ViT3DConfig:
    """3D ViT encoder: (32,256,256) volumes, (4,16,16) patches -> 2048
    tokens, hidden 768, 12 layers x 12 heads (ViT-B)."""

    in_channels: int = 1
    image_size: Tuple[int, int, int] = (32, 256, 256)
    patch_size: Tuple[int, int, int] = (4, 16, 16)
    hidden_size: int = 768
    mlp_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    dropout_rate: float = 0.0
    qkv_bias: bool = False
    classification: bool = True  # adds a CLS token
    # 2E3 (stage-2) extras: slice-guided cross-attention + patch scoring
    slice_guided: bool = False
    slice_dropout_rate: float = 0.1
    num_slices: int = 32  # rows of the (32, 768) slice-feature matrix
    slice_feature_dim: int = 768
    # int8 W8A8 serving mode: the tower blocks' dense modules run int8 x
    # int8 -> int32 (models.lora.DenseW8A8), per-output-channel weight
    # scales; dynamic per-token activation scales, or with
    # quant_w8a8_static per-layer scales set by calibrate_w8a8_act_scales
    quant_w8a8: bool = False
    quant_w8a8_static: bool = False
    # tanh-approximate GELU in the block MLPs (exact erf by default)
    gelu_approx: bool = False

    @property
    def grid(self) -> Tuple[int, int, int]:
        return tuple(i // p for i, p in zip(self.image_size, self.patch_size))  # type: ignore[return-value]

    @property
    def num_patches(self) -> int:
        d, h, w = self.grid
        return d * h * w

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.classification else 0)

    @property
    def patch_dim(self) -> int:
        p0, p1, p2 = self.patch_size
        return p0 * p1 * p2 * self.in_channels


@dataclass(frozen=True)
class BertConfig:
    """BERT-base text encoder of the CLIP stages (post-LN, vocab 30522)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


@dataclass(frozen=True)
class CLIPConfig:
    """Dual-encoder CLIP (stage 1: 3D ViT + BERT; stage 2: the 2E3 tower).

    `scale_is_log=False` multiplies the learnable logit_scale in raw form
    (initialised to log(1/0.07), never exponentiated), as the reference
    does; True applies exp() like OpenAI CLIP."""

    vision: ViT3DConfig = field(default_factory=ViT3DConfig)
    text: BertConfig = field(default_factory=BertConfig)
    projection_dim: int = 768
    logit_scale_init: float = 2.6592600369327783  # log(1/0.07)
    scale_is_log: bool = False
    max_text_len: int = 128
    gather_loss: bool = True  # global (all-device) contrastive batch
    # stage-2 semantic-consistency regulation: weight 0.1 (1 - step/5000)
    relation_max_weighted_step: int = 5000
    relation_base_weight: float = 0.1


@dataclass(frozen=True)
class PackerConfig:
    """`VisualPacker_3d_phi_v3`: 2048 tokens viewed as an (8,16,16) grid,
    (1,4,4) windows -> 128 pooled queries, each cross-attending its window,
    then Linear-GELU-Linear into the LLM width."""

    grid: Tuple[int, int, int] = (8, 16, 16)
    kernel: Tuple[int, int, int] = (1, 4, 4)
    in_dim: int = 768
    out_dim: int = 3072
    dropout_rate: float = 0.1
    # {packer_v3, spatial_pooling, mlp, qformer, med2e3}
    projector_type: str = "packer_v3"
    pooling_size: int = 2  # for spatial_pooling baseline
    mlp_depth: int = 2
    num_queries: int = 32  # for the qformer ablation head

    @property
    def out_grid(self) -> Tuple[int, int, int]:
        return tuple(g // k for g, k in zip(self.grid, self.kernel))  # type: ignore[return-value]

    @property
    def proj_out_num(self) -> int:
        if self.projector_type == "qformer":
            return self.num_queries
        if self.projector_type == "mlp":
            a, b, c = self.grid
            return a * b * c
        a, b, c = self.out_grid
        return a * b * c

    @property
    def window_size(self) -> int:
        a, b, c = self.kernel
        return a * b * c


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA on all LLM linear layers (r=16, alpha=32)."""

    rank: int = 16
    alpha: int = 32
    dropout_rate: float = 0.05
    targets: Tuple[str, ...] = (
        "q_proj", "k_proj", "v_proj", "o_proj",
        "gate_proj", "up_proj", "down_proj",
    )

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@dataclass(frozen=True)
class Phi3Config:
    """Phi-3/Phi-4-mini decoder. Defaults are Phi-4-mini-instruct (~3.8B):
    hidden 3072, 32 layers, 24 q heads / 8 kv heads, head_dim 128, partial
    rotary factor 0.75, vocab 200064, tied embeddings."""

    vocab_size: int = 200064
    hidden_size: int = 3072
    intermediate_size: int = 8192
    num_layers: int = 32
    num_heads: int = 24
    num_kv_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 131072
    original_max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    partial_rotary_factor: float = 0.75
    # LongRoPE per-frequency divisors for short / long contexts
    rope_short_factor: Optional[Tuple[float, ...]] = None
    rope_long_factor: Optional[Tuple[float, ...]] = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    lora: Optional[LoRAConfig] = None
    # int8 weight-only projections (`LoRADense(quantized=True)`) and
    # embedding with its tied LM head (`QuantEmbed`)
    quant_int8: bool = False
    quant_int8_embed: bool = False

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.partial_rotary_factor)


@dataclass(frozen=True)
class VLMConfig:
    """HSENet VLM: dual vision tower + dual packers + Phi LLM. With
    dual_vits and parallel projectors the LLM sees 128+128=256 image
    tokens."""

    vision: ViT3DConfig = field(
        default_factory=lambda: ViT3DConfig(classification=True)
    )
    packer: PackerConfig = field(default_factory=PackerConfig)
    llm: Phi3Config = field(default_factory=Phi3Config)
    tower_mode: str = "dual_vits"  # dual_vits | 3d_vit | 2e3_vit | med2e3
    use_parallel_projector: bool = True
    select_feature: str = "patch"  # strip CLS before packing
    im_patch_token_id: int = -1
    seg_token_id: int = -1
    # optional SegVol branch and in-graph 2D slice trunk (later slices)
    seg_enable: bool = False
    seg_vision: Optional[ViT3DConfig] = None
    online_slice_features: bool = False
    vit2d: Optional[Any] = None
    stop_tower_gradients: bool = True

    @property
    def num_image_tokens(self) -> int:
        n = self.packer.proj_out_num
        if self.tower_mode == "dual_vits":
            return 2 * n
        if self.tower_mode == "med2e3":
            return n + self.vision.num_slices
        return n


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and loop settings of a training run."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    schedule: str = "cosine"  # cosine | constant
    total_steps: int = 10000
    max_grad_norm: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    seed: int = 42
    log_every: int = 50
    eval_every: int = 500
