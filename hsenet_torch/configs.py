"""Typed configuration for the PyTorch port.

The port's own copy of the dataclasses its paths need from the JAX
package's `configs.py`, with the same fields, defaults and derived
properties, so one configuration describes the same model in both packages.
Fields of the JAX copy that the port has no use for are left out:
`ViT3DConfig.attn_block_q` (a TPU VMEM block size).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


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
class SwinConfig:
    """Hierarchical 3D Swin encoder, SegVol's other image encoder:
    windowed attention with a relative position bias, shifted windows every
    other block, patch merging between stages. The defaults give SegVol's
    (4,16,16) x 768 feature grid from (32,256,256) volumes: patch (2,4,4)
    -> (16,64,64) at 192, two merges -> (4,16,16) at 768."""

    in_channels: int = 1
    image_size: Tuple[int, int, int] = (32, 256, 256)
    patch_size: Tuple[int, int, int] = (2, 4, 4)
    embed_dim: int = 192
    window_size: Tuple[int, int, int] = (4, 4, 4)
    depths: Tuple[int, ...] = (2, 2, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    dropout_rate: float = 0.0
    patch_norm: bool = False
    gelu_approx: bool = False

    @property
    def grid(self) -> Tuple[int, int, int]:
        """The last stage's feature grid (each merge halves every axis)."""
        scale = 2 ** (len(self.depths) - 1)
        return tuple(
            i // p // scale for i, p in zip(self.image_size, self.patch_size)
        )  # type: ignore[return-value]

    @property
    def out_dim(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


@dataclass(frozen=True)
class ViT2DConfig:
    """2D ViT trunk (BiomedCLIP ViT-B/16) behind the (32, 768) slice
    features: 224x224 RGB slices in 16x16 patches -> 196 tokens + CLS."""

    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    mlp_dim: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    in_channels: int = 3

    @property
    def num_patches(self) -> int:
        g = self.image_size // self.patch_size
        return g * g


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
    # what a model built with remat=True keeps for the backward:
    #   "full": each block's input only, the block recomputed in full;
    #   "dots": also the outputs of the matrix products without a batch
    #   dimension (the projections), so only the rest is recomputed
    #   (`models.layers.checkpointed`)
    remat_policy: str = "full"

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
class LlamaConfig:
    """Llama-3-style decoder (the reference's `LamedLlamaForCausalLM`).
    Defaults are Llama-3-8B: vocab 128256, hidden 4096, intermediate 14336,
    32 layers, 32 q heads / 8 kv heads, head_dim 128, theta 500000, untied
    head. `models.llama.llama_as_phi3_config` maps it onto the Phi3
    decoder, int8 modes included."""

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    lora: Optional[LoRAConfig] = None
    quant_int8: bool = False
    quant_int8_embed: bool = False


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
    # optional SegVol branch (`seg_vision=None` is `vision` without CLS)
    # and in-graph 2D slice trunk (`models.vit.OnlineSliceFeatures`;
    # `vit2d=None` is `ViT2DConfig()`)
    seg_enable: bool = False
    seg_vision: Optional[ViT3DConfig] = None
    online_slice_features: bool = False
    vit2d: Optional[ViT2DConfig] = None
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
class MeshConfig:
    """Process mesh layout. dp: data parallel; tp: tensor parallel (LLM);
    pp: pipeline parallel (the LLM decoder's layers in stages); sp:
    sequence parallel (the tokens in chunks over a ring). pp and sp compose
    with dp only. dp = -1 means every process left over: world // (tp, pp
    or sp)."""

    dp: int = -1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    axis_names: Tuple[str, str] = ("dp", "tp")


@dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule and loop settings of a training run, with the JAX
    package's fields (a run's `run_config.json` has the same keys).
    `batch_size`, `dtype` and `remat` record what the CLI built; `zero1`
    is what `--zero1` set (`parallel/zero.py`). `device_prefetch` batches
    are placed on the device ahead of the step (`data.prefetch`); 0 places
    each batch as it comes."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    schedule: str = "cosine"  # cosine | constant
    total_steps: int = 10000
    batch_size: int = 24
    max_grad_norm: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    dtype: str = "bfloat16"
    remat: bool = False
    seed: int = 42
    log_every: int = 50
    eval_every: int = 500
    checkpoint_every: int = 1000
    zero1: bool = False
    device_prefetch: int = 2
    # torch.profiler trace of steps [profile_start, profile_stop) written to
    # profile_dir (Chrome/Perfetto-viewable); "" = off
    profile_dir: str = ""
    profile_start: int = 2
    profile_stop: int = 4


@dataclass(frozen=True)
class PreprocessConfig:
    """CT preprocessing (`data.preprocess`): HU = slope*raw + intercept,
    clamp to [hu_min, hu_max], resample to (1.5, 0.75, 0.75) mm, min-max
    normalise, crop the foreground (>0), resize to (32, 256, 256). The
    2D-slice path clamps to [slice_hu_min, slice_hu_max] and divides by
    |slice_hu_max| before picking `num_slices` slices of `slice_size`^2."""

    target_shape: Tuple[int, int, int] = (32, 256, 256)
    target_spacing: Tuple[float, float, float] = (1.5, 0.75, 0.75)
    hu_min: float = -1000.0
    hu_max: float = 200.0
    slice_hu_min: float = -1000.0
    slice_hu_max: float = 1000.0
    num_slices: int = 32
    slice_size: int = 224


@dataclass(frozen=True)
class AugmentConfig:
    """Train-time augmentation (`data.augment`): rot90 over (H, W), a flip
    of each spatial axis, intensity scale and shift, each with its
    probability."""

    rot90_prob: float = 0.5
    flip_prob: float = 0.10
    scale_intensity_prob: float = 0.5
    scale_intensity_factor: float = 0.1
    shift_intensity_prob: float = 0.5
    shift_intensity_offset: float = 0.1
