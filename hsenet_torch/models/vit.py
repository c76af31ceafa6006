"""Vision encoders (the port of the JAX package's models/vit.py): ViT3D
(stage 1), its 2E3 slice-guided form (stage 2), the dual-encoder tower and
the 2D slice trunk, and the legacy masked-contrastive ViT.

  * `ViT3D`: patch embed -> [CLS | tokens] -> pre-LN blocks -> final LN.
  * slice-guided (2E3): patch embed -> single-head cross-attention from the
    patch tokens onto the per-slice features -> Linear(hidden->1)+Sigmoid
    per-patch score -> tokens *= score -> [CLS | tokens] -> the same tower.
  * `MaskedViT3D`: the full stream and a masked stream of the top-k
    slice-guided patches through one tower, the latter with its own final
    LayerNorm (the legacy masked CLIP).
  * `DualVisionTower`: both towers; strips CLS when select_feature is
    'patch'; `tower_mode` is dual_vits | 3d_vit | 2e3_vit.
  * `ViT2D`: the BiomedCLIP ViT-B/16 trunk (timm names, pre-LN, CLS) that
    turns 224x224 CLIP-normalised slices into the (32, 768) slice features;
    `OnlineSliceFeatures` runs it in-graph on a volume's resized slices.

The JAX package runs the tower as an `nn.scan` over stacked weights; here
it is an `nn.ModuleList` of blocks (`hsenet_torch.bridge` unstacks the
scanned weights). `remat=True` recomputes each block in the backward pass
(`models.layers.checkpointed`), as the JAX tower's `nn.remat` does.

`config.quant_w8a8` makes the blocks' dense modules the W8A8 serving dense
(`models.lora.DenseW8A8`; `quant_w8a8_static` with calibrated activation
scales). Patch embedding, the slice-guided cross-attention and attention
itself stay in the compute dtype, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.configs import ViT2DConfig, ViT3DConfig
from hsenet_torch.data.preprocess import clip_normalize, resize
from hsenet_torch.models.layers import (
    Dense,
    LayerNorm,
    PatchEmbed2D,
    PatchEmbed3D,
    SingleHeadCrossAttention,
    TransformerBlock,
    checkpointed,
)


class TransformerTower(nn.Module):
    """num_layers pre-LN blocks + final LayerNorm; with `remat` each block
    is recomputed in the backward pass."""

    def __init__(self, hidden: int, num_layers: int, num_heads: int,
                 mlp_dim: int, *, qkv_bias: bool = False,
                 dropout_rate: float = 0.0, gelu_approx: bool = False,
                 quant: bool = False, quant_static: bool = False,
                 dtype=torch.float32, device="cuda", remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.remat = remat
        self.blocks = nn.ModuleList(
            TransformerBlock(hidden, num_heads, mlp_dim, qkv_bias=qkv_bias,
                             dropout_rate=dropout_rate,
                             gelu_approx=gelu_approx, quant=quant,
                             quant_static=quant_static, dtype=dtype,
                             device=device)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(hidden, device=device)

    def forward(self, x: torch.Tensor, sp=None, *, deterministic: bool = True,
                skip_final_norm: bool = False) -> torch.Tensor:
        """The blocks, then the final LayerNorm unless `skip_final_norm`
        (the masked stream of `MaskedViT3D` applies its own); with `sp` (a
        `RingArgs`) x is this rank's token chunk and attention the ring."""
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = checkpointed(block, x, sp, deterministic=deterministic)
            else:
                x = block(x, sp, deterministic=deterministic)
        return x if skip_final_norm else self.norm(x)


class ViT3D(nn.Module):
    """Stage-1 3D ViT; with `config.slice_guided=True` the 2E3 encoder."""

    def __init__(self, config: ViT3DConfig, *, dtype=torch.float32,
                 device="cuda", remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.patch_embed = PatchEmbed3D(
            cfg.patch_size, cfg.in_channels, cfg.num_patches, cfg.hidden_size,
            dropout_rate=cfg.dropout_rate, dtype=dtype, device=device,
        )
        if cfg.slice_guided:
            self.slice_guided_attention = SingleHeadCrossAttention(
                cfg.hidden_size, dropout_rate=cfg.slice_dropout_rate,
                dtype=dtype, device=device,
            )
            self.patch_score_proj = Dense(
                cfg.hidden_size, 1, dtype=torch.float32, device=device
            )
        if cfg.classification:
            self.cls_token = nn.Parameter(
                torch.zeros(1, 1, cfg.hidden_size, device=device)
            )
        self.tower = TransformerTower(
            cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.mlp_dim,
            qkv_bias=cfg.qkv_bias, dropout_rate=cfg.dropout_rate,
            gelu_approx=cfg.gelu_approx, quant=cfg.quant_w8a8,
            quant_static=cfg.quant_w8a8_static, dtype=dtype, device=device,
            remat=remat,
        )

    def forward(self, volume: torch.Tensor,
                slice_features: Optional[torch.Tensor] = None,
                *, deterministic: bool = True, return_scores: bool = False,
                sp_group=None, sp_block_q: Optional[int] = None):
        """volume (B, C, D, H, W) in [0, 1]; slice_features (B, 32, 768)
        for the 2E3 encoder -> (B, seq_len, hidden) f32.

        Sequence parallel over `sp_group` (`parallel/sp.py`): the patch
        embedding and the 2E3 scoring (its cross-attention reads the 32
        slice tokens, not the other patches) run on every rank; the tokens
        after the CLS concat are padded to a multiple of the group's size,
        each rank keeps its contiguous chunk, and the tower runs with ring
        attention (`sp_block_q`: its query block), the padding masked as
        keys. Returns this rank's (B, S_padded / sp, hidden) chunk; the
        padded tail's rows are values the caller strips. Every parameter's
        gradient is then this rank's share, summed over the group by the
        train step."""
        cfg = self.config
        x = self.patch_embed(volume, deterministic=deterministic)
        scores = None
        if cfg.slice_guided:
            if slice_features is None:
                raise ValueError("the 2E3 encoder needs slice features")
            sf = slice_features.to(x.dtype)
            guided, _ = self.slice_guided_attention(
                x, sf, sf, deterministic=deterministic
            )
            scores = torch.sigmoid(self.patch_score_proj(guided))  # (B, N, 1)
            x = x * scores.to(x.dtype)
        if cfg.classification:
            cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
            x = torch.cat([cls, x], dim=1)
        sp = None
        if sp_group is not None:
            import torch.distributed as dist

            from hsenet_torch.ops.ring_attention import RingArgs, pad_to_multiple

            sp = RingArgs(sp_group, kv_len=x.shape[1], block_q=sp_block_q)
            size = dist.get_world_size(sp_group)
            x = pad_to_multiple(x, size, dim=1)
            x = x.chunk(size, dim=1)[dist.get_rank(sp_group)]
        x = self.tower(x, sp, deterministic=deterministic)
        if return_scores:
            return x, scores
        return x


class MaskedViT3D(nn.Module):
    """The legacy masked-contrastive ViT (the reference's `ViT`, vit.py:67-219):
    one tower, two streams.

    The full stream is [CLS | patches] through the tower. The masked stream
    scores each patch by the slice-guided cross-attention (`patch_score_proj`
    in f32, a sigmoid), weights the patches by their scores, keeps the
    `unmasked_tokens` best in ascending index order, prepends the CLS token
    and runs the same blocks with its own final LayerNorm `norm_masked`.
    The masked stream runs first, as in the JAX package.

    The kept patches are the first `unmasked_tokens` of a stable descending
    sort of the scores, so equal scores (an f32 sigmoid saturates at 1.0)
    keep the lower index first, as the JAX package's `lax.top_k` does."""

    def __init__(self, config: ViT3DConfig, *, dtype=torch.float32,
                 device="cuda", remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.patch_embed = PatchEmbed3D(
            cfg.patch_size, cfg.in_channels, cfg.num_patches, cfg.hidden_size,
            dropout_rate=cfg.dropout_rate, dtype=dtype, device=device,
        )
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, cfg.hidden_size, device=device))
        self.tower = TransformerTower(
            cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.mlp_dim,
            qkv_bias=cfg.qkv_bias, dropout_rate=cfg.dropout_rate,
            gelu_approx=cfg.gelu_approx, quant=cfg.quant_w8a8,
            quant_static=cfg.quant_w8a8_static, dtype=dtype, device=device,
            remat=remat,
        )
        self.slice_guided_attention = SingleHeadCrossAttention(
            cfg.hidden_size, dropout_rate=cfg.slice_dropout_rate, dtype=dtype,
            device=device,
        )
        self.patch_score_proj = Dense(cfg.hidden_size, 1, dtype=torch.float32,
                                      device=device)
        self.norm_masked = LayerNorm(cfg.hidden_size, device=device)

    def _with_cls(self, tokens: torch.Tensor) -> torch.Tensor:
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
        return torch.cat([cls, tokens], dim=1)

    def forward(self, volume: torch.Tensor, slice_features: torch.Tensor,
                unmasked_tokens: Optional[int] = None, *,
                deterministic: bool = True):
        """(B, 1 + N, hidden) f32 full stream, and with `unmasked_tokens`
        also the (B, 1 + unmasked_tokens, hidden) masked stream."""
        x = self.patch_embed(volume, deterministic=deterministic)
        x_masked = None
        if unmasked_tokens is not None:
            sf = slice_features.to(x.dtype)
            guided, _ = self.slice_guided_attention(
                x, sf, sf, deterministic=deterministic)
            scores = torch.sigmoid(self.patch_score_proj(guided))[..., 0]
            weighted = x * scores[..., None].to(x.dtype)
            order = torch.sort(scores, dim=1, descending=True, stable=True).indices
            top = torch.sort(order[:, :unmasked_tokens], dim=1).values
            kept = torch.gather(
                weighted, 1, top[..., None].expand(-1, -1, weighted.shape[-1]))
            x_masked = self.norm_masked(self.tower(
                self._with_cls(kept), deterministic=deterministic,
                skip_final_norm=True))
        x_full = self.tower(self._with_cls(x), deterministic=deterministic)
        if unmasked_tokens is None:
            return x_full
        return x_full, x_masked


class ViT2D(nn.Module):
    """BiomedCLIP-compatible 2D ViT-B/16 trunk: patch embed, a CLS token,
    position embeddings, `norm_pre`, pre-LN blocks with qkv bias (timm's),
    final LN; returns the CLS feature. Its attention runs B1 like every
    tower (196 + 1 tokens at head dim 64)."""

    def __init__(self, config: ViT2DConfig, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.patch_embed = PatchEmbed2D(cfg.patch_size, cfg.in_channels,
                                        cfg.hidden_size, dtype=dtype,
                                        device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.zeros(
            1, cfg.num_patches + 1, cfg.hidden_size, device=device))
        self.norm_pre = LayerNorm(cfg.hidden_size, device=device)
        self.tower = TransformerTower(
            cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.mlp_dim,
            qkv_bias=True, dtype=dtype, device=device,
        )

    def forward(self, images: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        """images (B, H, W, C) -> (B, hidden) f32 CLS feature."""
        x = self.patch_embed(images)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = self.tower(self.norm_pre(x), deterministic=deterministic)
        return x[:, 0]


class OnlineSliceFeatures(nn.Module):
    """In-graph BiomedCLIP slice features (the reference's ViT4LLM_v3 path,
    vit.py:471-571): the volume resized to (num_slices, 224, 224) with the
    JAX package's antialiased linear resize (`data.preprocess.resize`), a
    per-slice min-max and CLIP normalisation, then the frozen 2D trunk on
    every slice. Stands in for the offline (32, 768) feature npy."""

    def __init__(self, config: ViT2DConfig, *, num_slices: int = 32,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.config = config
        self.num_slices = num_slices
        self.slice_encoder_2d = ViT2D(config, dtype=dtype, device=device)

    def forward(self, volume: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        """volume (B, 1, D, H, W) in [0, 1] -> (B, num_slices, hidden) f32."""
        cfg, n, b = self.config, self.num_slices, volume.shape[0]
        v = resize(volume[:, 0], (b, n, cfg.image_size, cfg.image_size),
                   "linear")
        mn = v.amin(dim=(2, 3), keepdim=True)
        mx = v.amax(dim=(2, 3), keepdim=True)
        rgb = clip_normalize((v - mn) / torch.clamp_min(mx - mn, 1e-8))
        feats = self.slice_encoder_2d(
            rgb.reshape(b * n, cfg.image_size, cfg.image_size, 3),
            deterministic=deterministic)
        return feats.reshape(b, n, cfg.hidden_size)


class DualVisionTower(nn.Module):
    """Both towers; returns per-mode patch-token streams (CLS stripped).

    tower_mode: 'dual_vits' -> (feats_3d, feats_2e3); '3d_vit' / '2e3_vit'
    -> one stream."""

    def __init__(self, config: ViT3DConfig, *, tower_mode: str = "dual_vits",
                 select_feature: str = "patch", dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        if tower_mode not in ("dual_vits", "3d_vit", "2e3_vit"):
            raise ValueError(f"unknown tower_mode {tower_mode!r}")
        self.config = config
        self.tower_mode = tower_mode
        self.select_feature = select_feature
        if tower_mode in ("dual_vits", "3d_vit"):
            self.tower_stage1 = ViT3D(
                dataclasses.replace(config, slice_guided=False),
                dtype=dtype, device=device,
            )
        if tower_mode in ("dual_vits", "2e3_vit"):
            self.tower_stage2 = ViT3D(
                dataclasses.replace(config, slice_guided=True),
                dtype=dtype, device=device,
            )

    def _select(self, feats: torch.Tensor) -> torch.Tensor:
        if self.select_feature == "patch" and self.config.classification:
            return feats[:, 1:]
        if self.select_feature in ("patch", "cls_patch"):
            return feats
        raise ValueError(f"Unexpected select_feature: {self.select_feature}")

    def forward(self, volume: torch.Tensor,
                slice_features: Optional[torch.Tensor] = None, *,
                deterministic: bool = True):
        outs = []
        if self.tower_mode in ("dual_vits", "3d_vit"):
            outs.append(self._select(
                self.tower_stage1(volume, deterministic=deterministic)))
        if self.tower_mode in ("dual_vits", "2e3_vit"):
            outs.append(self._select(self.tower_stage2(
                volume, slice_features, deterministic=deterministic)))
        if self.tower_mode == "dual_vits":
            return tuple(outs)
        return outs[0]
