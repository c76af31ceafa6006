"""3D vision encoders (the port of the JAX package's
models/vit.py): ViT3D (stage 1),
its 2E3 slice-guided form (stage 2) and the dual-encoder tower.

  * `ViT3D`: patch embed -> [CLS | tokens] -> pre-LN blocks -> final LN.
  * slice-guided (2E3): patch embed -> single-head cross-attention from the
    patch tokens onto the per-slice features -> Linear(hidden->1)+Sigmoid
    per-patch score -> tokens *= score -> [CLS | tokens] -> the same tower.
  * `DualVisionTower`: both towers; strips CLS when select_feature is
    'patch'; `tower_mode` is dual_vits | 3d_vit | 2e3_vit.

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
from hsenet_torch.configs import ViT3DConfig
from hsenet_torch.models.layers import (
    Dense,
    LayerNorm,
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

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = checkpointed(block, x, deterministic=deterministic)
            else:
                x = block(x, deterministic=deterministic)
        return self.norm(x)


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
                *, deterministic: bool = True, return_scores: bool = False):
        """volume (B, C, D, H, W) in [0, 1]; slice_features (B, 32, 768)
        for the 2E3 encoder -> (B, seq_len, hidden) f32."""
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
        x = self.tower(x, deterministic=deterministic)
        if return_scores:
            return x, scores
        return x


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
