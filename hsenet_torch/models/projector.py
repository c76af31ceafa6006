"""Spatial packer projector (the port of the JAX
package's models/projector.py):
2048 vision tokens -> 128 LLM tokens.

`VisualPacker` (`VisualPacker_3d_phi_v3`): view the 2048 tokens as an
(8,16,16) grid, average-pool (1,4,4) windows into 128 queries, let each
query cross-attend its own 16-token window (`ResolutionAttention`,
residual on the projected query, post-LN), then Linear-GELU-Linear into
the LLM width. The other projector types come with later slices.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.configs import PackerConfig
from hsenet_torch.models.layers import Dense, LayerNorm, dropout


class ResolutionAttention(nn.Module):
    """Per-window single-query cross-attention, dropout on the attention
    weights and on the projected output."""

    def __init__(self, emb_dim: int, *, dropout_rate: float = 0.1,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.emb_dim = emb_dim
        self.dropout_rate = dropout_rate
        for name in ("wq", "wk", "wv", "out_proj"):
            setattr(self, name, Dense(emb_dim, emb_dim, dtype=dtype,
                                      device=device))
        self.norm = LayerNorm(emb_dim, device=device)

    def forward(self, lr_queries: torch.Tensor, hr_windows: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        """lr_queries (B, W, D); hr_windows (B, W, K, D) -> (B, W, D)."""
        q = self.wq(lr_queries)
        k = self.wk(hr_windows)
        v = self.wv(hr_windows)
        s = torch.einsum("bwd,bwkd->bwk", q.float(), k.float())
        p = torch.softmax(s / math.sqrt(self.emb_dim), dim=-1)
        p = dropout(p, self.dropout_rate, deterministic)
        out = torch.einsum("bwk,bwkd->bwd", p.to(v.dtype), v)
        out = dropout(self.out_proj(out), self.dropout_rate, deterministic)
        return self.norm(q + out)


class VisualPacker(nn.Module):
    """Production packer (`VisualPacker_3d_phi_v3`)."""

    def __init__(self, config: PackerConfig, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.resolution_attention = ResolutionAttention(
            config.in_dim, dropout_rate=config.dropout_rate, dtype=dtype,
            device=device,
        )
        self.proj_fc1 = Dense(config.in_dim, config.out_dim, dtype=dtype,
                              device=device)
        self.proj_fc2 = Dense(config.out_dim, config.out_dim, dtype=dtype,
                              device=device)

    def forward(self, tokens: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        cfg = self.config
        gd, gh, gw = cfg.grid
        kd, kh, kw = cfg.kernel
        hr = rearrange(
            tokens,
            "b (d wd h wh w ww) c -> b (d h w) (wd wh ww) c",
            d=gd // kd, wd=kd, h=gh // kh, wh=kh, w=gw // kw, ww=kw,
        )
        packed = self.resolution_attention(hr.mean(dim=2), hr,
                                           deterministic=deterministic)
        return self.proj_fc2(F.gelu(self.proj_fc1(packed)))


def build_projector(config: PackerConfig, *, dtype=torch.float32,
                    device="cuda") -> nn.Module:
    """Projector registry; the port has `packer_v3` so far."""
    if config.projector_type == "packer_v3":
        return VisualPacker(config, dtype=dtype, device=device)
    raise NotImplementedError(
        f"projector_type {config.projector_type!r} comes with a later slice "
        "of the port (ROADMAP.md queue A, projectors and ViT variants)"
    )
