"""Projectors from vision tokens into the LLM width (the port of the JAX
package's models/projector.py).

  * `VisualPacker` (`VisualPacker_3d_phi_v3`, the production packer): view
    the 2048 tokens as an (8,16,16) grid, average-pool (1,4,4) windows into
    128 queries, let each query cross-attend its own 16-token window
    (`ResolutionAttention`, residual on the projected query, post-LN), then
    Linear-GELU-Linear into the LLM width.
  * `SpatialPoolingProjector` (the 'baseline' ablation): average-pool
    `pooling_size`^3 windows, then `mlp_depth` Linear layers.
  * `MLPProjector`: the same MLP per token, no pooling.
  * `QFormerProjector`: 32 learned queries, self-attention, cross-attention
    over the vision tokens, 2 post-norm encoder layers, a GELU MLP. Its
    attention runs through `multi_head_attention`, so the flash kernel.
  * `Med2E3Projector` (tower_mode 'med2e3'): pooled 3D tokens and the slice
    features through two MLPs, the slices weighted by a softmax score of
    their depth-plane context against the mean prompt embedding.

Every GELU is the exact erf one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.configs import PackerConfig
from hsenet_torch.models.layers import Dense, LayerNorm, dropout
from hsenet_torch.ops.attention import multi_head_attention


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


def _mlp(owner: nn.Module, prefix: str, in_dim: int, out_dim: int,
         depth: int, dtype, device) -> None:
    """Register `depth` Dense layers `<prefix>fc1`.. on `owner`: in_dim ->
    out_dim, then out_dim -> out_dim."""
    for i in range(depth):
        setattr(owner, f"{prefix}fc{i + 1}",
                Dense(in_dim if i == 0 else out_dim, out_dim, dtype=dtype,
                      device=device))


def _run_mlp(owner: nn.Module, prefix: str, depth: int,
             x: torch.Tensor) -> torch.Tensor:
    """The Dense layers of `_mlp` with exact GELU between them."""
    for i in range(depth):
        x = getattr(owner, f"{prefix}fc{i + 1}")(x)
        if i < depth - 1:
            x = F.gelu(x)
    return x


class SpatialPoolingProjector(nn.Module):
    """Baseline: average-pool the grid in `pooling_size`^3 windows, then
    `mlp_depth` Linear layers."""

    def __init__(self, config: PackerConfig, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.config = config
        _mlp(self, "", config.in_dim, config.out_dim, config.mlp_depth, dtype,
             resolve_device(device))

    def forward(self, tokens: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        cfg = self.config
        gd, gh, gw = cfg.grid
        p = cfg.pooling_size
        x = rearrange(
            tokens, "b (d pd h ph w pw) c -> b (d h w) (pd ph pw) c",
            d=gd // p, pd=p, h=gh // p, ph=p, w=gw // p, pw=p,
        ).mean(dim=2)
        return _run_mlp(self, "", cfg.mlp_depth, x)


class MLPProjector(nn.Module):
    """Per-token MLP with no pooling (ablation head)."""

    def __init__(self, config: PackerConfig, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.config = config
        _mlp(self, "", config.in_dim, config.out_dim, config.mlp_depth, dtype,
             resolve_device(device))

    def forward(self, tokens: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        return _run_mlp(self, "", self.config.mlp_depth, tokens)


class QFormerProjector(nn.Module):
    """32-query Q-Former ablation head: learned queries -> self-attention ->
    cross-attention over the vision tokens -> `num_layers` post-norm encoder
    layers (ReLU FFN of 2048, LayerNorms in f32) -> Linear-GELU-Linear into
    the LLM width. Each attention splits `in_dim` over `num_heads` heads
    (8 x 96 at ViT-B width) and runs `multi_head_attention`."""

    FFN_DIM = 2048

    def __init__(self, config: PackerConfig, *, num_queries: int = 32,
                 num_heads: int = 8, num_layers: int = 2,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.dtype = dtype
        d = config.in_dim
        # an f32 parameter whatever the dtype, cast at use (as in flax)
        self.query_embeds = nn.Parameter(
            torch.empty(num_queries, d, dtype=torch.float32, device=device))
        nn.init.xavier_uniform_(self.query_embeds)

        def dense(name, i, o):
            setattr(self, name, Dense(i, o, dtype=dtype, device=device))

        attns = ["self_attn", "cross_attn"] + [f"layer{i}_attn"
                                               for i in range(num_layers)]
        for name in attns:
            for proj in ("q", "k", "v", "o"):
                dense(f"{name}_{proj}", d, d)
        for i in range(num_layers):
            setattr(self, f"layer{i}_norm1", LayerNorm(d, device=device))
            dense(f"layer{i}_fc1", d, self.FFN_DIM)
            dense(f"layer{i}_fc2", self.FFN_DIM, d)
            setattr(self, f"layer{i}_norm2", LayerNorm(d, device=device))
        dense("proj_fc1", d, config.out_dim)
        dense("proj_fc2", config.out_dim, config.out_dim)

    def _mha(self, name: str, q_in: torch.Tensor,
             kv: torch.Tensor) -> torch.Tensor:
        def heads(t, proj):
            return rearrange(getattr(self, f"{name}_{proj}")(t),
                             "b s (n d) -> b n s d", n=self.num_heads)

        out = multi_head_attention(heads(q_in, "q"), heads(kv, "k"),
                                   heads(kv, "v"))
        return getattr(self, f"{name}_o")(rearrange(out, "b n s d -> b s (n d)"))

    def forward(self, tokens: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        b = tokens.shape[0]
        q = self.query_embeds.to(self.dtype).expand(b, -1, -1)
        q = self._mha("self_attn", q, q)
        x = self._mha("cross_attn", q, tokens.to(self.dtype))
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}_norm1")(x + self._mha(f"layer{i}_attn", x, x))
            y = getattr(self, f"layer{i}_fc2")(F.relu(getattr(self, f"layer{i}_fc1")(x)))
            x = getattr(self, f"layer{i}_norm2")(x + y)
        return self.proj_fc2(F.gelu(self.proj_fc1(x)))


class Med2E3Projector(nn.Module):
    """Med-2E3 projector: pooled 3D tokens and per-slice 2D features, the
    slices scored against the prompt; output [the pooled 3D tokens through
    an MLP | the slice features through a second MLP, each times its
    score], `proj_out_num + num_slices` tokens.

    A slice's context is the mean of its own MLP output and of the 3D
    tokens of its depth plane (slices grouped `num_slices // d_out` to a
    plane); the prompt is the f32 mean of `text_embeds` past the visual
    block (positions `n3d + num_slices + 1` on, right padding included, as
    in the JAX package); the scores are the softmax over slices of
    context . prompt."""

    def __init__(self, config: PackerConfig, *, num_slices: int = 32,
                 slice_dim: Optional[int] = None, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.num_slices = num_slices
        _mlp(self, "projector_3d_", config.in_dim, config.out_dim, 2, dtype,
             device)
        _mlp(self, "projector_2d_", slice_dim or config.in_dim, config.out_dim,
             2, dtype, device)
        self.dtype = dtype

    @property
    def proj_out_num(self) -> int:
        return self.config.proj_out_num + self.num_slices

    def forward(self, tokens: torch.Tensor, slice_features: torch.Tensor,
                text_embeds: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        """tokens (B, 2048, in_dim), slice_features (B, num_slices, dim),
        text_embeds (B, S, out_dim) -> (B, proj_out_num + num_slices,
        out_dim)."""
        cfg = self.config
        gd, gh, gw = cfg.grid
        kd, kh, kw = cfg.kernel
        b = tokens.shape[0]
        pooled = rearrange(
            tokens, "b (d wd h wh w ww) c -> b (d h w) (wd wh ww) c",
            d=gd // kd, wd=kd, h=gh // kh, wh=kh, w=gw // kw, ww=kw,
        ).mean(dim=2)
        f3d = _run_mlp(self, "projector_3d_", 2, pooled)
        f2d = _run_mlp(self, "projector_2d_", 2, slice_features.to(self.dtype))
        n3d = f3d.shape[1]
        d_out, h_out, w_out = cfg.out_grid
        grid3d = f3d.reshape(b, d_out, h_out * w_out, -1).repeat_interleave(
            self.num_slices // d_out, dim=1)
        ctx = torch.cat([grid3d, f2d[:, :, None, :]], dim=2).mean(dim=2)
        text = text_embeds[:, n3d + self.num_slices + 1:].float().mean(dim=1)
        score = torch.einsum("bsd,bd->bs", ctx.float(), text)
        score = torch.softmax(score, dim=1).to(f2d.dtype)
        return torch.cat([f3d, f2d * score[..., None]], dim=1)


def build_projector(config: PackerConfig, *, dtype=torch.float32,
                    device="cuda") -> nn.Module:
    """Projector registry, the reference's five projector types;
    'med2e3' takes the VLM's slice count and width through
    `Med2E3Projector` itself (`HSENetVLM` builds it so)."""
    kinds = {"packer_v3": VisualPacker,
             "spatial_pooling": SpatialPoolingProjector,
             "mlp": MLPProjector, "med2e3": Med2E3Projector}
    if config.projector_type == "qformer":
        return QFormerProjector(config, num_queries=config.num_queries,
                                dtype=dtype, device=device)
    if config.projector_type in kinds:
        return kinds[config.projector_type](config, dtype=dtype, device=device)
    raise ValueError(f"Unknown projector type: {config.projector_type}")
