"""Hierarchical 3D Swin Transformer encoder (the port of the JAX package's
models/swin.py), SegVol's other image encoder.

Swin v1 (Liu et al.) in 3D, after the reference's vendored
`segment_anything_volumetric/modeling/image_encoder_swin.py`:

  * windowed multi-head attention with a learned relative-position-bias
    table indexed by a fixed relative-coordinate map (`WindowAttention3D`);
  * blocks alternate unshifted and half-window-shifted windows; shifted
    blocks add -100.0 between voxels of different pre-shift regions
    (`shift_attention_mask`);
  * pre-LN blocks with a GELU MLP at mlp_ratio 4 (`SwinBlock3D`);
  * `PatchMerging3D` concatenates the 8 voxel neighbours and reduces 8C to
    2C with a bias-free Linear after a LayerNorm, between stages, so the
    last grid and width are `SwinConfig.grid` / `out_dim`.

The windowed attention is plain PyTorch, as it is plain jnp in the JAX
package: the windows hold 64 tokens and the bias and mask enter the
scores, which no flash kernel of the port takes. Layouts are channel last,
(B, D, H, W, C), as in the JAX package. The relative-position index and the
shift masks are numpy constants (integer-equal to the JAX package's),
placed on the device once per shape.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.configs import SwinConfig
from hsenet_torch.models.layers import Dense, LayerNorm, MlpBlock, dropout


def _effective_window(dims, window, shift):
    """Clamp the window to each axis and zero the shift on axes the window
    already covers (the reference's `get_window_size`)."""
    w, s = list(window), list(shift)
    for i in range(3):
        if dims[i] <= window[i]:
            w[i] = dims[i]
            s[i] = 0
    return tuple(w), tuple(s)


def window_partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B*nW, wd*wh*ww, C)."""
    return rearrange(
        x, "b (nd wd) (nh wh) (nw ww) c -> (b nd nh nw) (wd wh ww) c",
        wd=window[0], wh=window[1], ww=window[2],
    )


def window_reverse(windows: torch.Tensor, window: Sequence[int],
                   dims: Sequence[int]) -> torch.Tensor:
    """Inverse of `window_partition` for spatial dims (D, H, W)."""
    d, h, w = dims
    return rearrange(
        windows, "(b nd nh nw) (wd wh ww) c -> b (nd wd) (nh wh) (nw ww) c",
        nd=d // window[0], nh=h // window[1], nw=w // window[2],
        wd=window[0], wh=window[1], ww=window[2],
    )


def relative_position_index(window: Sequence[int],
                            table_window: Optional[Sequence[int]] = None
                            ) -> np.ndarray:
    """(n, n) index into the bias table. `table_window` is the configured
    window the table was allocated for; `window` may be clamped to a small
    volume, and offsets and strides come from `table_window` so one table
    serves every clamping."""
    tw = tuple(table_window) if table_window is not None else tuple(window)
    coords = np.stack(
        np.meshgrid(*[np.arange(w) for w in window], indexing="ij")
    ).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # (3, n, n)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += tw[0] - 1
    rel[:, :, 1] += tw[1] - 1
    rel[:, :, 2] += tw[2] - 1
    rel[:, :, 0] *= (2 * tw[1] - 1) * (2 * tw[2] - 1)
    rel[:, :, 1] *= 2 * tw[2] - 1
    return rel.sum(-1)


def shift_attention_mask(dims: Sequence[int], window: Sequence[int],
                         shift: Sequence[int]) -> np.ndarray:
    """(nW, n, n) additive mask of shifted windows: -100.0 between voxels
    of different pre-shift regions, 0 within one (the reference's
    `compute_mask`)."""
    d, h, w = dims
    region = np.zeros((1, d, h, w, 1), np.float32)
    cnt = 0
    for ds in (slice(-window[0]), slice(-window[0], -shift[0]),
               slice(-shift[0], None)):
        for hs in (slice(-window[1]), slice(-window[1], -shift[1]),
                   slice(-shift[1], None)):
            for ws in (slice(-window[2]), slice(-window[2], -shift[2]),
                       slice(-shift[2], None)):
                region[:, ds, hs, ws, :] = cnt
                cnt += 1
    rw = region.reshape(
        1, d // window[0], window[0], h // window[1], window[1],
        w // window[2], window[2], 1,
    )
    rw = rw.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        -1, window[0] * window[1] * window[2])
    diff = rw[:, None, :] - rw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention3D(nn.Module):
    """Windowed multi-head attention with a relative position bias; the
    table keeps the configured window's size whatever window a call uses."""

    def __init__(self, dim: int, num_heads: int,
                 table_window: Tuple[int, int, int], *, qkv_bias: bool = True,
                 dropout_rate: float = 0.0, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dim, self.num_heads = dim, num_heads
        self.table_window = tuple(table_window)
        self.dropout_rate = dropout_rate
        tw = self.table_window
        table_size = (2 * tw[0] - 1) * (2 * tw[1] - 1) * (2 * tw[2] - 1)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table_size, num_heads, device=device))
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        self._index = {}  # window -> (n, n) index on the device

    def forward(self, x: torch.Tensor, window: Tuple[int, int, int],
                mask: Optional[torch.Tensor] = None, *,
                deterministic: bool = True) -> torch.Tensor:
        bw, n, _ = x.shape
        head_dim = self.dim // self.num_heads
        q, k, v = rearrange(self.qkv(x), "b n (three h d) -> three b h n d",
                            three=3, h=self.num_heads)
        scores = torch.matmul((q * head_dim ** -0.5).float(),
                              k.float().transpose(-1, -2))
        idx = self._index.get(window)
        if idx is None:
            idx = self._index[window] = torch.as_tensor(
                relative_position_index(window, self.table_window),
                device=x.device)
        bias = self.relative_position_bias_table[idx].permute(2, 0, 1)
        scores = scores + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            scores = (scores.view(bw // nw, nw, self.num_heads, n, n)
                      + mask[None, :, None]).view(bw, self.num_heads, n, n)
        probs = dropout(torch.softmax(scores, dim=-1), self.dropout_rate,
                        deterministic)
        out = torch.matmul(probs.to(v.dtype), v)
        out = self.proj(rearrange(out, "b h n d -> b n (h d)"))
        return dropout(out, self.dropout_rate, deterministic)


class SwinBlock3D(nn.Module):
    """Pre-LN Swin block, shifted by half a window when `shifted`; pads the
    grid to window multiples and crops back."""

    def __init__(self, dim: int, num_heads: int, window: Tuple[int, int, int],
                 shifted: bool, *, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, dropout_rate: float = 0.0,
                 gelu_approx: bool = False, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.window = tuple(window)
        self.shifted = shifted
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = WindowAttention3D(dim, num_heads, self.window,
                                      qkv_bias=qkv_bias,
                                      dropout_rate=dropout_rate, dtype=dtype,
                                      device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dim,
                            dropout_rate=dropout_rate, gelu_approx=gelu_approx,
                            dtype=dtype, device=device)
        self._masks = {}  # (dims, window, shift) -> mask on the device

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        _, d, h, w, _ = x.shape
        base = (tuple(i // 2 for i in self.window) if self.shifted
                else (0, 0, 0))
        window, shift = _effective_window((d, h, w), self.window, base)
        pads = [(window[i] - (d, h, w)[i] % window[i]) % window[i]
                for i in range(3)]
        y = self.norm1(x)
        y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        dims_p = tuple(y.shape[1:4])
        mask = None
        if any(shift):
            y = torch.roll(y, tuple(-s for s in shift), dims=(1, 2, 3))
            key = (dims_p, window, shift)
            mask = self._masks.get(key)
            if mask is None:
                mask = self._masks[key] = torch.as_tensor(
                    shift_attention_mask(dims_p, window, shift),
                    device=x.device)
        y = self.attn(window_partition(y, window), window, mask,
                      deterministic=deterministic)
        y = window_reverse(y, window, dims_p)
        if any(shift):
            y = torch.roll(y, shift, dims=(1, 2, 3))
        x = x + y[:, :d, :h, :w]
        return x + self.mlp(self.norm2(x), deterministic=deterministic)


class PatchMerging3D(nn.Module):
    """Concatenate the 2x2x2 neighbours, LayerNorm, bias-free 8C -> 2C."""

    def __init__(self, dim: int, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.norm = LayerNorm(8 * dim, device=device)
        self.reduction = Dense(8 * dim, 2 * dim, bias=False, dtype=dtype,
                               device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = rearrange(x, "b (d pd) (h ph) (w pw) c -> b d h w (pd ph pw c)",
                      pd=2, ph=2, pw=2)
        return self.reduction(self.norm(y))


class SwinTransformer3D(nn.Module):
    """Patch embedding, then the stages of Swin blocks with a patch merging
    between them: (B, C, D, H, W) -> (B, D', H', W', out_dim) on
    `SwinConfig.grid`. Blocks are named `stage{s}_block{i}` and merges
    `merge{s}`, the JAX module's names."""

    def __init__(self, config: SwinConfig, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.compute_dtype = dtype
        p0, p1, p2 = cfg.patch_size
        self.patch_embed = Dense(p0 * p1 * p2 * cfg.in_channels, cfg.embed_dim,
                                 dtype=dtype, device=device)
        self.patch_norm = (LayerNorm(cfg.embed_dim, device=device)
                           if cfg.patch_norm else None)
        self.layer_names = []
        dim = cfg.embed_dim
        for stage, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
            if stage > 0:
                self._add(f"merge{stage}", PatchMerging3D(dim, dtype=dtype,
                                                          device=device))
                dim *= 2
            for i in range(depth):
                self._add(f"stage{stage}_block{i}", SwinBlock3D(
                    dim, heads, cfg.window_size, shifted=(i % 2 == 1),
                    mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                    dropout_rate=cfg.dropout_rate,
                    gelu_approx=cfg.gelu_approx, dtype=dtype, device=device))

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.layer_names.append(name)

    def forward(self, volume: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        cfg = self.config
        p0, p1, p2 = cfg.patch_size
        x = rearrange(volume, "b c (d p0) (h p1) (w p2) -> b d h w (p0 p1 p2 c)",
                      p0=p0, p1=p1, p2=p2).to(self.compute_dtype)
        x = self.patch_embed(x)
        if self.patch_norm is not None:
            x = self.patch_norm(x)
        x = dropout(x, cfg.dropout_rate, deterministic)
        for name in self.layer_names:
            layer = getattr(self, name)
            if name.startswith("merge"):
                x = layer(x)
            else:
                x = layer(x, deterministic=deterministic)
        return x
