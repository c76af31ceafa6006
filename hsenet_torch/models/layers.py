"""Shared transformer building blocks (the port of the JAX
package's models/layers.py).

  * `TransformerBlock`: pre-LN block, x = x + SA(LN(x)); x = x + MLP(LN(x)),
    with packed qkv and an output projection with bias.
  * `PatchEmbed3D`: non-overlapping patch rearrange + Linear + learned
    position embeddings.
  * `SingleHeadCrossAttention`: full-width single-head cross attention,
    residual on the projected query, post-LN.

Dtype flow follows the JAX package: each Dense computes in the module's
dtype (its weights are stored in it and its input is cast to it),
LayerNorms keep f32 parameters and return f32 with eps 1e-6, and attention
softmax runs in f32. The port is the inference path: dropout is not
applied (the training slice adds it).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.ops.attention import multi_head_attention


class Dense(nn.Linear):
    """nn.Linear that casts its input to the weight's dtype first, as
    flax's `nn.Dense(dtype=...)` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm(dtype=float32)`: eps 1e-6, f32 parameters, f32
    output whatever the input dtype."""

    def __init__(self, dim: int, *, device="cuda"):
        super().__init__(dim, eps=1e-6, device=resolve_device(device),
                         dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )


class MlpBlock(nn.Module):
    """Linear-GELU-Linear (exact erf GELU unless `gelu_approx`)."""

    def __init__(self, in_dim: int, mlp_dim: int, out_dim: int, *,
                 gelu_approx: bool = False, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.fc1 = Dense(in_dim, mlp_dim, dtype=dtype, device=device)
        self.fc2 = Dense(mlp_dim, out_dim, dtype=dtype, device=device)
        self.gelu_approx = "tanh" if gelu_approx else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate=self.gelu_approx))


class SelfAttention(nn.Module):
    def __init__(self, hidden: int, num_heads: int, *, qkv_bias: bool = False,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_heads = num_heads
        self.qkv = Dense(hidden, 3 * hidden, bias=qkv_bias, dtype=dtype,
                         device=device)
        self.out_proj = Dense(hidden, hidden, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (
            rearrange(t, "b s (n d) -> b n s d", n=self.num_heads)
            for t in self.qkv(x).chunk(3, dim=-1)
        )
        out = multi_head_attention(q, k, v)
        return self.out_proj(rearrange(out, "b n s d -> b s (n d)"))


class TransformerBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_dim: int, *,
                 qkv_bias: bool = False, gelu_approx: bool = False,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.norm1 = LayerNorm(hidden, device=device)
        self.attn = SelfAttention(hidden, num_heads, qkv_bias=qkv_bias,
                                  dtype=dtype, device=device)
        self.norm2 = LayerNorm(hidden, device=device)
        self.mlp = MlpBlock(hidden, mlp_dim, hidden, gelu_approx=gelu_approx,
                            dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed3D(nn.Module):
    """(B, C, D, H, W) -> (B, n_patches, hidden) + learned pos embeddings."""

    def __init__(self, patch_size: Tuple[int, int, int], in_channels: int,
                 num_patches: int, hidden: int, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.patch_size = tuple(patch_size)
        p0, p1, p2 = self.patch_size
        self.proj = Dense(p0 * p1 * p2 * in_channels, hidden, dtype=dtype,
                          device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, num_patches, hidden, device=device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p0, p1, p2 = self.patch_size
        # channel last inside the patch, as the JAX package orders it
        tokens = rearrange(
            x, "b c (d p0) (h p1) (w p2) -> b (d h w) (p0 p1 p2 c)",
            p0=p0, p1=p1, p2=p2,
        )
        tokens = self.proj(tokens)
        return tokens + self.pos_embed.to(tokens.dtype)


class SingleHeadCrossAttention(nn.Module):
    """out, attn = SDPA(Wq q, Wk k, Wv v) with scale 1/sqrt(emb_dim);
    result = LN(Wq(q) + Wo(out)). Returns (result, attention_weights)."""

    def __init__(self, emb_dim: int, *, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.emb_dim = emb_dim
        for name in ("wq", "wk", "wv", "out_proj"):
            setattr(self, name, Dense(emb_dim, emb_dim, dtype=dtype,
                                      device=device))
        self.norm = LayerNorm(emb_dim, device=device)

    def forward(self, query, key, value):
        q, k, v = self.wq(query), self.wk(key), self.wv(value)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = torch.softmax(s / math.sqrt(self.emb_dim), dim=-1)
        out = self.out_proj(torch.matmul(attn.to(v.dtype), v))
        return self.norm(q + out), attn
