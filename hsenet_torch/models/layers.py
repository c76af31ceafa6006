"""Shared transformer building blocks (the port of the JAX
package's models/layers.py).

  * `TransformerBlock`: pre-LN block, x = x + SA(LN(x)); x = x + MLP(LN(x)),
    with packed qkv and an output projection with bias.
  * `PatchEmbed3D`: non-overlapping patch rearrange + Linear + learned
    position embeddings.
  * `SingleHeadCrossAttention`: full-width single-head cross attention,
    residual on the projected query, post-LN.

With `quant` the dense modules of `MlpBlock` and `SelfAttention` are the
W8A8 serving dense `models.lora.DenseW8A8` (`quant_static`: calibrated
static activation scales), as the JAX package's `_dense` switch makes them.

Dtype flow follows the JAX package: each Dense computes in the module's
dtype (its input and its weights are cast to it at use, so a weight kept
as an f32 master for training computes in bf16 like a bf16 one), LayerNorms
keep f32 parameters and return f32 with eps 1e-6, and attention softmax
runs in f32.

Dropout is flax's `nn.Dropout`: off when `deterministic`, else each element
is kept with probability 1 - rate and scaled by 1 / (1 - rate). Its masks
come from the `torch.Generator` that `dropout_rng` installs around the call
(the counterpart of `rngs={"dropout": key}` in flax's `apply`).
`checkpointed` runs a block under activation checkpointing with the same
masks in its recomputation.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn
from torch.utils.checkpoint import checkpoint

from hsenet_torch import resolve_device
from hsenet_torch.ops.attention import multi_head_attention


_DROPOUT_RNG: Optional[torch.Generator] = None


@contextlib.contextmanager
def dropout_rng(generator: Optional[torch.Generator]) -> Iterator[None]:
    """Dropout inside this context draws its masks from `generator` (on the
    device of the activations)."""
    global _DROPOUT_RNG
    previous, _DROPOUT_RNG = _DROPOUT_RNG, generator
    try:
        yield
    finally:
        _DROPOUT_RNG = previous


def dropout(x: torch.Tensor, rate: float, deterministic: bool) -> torch.Tensor:
    """flax `nn.Dropout(rate)(x, deterministic=...)`, masks drawn from the
    generator of `dropout_rng`."""
    if deterministic or rate == 0.0:
        return x
    if _DROPOUT_RNG is None:
        raise RuntimeError(
            "dropout with deterministic=False needs a generator: run the "
            "call under dropout_rng(generator)"
        )
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=_DROPOUT_RNG, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def _run_from_state(block, generator, state, deterministic, x, *args):
    if generator is not None:
        generator.set_state(state)
    with dropout_rng(generator):
        return block(x, *args, deterministic=deterministic)


def checkpointed(block: nn.Module, x: torch.Tensor, *args,
                 deterministic: bool) -> torch.Tensor:
    """`block(x, *args, deterministic=...)` under activation checkpointing
    (the JAX package's `nn.remat` with its default "full" policy): only the
    block's inputs are kept, and the backward recomputes the block. The
    dropout generator is set back to its state before the block, so the
    recomputation draws the same masks as the first run."""
    generator = _DROPOUT_RNG
    state = None if generator is None else generator.get_state()
    return checkpoint(_run_from_state, block, generator, state, deterministic,
                      x, *args, use_reentrant=False, preserve_rng_state=False)


class Dense(nn.Linear):
    """nn.Linear computing in `dtype`, as flax's `nn.Dense(dtype=...)`: the
    input, weight and bias are cast to it at use, whatever dtype the
    parameters are held in."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, dtype=torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embed(nn.Embedding):
    """flax `nn.Embed(dtype=...)`: the looked-up rows are cast to `dtype`,
    whatever dtype the table is held in (an f32 master for training)."""

    def __init__(self, num_embeddings: int, dim: int, *,
                 dtype=torch.float32, device="cuda"):
        super().__init__(num_embeddings, dim, dtype=dtype,
                         device=resolve_device(device))
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm(dtype=float32)`: eps 1e-6 unless given (BERT's is
    1e-12), f32 parameters, f32 output whatever the input dtype."""

    def __init__(self, dim: int, *, eps: float = 1e-6, device="cuda"):
        super().__init__(dim, eps=eps, device=resolve_device(device),
                         dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )


def _dense(in_dim: int, features: int, *, quant: bool, dtype, device,
           bias: bool = True, quant_static: bool = False) -> nn.Module:
    """`Dense`, or the W8A8 serving dense when `quant` (same buffer names
    as `LoRADense(quantized=True)`, so one converter serves both)."""
    if quant:
        from hsenet_torch.models.lora import DenseW8A8

        return DenseW8A8(in_dim, features, use_bias=bias,
                         static_act_scale=quant_static, dtype=dtype,
                         device=device)
    return Dense(in_dim, features, bias=bias, dtype=dtype, device=device)


class MlpBlock(nn.Module):
    """Linear-GELU-Linear (exact erf GELU unless `gelu_approx`)."""

    def __init__(self, in_dim: int, mlp_dim: int, out_dim: int, *,
                 dropout_rate: float = 0.0, gelu_approx: bool = False,
                 quant: bool = False, quant_static: bool = False,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        kw = dict(quant=quant, quant_static=quant_static, dtype=dtype,
                  device=device)
        self.fc1 = _dense(in_dim, mlp_dim, **kw)
        self.fc2 = _dense(mlp_dim, out_dim, **kw)
        self.dropout_rate = dropout_rate
        self.gelu_approx = "tanh" if gelu_approx else "none"

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        x = F.gelu(self.fc1(x), approximate=self.gelu_approx)
        x = self.fc2(dropout(x, self.dropout_rate, deterministic))
        return dropout(x, self.dropout_rate, deterministic)


class SelfAttention(nn.Module):
    def __init__(self, hidden: int, num_heads: int, *, qkv_bias: bool = False,
                 dropout_rate: float = 0.0, quant: bool = False,
                 quant_static: bool = False, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        kw = dict(quant=quant, quant_static=quant_static, dtype=dtype,
                  device=device)
        self.qkv = _dense(hidden, 3 * hidden, bias=qkv_bias, **kw)
        self.out_proj = _dense(hidden, hidden, **kw)

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        q, k, v = (
            rearrange(t, "b s (n d) -> b n s d", n=self.num_heads)
            for t in self.qkv(x).chunk(3, dim=-1)
        )
        out = multi_head_attention(q, k, v)
        out = self.out_proj(rearrange(out, "b n s d -> b s (n d)"))
        return dropout(out, self.dropout_rate, deterministic)


class TransformerBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_dim: int, *,
                 qkv_bias: bool = False, dropout_rate: float = 0.0,
                 gelu_approx: bool = False, quant: bool = False,
                 quant_static: bool = False, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        kw = dict(quant=quant, quant_static=quant_static, dtype=dtype,
                  device=device)
        self.norm1 = LayerNorm(hidden, device=device)
        self.attn = SelfAttention(hidden, num_heads, qkv_bias=qkv_bias,
                                  dropout_rate=dropout_rate, **kw)
        self.norm2 = LayerNorm(hidden, device=device)
        self.mlp = MlpBlock(hidden, mlp_dim, hidden, dropout_rate=dropout_rate,
                            gelu_approx=gelu_approx, **kw)

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), deterministic=deterministic)
        return x + self.mlp(self.norm2(x), deterministic=deterministic)


class PatchEmbed3D(nn.Module):
    """(B, C, D, H, W) -> (B, n_patches, hidden) + learned pos embeddings."""

    def __init__(self, patch_size: Tuple[int, int, int], in_channels: int,
                 num_patches: int, hidden: int, *, dropout_rate: float = 0.0,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dropout_rate = dropout_rate
        self.patch_size = tuple(patch_size)
        p0, p1, p2 = self.patch_size
        self.proj = Dense(p0 * p1 * p2 * in_channels, hidden, dtype=dtype,
                          device=device)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, num_patches, hidden, device=device)
        )

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        p0, p1, p2 = self.patch_size
        # channel last inside the patch, as the JAX package orders it
        tokens = rearrange(
            x, "b c (d p0) (h p1) (w p2) -> b (d h w) (p0 p1 p2 c)",
            p0=p0, p1=p1, p2=p2,
        )
        tokens = self.proj(tokens)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        return dropout(tokens, self.dropout_rate, deterministic)


class SingleHeadCrossAttention(nn.Module):
    """out, attn = SDPA(Wq q, Wk k, Wv v) with scale 1/sqrt(emb_dim);
    result = LN(Wq(q) + Drop(Wo(out))), dropout also on the attention
    weights. Returns (result, attention_weights before dropout)."""

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

    def forward(self, query, key, value, *, deterministic: bool = True):
        q, k, v = self.wq(query), self.wk(key), self.wv(value)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = torch.softmax(s / math.sqrt(self.emb_dim), dim=-1)
        attn_d = dropout(attn, self.dropout_rate, deterministic).to(v.dtype)
        out = self.out_proj(torch.matmul(attn_d, v))
        out = dropout(out, self.dropout_rate, deterministic)
        return self.norm(q + out), attn
