"""Ring attention: exact attention over a sequence split into contiguous
chunks over an sp group (the port of the JAX package's
ops/ring_attention.py).

Each rank of the group holds one chunk of Q, K and V (chunk i = global
positions [i * S_local, (i + 1) * S_local)). It attends its queries to the
K/V chunk it holds, merges the hop into an online softmax (running row max
m, normaliser l, unnormalised accumulator acc, all f32), and passes K/V one
hop around the ring (`parallel.mesh.ppermute`, send-left: after t hops a
rank holds chunk (i + t) mod sp). After sp hops every query has seen every
key, and the result is the dense softmax up to the order of the f32 sums.

The backward is autograd's: `ppermute`'s gradient rotates the cotangent
the other way, as the JAX package's ppermute transposes, so the gradient
of the forward is the ring's backward.

The hop is plain PyTorch, as in the JAX package, where each hop is an
einsum with an f32 online softmax and not a Pallas call: the products take
their operands in f32 (exact copies of bf16 values) and sum in f32, as XLA's
f32-accumulated products of the JAX package do. The flash kernels stay the
single-rank path.

`RingArgs` carries what the modules pass down to `ring_attention`: the sp
group, the true global token count (`kv_len`; keys at or past it, the
ring's tail padding, are masked) and the query block (`block_q`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hsenet_torch.parallel.mesh import ppermute

_NEG_INF = -1e30  # finite mask value: exp(_NEG_INF - m) underflows to 0 in f32


@dataclass(frozen=True)
class RingArgs:
    """A sequence-parallel call's ring: the sp `group`, the true global
    token count `kv_len` (None: no tail padding) and the query block
    `block_q` (None: a dense hop)."""

    group: object
    kv_len: Optional[int] = None
    block_q: Optional[int] = None

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)


def _key_mask(k_pos, kv_len, kv_lens, total):
    """(B | 1, Sk) bool of the keys a hop may read, or None for all."""
    mask = None
    if kv_len is not None and kv_len < total:
        mask = (k_pos < kv_len)[None, :]
    if kv_lens is not None:
        rows = k_pos[None, :] < kv_lens[:, None].to(k_pos.device)
        mask = rows if mask is None else mask & rows
    return mask


def _hop_block(qg, k, v, q_pos, k_pos, key_mask, causal: bool,
               sm_scale: float):
    """(m, l, pv) of the grouped queries qg (B, Hkv, G, Sq, D) against one
    held chunk k, v (B, Hkv, Sk, D): the hop's row max, its sum of
    exp(s - m) and exp(s - m) V, in f32."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * sm_scale
    mask = None
    if key_mask is not None:
        mask = key_mask[:, None, None, None, :]
    if causal:
        c = (k_pos[None, :] <= q_pos[:, None])[None, None, None]
        mask = c if mask is None else mask & c
    if mask is not None:
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=s.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return m, p.sum(dim=-1), pv


def _hop_stats(qg, k, v, q_pos, k_pos, key_mask, causal, sm_scale, block_q):
    """`_hop_block` over the whole chunk, or with `block_q` over query
    blocks of that size, each recomputed in the backward
    (`torch.utils.checkpoint`) so a hop keeps a (block_q, S_local) score
    block at a time, not (S_local, S_local)."""
    s_local = qg.shape[3]
    if block_q is None or block_q >= s_local:
        return _hop_block(qg, k, v, q_pos, k_pos, key_mask, causal, sm_scale)
    parts = []
    for start in range(0, s_local, block_q):
        stop = min(start + block_q, s_local)
        parts.append(checkpoint(
            _hop_block, qg[:, :, :, start:stop], k, v, q_pos[start:stop], k_pos,
            key_mask, causal, sm_scale, use_reentrant=False))
    return tuple(torch.cat([p[i] for p in parts], dim=3) for i in range(3))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, kv_len: Optional[int] = None,
                   kv_lens: Optional[torch.Tensor] = None,
                   causal: bool = False, sm_scale: Optional[float] = None,
                   block_q: Optional[int] = None) -> torch.Tensor:
    """Exact attention over a sequence split over the sp `group`.

    q: (B, H, S_local, D), this rank's query chunk; k, v: (B, Hkv, S_local,
    D) with Hkv dividing H (GQA): the unexpanded kv heads travel the ring,
    and the queries are grouped per kv head. `kv_len`: the true global
    token count, keys at or past it masked (the tail padding of rounding
    the sequence up to a multiple of the group; the padded query rows come
    out as values the caller drops). `kv_lens` (B,): per-row valid global
    lengths. `causal`: the global causal mask. `sm_scale`: default
    1/sqrt(D). `block_q`: stream query blocks through each hop (needed at
    tens of thousands of tokens). Returns (B, H, S_local, D) in q's dtype.
    """
    b, h, s_local, d = q.shape
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    g = h // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    size, idx = dist.get_world_size(group), dist.get_rank(group)
    steps = torch.arange(s_local, device=q.device)
    q_pos = idx * s_local + steps
    qg = q.reshape(b, hkv, g, s_local, d)
    m = torch.full((b, hkv, g, s_local), -math.inf, device=q.device)
    l = torch.zeros((b, hkv, g, s_local), device=q.device)
    acc = torch.zeros((b, hkv, g, s_local, d), device=q.device)
    kv = torch.stack([k, v])
    for t in range(size):
        # the next hop's K/V are exchanged first (one send and one receive
        # a rank, posted together)
        nxt = ppermute(kv, group, -1) if t != size - 1 else None
        src = (idx + t) % size  # the global chunk held at this hop
        k_pos = src * s_local + steps
        mask = _key_mask(k_pos, kv_len, kv_lens, size * s_local)
        m_hop, l_hop, pv_hop = _hop_stats(qg, kv[0], kv[1], q_pos, k_pos, mask,
                                          causal, sm_scale, block_q)
        m_new = torch.maximum(m, m_hop)
        alpha = torch.exp(m - m_new)  # first hop: exp(-inf - finite) = 0
        beta = torch.exp(m_hop - m_new)
        l = l * alpha + l_hop * beta
        acc = acc * alpha[..., None] + pv_hop * beta[..., None]
        m = m_new
        kv = nxt
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, s_local, d).to(q.dtype)


def pad_to_multiple(x: torch.Tensor, multiple: int, dim: int) -> torch.Tensor:
    """Zero-pad `dim` of x up to the next multiple (x itself if it is one)."""
    pad = (-x.shape[dim]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - dim % x.dim())
    widths[-1] = pad
    return F.pad(x, widths)


class _LocalChunk(torch.autograd.Function):
    """This rank's chunk of a tensor every rank of the group holds alike;
    the gradient of the whole is every rank's chunk gradient, all-gathered,
    so what comes before the ring gets its full gradient on every rank."""

    @staticmethod
    def forward(ctx, x, group, dim):
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.dim = group, dim
        return x.chunk(size, dim=dim)[rank].contiguous()

    @staticmethod
    def backward(ctx, grad):
        from hsenet_torch.parallel.mesh import all_gather

        return all_gather(grad.contiguous(), ctx.group, ctx.dim), None, None


def local_chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous chunk of `dim` (already padded to a multiple
    of the group's size) of an `x` that every rank of `group` holds."""
    size = dist.get_world_size(group)
    if x.shape[dim] % size:
        raise ValueError(f"{x.shape[dim]} tokens do not split over {size} ranks")
    return _LocalChunk.apply(x, group, dim % x.dim())
