"""Phi-3 / Phi-4-mini decoder (the port of the JAX package's
models/phi3.py).

RMSNorm, separate q/k/v projections, GQA, partial rotary embeddings
(rotary_dim = partial_rotary_factor * head_dim, with optional LongRoPE
factors), SiLU-gated MLP, tied embeddings.

Batches are right-padded: each row keeps its own KV-cache length, so
decode writes land right after each prompt. Prefill attends over the whole
cache capacity with kv_lens = lengths + new tokens and a per-row causal
query offset = lengths, through the flash kernel when the chunk has at
least 64 tokens; decode (one token) runs the plain sdpa over the cache.
Training (no cache) runs causal flash attention with per-row kv_lens, and
its gradient through the backward kernels.

`remat=True` recomputes each block in the backward pass
(`models.layers.checkpointed`) under `config.remat_policy`: "full" keeps
only the block inputs, "dots" also the projections' outputs (the JAX
package's `dots_with_no_batch_dims_saveable`). The dropout generator's
state at the start of each block is kept too, so the recomputed block
draws the same masks.

With `quant_int8` the seven projections of each block hold int8 codes
(`models.lora.LoRADense(quantized=True)`), with `quant_int8_embed` the
embedding and its tied LM head are a `QuantEmbed`. A cache created with
`dtype=torch.int8` stores int8 codes with one f32 absmax scale per (layer,
row, head, token): new keys and values are quantised where they are
written and the cache is read back dequantised into the compute dtype.

Unlike the JAX package, whose arrays are immutable, the port writes new
keys and values into the cache in place and returns the same cache; this
keeps one copy of the cache in device memory.

Under tensor parallelism (`parallel.sharding.shard_params`) each block
holds num_heads / tp query and num_kv_heads / tp key/value heads (its
`config` is the local one; where num_kv_heads does not divide by tp, every
kv head, replicated, with `kv_select` picking each query head's), the
embedding and the LM head a slice of the vocabulary; the logits are
gathered to the whole vocabulary.

`convert_hf_phi3` carries HF `Phi3ForCausalLM` weights over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.configs import Phi3Config
from hsenet_torch.models.layers import checkpointed
from hsenet_torch.models.lora import LoRADense, QuantEmbed
from hsenet_torch.ops.attention import multi_head_attention
from hsenet_torch.utils.profiling import span

# prefill chunks shorter than this take the plain sdpa, as in the JAX package
FLASH_MIN_QUERY = 64


@dataclass
class KVCache:
    """Static-shape KV cache, updated in place.

    k, v: (num_layers, B, Hkv, T, D); lengths: (B,) int32 valid tokens per
    row. `dtype=torch.int8` at `create` switches on quantised storage:
    k and v hold int8 codes and `k_scale` / `v_scale`, (num_layers, B, Hkv,
    T) f32, their per-token absmax scales (None in a float cache)."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, config: Phi3Config, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> "KVCache":
        device = resolve_device(device)
        shape = (config.num_layers, batch, config.num_kv_heads, max_len,
                 config.head_dim)
        quant = dtype == torch.int8

        def scales():
            return (torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                    if quant else None)

        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
            k_scale=scales(),
            v_scale=scales(),
        )

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def quantize_kv(x: torch.Tensor):
    """(..., S, D) -> int8 codes + per-(..., S) f32 scales (absmax / 127,
    floored at 1e-10)."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1) / 127.0).clamp_min(1e-10)
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of `quantize_kv`, computed in f32 and cast to `dtype`."""
    return (q.float() * scale[..., None]).to(dtype)


def _rope_cos_sin(positions: torch.Tensor, rotary_dim: int, theta: float,
                  ext_factors=None, attention_scaling: float = 1.0):
    """positions (B, S) -> cos/sin (B, S, rotary_dim) in f32, half-split
    layout; `ext_factors`/`attention_scaling` implement LongRoPE."""
    exponent = (
        torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                     device=positions.device) / rotary_dim
    )
    inv_freq = 1.0 / torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=positions.device),
        exponent,
    )
    if ext_factors is not None:
        inv_freq = inv_freq / torch.tensor(
            ext_factors, dtype=torch.float32, device=positions.device
        )
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * attention_scaling, torch.sin(emb) * attention_scaling


def _longrope_params(cfg: Phi3Config, total_len: int):
    """LongRoPE factors and attention scaling for a cache of `total_len`."""
    if cfg.rope_short_factor is None and cfg.rope_long_factor is None:
        return None, 1.0
    use_long = total_len > cfg.original_max_position_embeddings
    ext = cfg.rope_long_factor if use_long else cfg.rope_short_factor
    factor = cfg.max_position_embeddings / cfg.original_max_position_embeddings
    if factor <= 1.0:
        scaling = 1.0
    else:
        scaling = math.sqrt(
            1 + math.log(factor) / math.log(cfg.original_max_position_embeddings)
        )
    return ext, scaling


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin, rotary_dim: int):
    """q, k (B, H, S, D); cos/sin (B, S, rotary_dim). Rotates the first
    rotary_dim channels in f32 and casts back to the input dtype."""
    cos = cos[:, None]
    sin = sin[:, None]

    def rot(x):
        x_rot, x_pass = x[..., :rotary_dim], x[..., rotary_dim:]
        x_rot = x_rot * cos + _rotate_half(x_rot) * sin
        return torch.cat([x_rot, x_pass.to(x_rot.dtype)], dim=-1).to(x.dtype)

    return rot(q), rot(k)


class RMSNorm(nn.Module):
    """RMS norm with an f32 scale, computed in f32, returning the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device="cuda"):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=resolve_device(device))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.pow(2).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


def _update_cache_layer(cache_k, cache_v, k_new, v_new, lengths) -> None:
    """Write (B, Hkv, S, D) keys/values at per-row offsets `lengths`, in
    place. Offsets are clamped to [0, T - S] as `dynamic_update_slice`
    clamps them."""
    rows, cols = _write_index(cache_k, k_new.shape[2], lengths)
    cache_k[rows, :, cols] = k_new.transpose(1, 2).to(cache_k.dtype)
    cache_v[rows, :, cols] = v_new.transpose(1, 2).to(cache_v.dtype)


def _write_index(cache_k, s: int, lengths):
    """(rows (B, 1), cols (B, S)) of the cache slots that S new tokens per
    row land in."""
    batch, _, capacity, _ = cache_k.shape
    start = lengths.long().clamp(0, capacity - s)
    cols = start[:, None] + torch.arange(s, device=cache_k.device)
    return torch.arange(batch, device=cache_k.device)[:, None], cols


def _update_cache_layer_quant(cache_k, cache_v, k_scale, v_scale, kq, vq,
                              ks_new, vs_new, lengths) -> None:
    """Quantised-cache write, in place: int8 codes (B, Hkv, S, D) and their
    scales (B, Hkv, S) land at the same per-row offsets."""
    rows, cols = _write_index(cache_k, kq.shape[2], lengths)
    cache_k[rows, :, cols] = kq.transpose(1, 2)
    cache_v[rows, :, cols] = vq.transpose(1, 2)
    k_scale[rows, :, cols] = ks_new.transpose(1, 2)
    v_scale[rows, :, cols] = vs_new.transpose(1, 2)


class Phi3Block(nn.Module):
    # a TP shard whose kv heads do not split over tp keeps them all (its k /
    # v projections replicated) and reads, for each of its query heads, the
    # kv head that head attends to: (first query head of the rank, query
    # heads per kv head, tp group); set by parallel.sharding.shard_params
    kv_select = None

    def __init__(self, config: Phi3Config, *, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        h = cfg.hidden_size

        def dense(name, in_dim, out_dim, bias=False):
            setattr(self, name, LoRADense(
                in_dim, out_dim, use_bias=bias, lora=cfg.lora,
                quantized=cfg.quant_int8, dtype=dtype, device=device,
            ))

        self.input_norm = RMSNorm(h, cfg.rms_norm_eps, device=device)
        dense("q_proj", h, cfg.q_dim, cfg.attention_bias)
        dense("k_proj", h, cfg.kv_dim, cfg.attention_bias)
        dense("v_proj", h, cfg.kv_dim, cfg.attention_bias)
        dense("o_proj", cfg.q_dim, h, cfg.attention_bias)
        self.post_attn_norm = RMSNorm(h, cfg.rms_norm_eps, device=device)
        dense("gate_proj", h, cfg.intermediate_size)
        dense("up_proj", h, cfg.intermediate_size)
        dense("down_proj", cfg.intermediate_size, h)

    def forward(self, x, cos, sin, kv_lens, layer_cache=None, sp=None, *,
                deterministic: bool = True):
        """layer_cache: None, (k, v, lengths) with k/v (B, Hkv, T, D), or
        for an int8 cache (k, v, k_scale, v_scale, lengths); written in
        place. `sp` (a `RingArgs`): sequence-parallel training, x this
        rank's token chunk, cos/sin at its global positions, kv_lens the
        rows' global lengths; attention is the causal ring, the unexpanded
        kv heads travelling it (no cache)."""
        cfg = self.config

        def proj(name, t):
            return getattr(self, name)(t, deterministic=deterministic)

        y = self.input_norm(x)
        q = rearrange(proj("q_proj", y), "b s (n d) -> b n s d", n=cfg.num_heads)
        k, v = proj("k_proj", y), proj("v_proj", y)
        if self.kv_select is not None:
            # replicated k / v: each rank's gradient covers its query heads
            # only, so it is summed over tp (Megatron's f)
            from hsenet_torch.parallel.mesh import copy_to_group

            k, v = (copy_to_group(t, self.kv_select[2]) for t in (k, v))
        k = rearrange(k, "b s (n d) -> b n s d", n=cfg.num_kv_heads)
        v = rearrange(v, "b s (n d) -> b n s d", n=cfg.num_kv_heads)
        q, k = apply_rope(q, k, cos, sin, cfg.rotary_dim)

        if sp is not None:
            from hsenet_torch.ops.ring_attention import ring_attention

            if layer_cache is not None:
                raise ValueError("sp is a training path: no KV cache")
            attn = ring_attention(q, k, v, group=sp.group, kv_lens=kv_lens,
                                  causal=True, block_q=sp.block_q)
        elif layer_cache is None:
            k, v = self._local_kv(k, q), self._local_kv(v, q)
            attn = multi_head_attention(q, k, v, kv_lens=kv_lens, causal=True)
        else:
            if len(layer_cache) == 5:
                # int8 cache: quantise the new rows, write codes and scales,
                # read the cache back dequantised
                ck, cv, ksc, vsc, lengths = layer_cache
                kq, ks_new = quantize_kv(k)
                vq, vs_new = quantize_kv(v)
                _update_cache_layer_quant(ck, cv, ksc, vsc, kq, vq, ks_new,
                                          vs_new, lengths)
                k_read = dequantize_kv(ck, ksc, q.dtype)
                v_read = dequantize_kv(cv, vsc, q.dtype)
            else:
                ck, cv, lengths = layer_cache
                _update_cache_layer(ck, cv, k, v, lengths)
                k_read, v_read = ck.to(q.dtype), cv.to(q.dtype)
            k_read, v_read = self._local_kv(k_read, q), self._local_kv(v_read, q)
            s = q.shape[2]
            if s == 1:
                # decode: one query over the cache, plain sdpa
                attn = multi_head_attention(
                    q, k_read, v_read, kv_lens=lengths + 1, use_flash=False
                )
            else:
                # prefill: causal with per-row query offset = cache lengths
                attn = multi_head_attention(
                    q, k_read, v_read, kv_lens=lengths + kv_lens, causal=True,
                    q_offset=lengths,
                    use_flash=None if s >= FLASH_MIN_QUERY else False,
                )
        x = x + proj("o_proj", rearrange(attn, "b n s d -> b s (n d)"))
        y = self.post_attn_norm(x)
        y = F.silu(proj("gate_proj", y)) * proj("up_proj", y)
        return x + proj("down_proj", y)

    def _local_kv(self, t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """`t` (B, Hkv, T, D) as this rank's query heads read it: unchanged,
        or under `kv_select` the kv head of each local query head."""
        if self.kv_select is None:
            return t
        first, per_kv, _ = self.kv_select
        heads = torch.arange(first, first + q.shape[1], device=t.device) // per_kv
        return t.index_select(1, heads)


class Phi3Decoder(nn.Module):
    """Decoder layers + final RMSNorm; operates on embeddings."""

    def __init__(self, config: Phi3Config, *, dtype=torch.bfloat16,
                 device="cuda", remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        self.remat = remat
        self.layers = nn.ModuleList(
            Phi3Block(config, dtype=dtype, device=device)
            for _ in range(config.num_layers)
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device)

    def forward(self, inputs_embeds: torch.Tensor, *,
                kv_lens: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                positions: Optional[torch.Tensor] = None,
                deterministic: bool = True, sp=None,
                sp_global_len: Optional[int] = None,
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
        """`sp` (a `RingArgs`) with `sp_global_len`: sequence-parallel
        training (`parallel/sp.py`). `inputs_embeds` is this rank's
        contiguous token chunk and `kv_lens` the rows' global lengths; the
        positions are rank * S_local + arange(S_local), the LongRoPE
        factors are chosen from the true global length, and attention is
        the causal ring."""
        cfg = self.config
        x = inputs_embeds.to(self.dtype)
        b, s, _ = x.shape
        steps = torch.arange(s, device=x.device)[None, :]
        if sp is not None:
            if cache is not None or positions is not None:
                raise ValueError("sp is a training path: no cache, no positions")
            if kv_lens is None or sp_global_len is None:
                raise ValueError("sp needs the rows' global kv_lens and "
                                 "sp_global_len")
            positions = (sp.rank * s + steps).expand(b, s)
        elif positions is None:
            positions = (
                cache.lengths[:, None] + steps if cache is not None
                else steps.expand(b, s)
            )
        # the LongRoPE choice depends on the longest reachable position:
        # the cache capacity in generation, the true global length under sp
        # (the ring's padding must not flip it), the sequence length otherwise
        total_len = (cache.k.shape[3] if cache is not None
                     else sp_global_len if sp is not None else s)
        ext_factors, attn_scaling = _longrope_params(cfg, total_len)
        cos, sin = _rope_cos_sin(
            positions, cfg.rotary_dim, cfg.rope_theta,
            ext_factors=ext_factors, attention_scaling=attn_scaling,
        )
        if kv_lens is None:
            kv_lens = torch.full((b,), s, dtype=torch.int32, device=x.device)
        kv_lens = kv_lens.to(device=x.device, dtype=torch.int32)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpointed(layer, x, cos, sin, kv_lens, None, sp,
                                 deterministic=deterministic,
                                 policy=cfg.remat_policy)
                continue
            if cache is None:
                layer_cache = None
            elif cache.quantized:
                layer_cache = (cache.k[i], cache.v[i], cache.k_scale[i],
                               cache.v_scale[i], cache.lengths)
            else:
                layer_cache = (cache.k[i], cache.v[i], cache.lengths)
            x = layer(x, cos, sin, kv_lens, layer_cache, sp,
                      deterministic=deterministic)
        if cache is not None:
            cache.lengths = cache.lengths + (1 if s == 1 else kv_lens)
        return self.norm(x), cache


class Phi3ForCausalLM(nn.Module):
    """Embeddings + decoder + LM head. `embed_tokens` and `decode_embeds`
    are exposed for the VLM's image-token splice. The embedding table (which
    also serves as the tied LM head) is cast to `dtype` at use, so it can be
    held as an f32 master for training; with `quant_int8_embed` it is a
    `QuantEmbed` (int8 rows, f32 per-row scales)."""

    def __init__(self, config: Phi3Config, *, dtype=torch.bfloat16,
                 device="cuda", remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        if config.quant_int8_embed:
            self.embed = QuantEmbed(config.vocab_size, config.hidden_size,
                                    dtype=dtype, device=device)
        else:
            self.embed = nn.Embedding(config.vocab_size, config.hidden_size,
                                      dtype=dtype, device=device)
        self.decoder = Phi3Decoder(config, dtype=dtype, device=device,
                                   remat=remat)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias=False, dtype=dtype, device=device)

    tp = None  # parallel.sharding.TPGroup once the model is a TP shard

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        with span("model.llm"):
            if self.tp is None:
                return self.embed(input_ids).to(self.dtype)
            from hsenet_torch.parallel.mesh import reduce_from_group

            # vocabulary-split table: look up the ids this rank holds, zeros
            # for the others, and sum the rows over tp
            rows = (self.embed.embedding_q if self.config.quant_int8_embed
                    else self.embed.weight).shape[0]
            local = input_ids.long() - self.tp.rank * rows
            inside = (local >= 0) & (local < rows)
            out = self.embed(local.clamp(0, rows - 1)).to(self.dtype)
            out = torch.where(inside[..., None], out, torch.zeros(
                (), dtype=self.dtype, device=out.device))
            return reduce_from_group(out, self.tp.group)

    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Logits over the whole vocabulary; a TP shard computes its
        vocabulary slice and all-gathers the rest, so every rank holds the
        same logits."""
        with span("model.head_loss"):
            if self.tp is not None:
                from hsenet_torch.parallel.mesh import copy_to_group, gather_from_group

                local = self._logits(copy_to_group(hidden, self.tp.group))
                return gather_from_group(local, self.tp.group, -1)
            return self._logits(hidden)

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        tied = self.config.tie_word_embeddings
        if tied and self.config.quant_int8_embed:
            return self.embed.attend(hidden)
        head = (self.embed if tied else self.lm_head).weight
        return F.linear(hidden.to(self.dtype), head.to(self.dtype))

    def decode_embeds(self, inputs_embeds: torch.Tensor, *,
                      kv_lens: Optional[torch.Tensor] = None,
                      cache: Optional[KVCache] = None,
                      positions: Optional[torch.Tensor] = None,
                      deterministic: bool = True,
                      last_token_only: bool = False,
                      return_hidden: bool = False):
        """(logits, cache), and with `return_hidden` the final normed hidden
        states of every position as a third item."""
        with span("model.llm"):
            hidden, cache = self.decoder(
                inputs_embeds, kv_lens=kv_lens, cache=cache, positions=positions,
                deterministic=deterministic,
            )
            full_hidden = hidden
            if last_token_only:
                if kv_lens is not None and hidden.shape[1] > 1:
                    idx = (kv_lens.long() - 1).clamp(min=0)
                    rows = torch.arange(hidden.shape[0], device=hidden.device)
                    hidden = hidden[rows, idx.to(hidden.device)][:, None]
                else:
                    hidden = hidden[:, -1:]
        logits = self.compute_logits(hidden)
        if return_hidden:
            return logits, cache, full_hidden
        return logits, cache

    def forward(self, input_ids: Optional[torch.Tensor] = None, *,
                inputs_embeds: Optional[torch.Tensor] = None,
                kv_lens: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                positions: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                last_token_only: bool = False):
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        return self.decode_embeds(
            inputs_embeds, kv_lens=kv_lens, cache=cache, positions=positions,
            deterministic=deterministic, last_token_only=last_token_only,
        )


def convert_hf_phi3(state_dict, config: Phi3Config):
    """HF torch `Phi3ForCausalLM.state_dict()` -> the state dict of the
    port's `Phi3ForCausalLM` (f32 host tensors). HF's fused `qkv_proj` and
    `gate_up_proj` are split by rows into the q/k/v and gate/up
    projections; the LM head is taken only for untied configs."""
    from hsenet_torch.utils.convert import as_f32

    def t(name):
        return as_f32(state_dict[name])

    q, kv, inter = config.q_dim, config.kv_dim, config.intermediate_size
    out = {"embed.weight": t("model.embed_tokens.weight")}
    for i in range(config.num_layers):
        src, dst = f"model.layers.{i}", f"decoder.layers.{i}"
        qkv = t(f"{src}.self_attn.qkv_proj.weight")  # (q + 2 kv, hidden)
        gate_up = t(f"{src}.mlp.gate_up_proj.weight")  # (2 inter, hidden)
        out.update({
            f"{dst}.input_norm.weight": t(f"{src}.input_layernorm.weight"),
            f"{dst}.q_proj.weight": qkv[:q].clone(),
            f"{dst}.k_proj.weight": qkv[q:q + kv].clone(),
            f"{dst}.v_proj.weight": qkv[q + kv:].clone(),
            f"{dst}.o_proj.weight": t(f"{src}.self_attn.o_proj.weight"),
            f"{dst}.post_attn_norm.weight": t(
                f"{src}.post_attention_layernorm.weight"),
            f"{dst}.gate_proj.weight": gate_up[:inter].clone(),
            f"{dst}.up_proj.weight": gate_up[inter:].clone(),
            f"{dst}.down_proj.weight": t(f"{src}.mlp.down_proj.weight"),
        })
    out["decoder.norm.weight"] = t("model.norm.weight")
    if not config.tie_word_embeddings and "lm_head.weight" in state_dict:
        out["lm_head.weight"] = t("lm_head.weight")
    return out
