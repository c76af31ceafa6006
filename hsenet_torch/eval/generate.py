"""Batched greedy generation (the port of the JAX package's
eval/generate.py: `make_greedy_generate`, `make_greedy_generate_llm_only`,
`apply_top_p`, `warp_logits`).

Vision encode + packers + prefill once, then cached decode steps with
per-row EOS freezing: once a row has emitted EOS, every later position of
that row is `pad_token_id`. Right-padded ragged prompts are handled by
per-row KV-cache lengths.

`make_data_parallel_generate` splits a batch over the dp ranks of a mesh
(the JAX package's SPMD wrapper of the same name).

Greedy by default; `do_sample=True` with `temperature` / `top_p` draws
each token from `warp_logits` (temperature, then the nucleus filter), HF
generate's sampling knobs. The random stream is the port's own: the JAX
package folds one PRNG key with `fold_in` per step; the port takes an
integer seed (`rng=`) and, at every place the JAX package folds its key,
seeds a fresh `torch.Generator` on the logits' device with
`fold_seed(seed, index)`. A draw is then fixed by (seed, indices) alone,
not by the draws before it, and reads nothing back to the host. One seed
on one device gives the same tokens every run; the CPU's and the CUDA
card's streams differ from each other and from the JAX package's, so only
the law of the tokens is held against JAX.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.models.phi3 import KVCache


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest descending-probability prefix
    whose cumulative probability reaches `top_p` (at least one token), set
    the rest to -inf. A token survives iff its rank in a stable descending
    sort lies inside the kept prefix, so tokens that tie at the cutoff
    logit are cut by rank, not kept together."""
    logits = logits.float()
    order = torch.argsort(-logits, dim=-1, stable=True)
    probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # token i (descending) survives iff the mass before it is < top_p
    keep = (cum - probs < top_p).sum(dim=-1, keepdim=True).clamp_min(1)
    rank = torch.argsort(order, dim=-1, stable=True)
    return torch.where(rank < keep, logits,
                       torch.full_like(logits, float("-inf")))


def warp_logits(logits: torch.Tensor, temperature: float,
                top_p) -> torch.Tensor:
    """The sampling warp: temperature scale, then the nucleus filter."""
    logits = logits.float() / temperature
    if top_p is not None and top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    return logits


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_seed(seed: int, *indices: int) -> int:
    """The port's counterpart of the JAX package's `fold_in`: a 64-bit
    seed derived from `seed` and each index in turn by the splitmix64 mix,
    on the host, so that `fold_seed(s, i, j) == fold_seed(fold_seed(s, i),
    j)`. Distinct (seed, indices) give unrelated seeds; the same ones the
    same seed."""
    x = int(seed) & _MASK64
    for i in indices:
        # the odd multiplier keeps the mix asymmetric in (x, i)
        x = _splitmix64((x * 0xD1B54A32D192ED03 + _splitmix64(int(i) & _MASK64))
                        & _MASK64)
    return x


def seeded_generator(seed: int, device) -> torch.Generator:
    """A fresh generator on `device` seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def categorical(logits: torch.Tensor, gen: torch.Generator,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One draw per row from softmax(logits) over the last axis, by
    Gumbel-max as the JAX package's `categorical` draws: argmax(logits -
    log(-log u)) with u uniform in [tiny, 1), so a -inf logit is never
    drawn. Returns int32 (...,).

    `rows` = (offset, total): `logits` are rows offset.. of a global batch
    of `total` rows (a data-parallel rank's share): the uniforms of the
    whole global batch are drawn and this share's rows taken, so every
    layout draws the tokens of one process. Rows past `total` (padding)
    reuse the last row's uniforms."""
    if rows is None:
        u = torch.rand(logits.shape, generator=gen, device=logits.device,
                       dtype=torch.float32)
    else:
        offset, total = rows
        u = torch.rand((total,) + tuple(logits.shape[1:]), generator=gen,
                       device=logits.device, dtype=torch.float32)
        index = torch.arange(offset, offset + logits.shape[0],
                             device=logits.device).clamp(max=total - 1)
        u = u[index]
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (logits.float() - torch.log(-torch.log(u))).argmax(dim=-1).to(
        torch.int32)


def _make_next_token(do_sample: bool = False, temperature: float = 1.0,
                     top_p=None):
    """(logits (B, V), seed) -> token (B,) int32: argmax (the seed is not
    read), or a draw from `warp_logits` with a generator seeded by `seed`."""
    if not do_sample:
        return lambda logits, seed=None, rows=None: logits.argmax(dim=-1).to(
            torch.int32)
    if temperature <= 0:
        # HF raises too: dividing by 0 or a negative corrupts the law
        raise ValueError(
            f"temperature must be > 0 with do_sample (got {temperature}); "
            "use do_sample=False for greedy"
        )

    def next_token(logits, seed, rows=None):
        return categorical(warp_logits(logits, temperature, top_p),
                           seeded_generator(seed, logits.device), rows)

    return next_token


def _greedy_loop(step_fn, token, cache, n_steps, eos_token_id, pad_token_id,
                 next_token, rng, rows=None):
    """The decode loop both generators share: emits `n_steps` tokens from
    the prefill's first `token`, pad after EOS; step i (from 1) draws with
    seed `fold_seed(rng, i)` when sampling (`rows`: see `categorical`)."""
    done = torch.zeros_like(token, dtype=torch.bool)
    pad = torch.full_like(token, pad_token_id)
    out = []
    for i in range(n_steps):
        out.append(torch.where(done, pad, token))
        if i == n_steps - 1:
            break  # the JAX loop's last decode step feeds no output
        next_logits, cache = step_fn(token[:, None], cache)
        next_tok = next_token(next_logits,
                              None if rng is None else fold_seed(rng, i + 1),
                              rows)
        done = done | (token == eos_token_id)
        token = torch.where(done, pad, next_tok)
    return torch.stack(out, dim=1)


def _check_rng(do_sample: bool, rng) -> None:
    if do_sample and rng is None:
        raise ValueError("do_sample=True requires rng=")


def make_greedy_generate(
    model: HSENetVLM,
    *,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    cache_dtype=torch.bfloat16,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_p=None,
) -> Callable[..., torch.Tensor]:
    """Returns generate(input_ids, kv_lens, volume=None, slice_features=None,
    *, rng=None, rows=None) -> (B, max_new_tokens) int32 token ids (pad
    after EOS), on the model's device.

    `do_sample=True` draws each token from `warp_logits(logits,
    temperature, top_p)`; generate then requires `rng=`, an integer seed
    (the prefill's token draws with `fold_seed(rng, 0)`, decode step i with
    `fold_seed(rng, i)`, the JAX package's folds of its key). `rows` places
    the batch inside a global one (`categorical`)."""
    next_token = _make_next_token(do_sample, temperature, top_p)

    @torch.inference_mode()
    def generate(input_ids: torch.Tensor, kv_lens: torch.Tensor,
                 volume: Optional[torch.Tensor] = None,
                 slice_features: Optional[torch.Tensor] = None, *,
                 rng: Optional[int] = None,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        _check_rng(do_sample, rng)
        b, prompt_len = input_ids.shape
        cache = KVCache.create(
            model.config.llm, b, prompt_len + max_new_tokens,
            dtype=cache_dtype, device=input_ids.device,
        )
        logits, cache = model.prefill(
            input_ids, volume, slice_features, cache, kv_lens.to(torch.int32)
        )
        first = next_token(logits, None if rng is None else fold_seed(rng, 0),
                           rows)
        return _greedy_loop(model.decode_step, first, cache, max_new_tokens,
                            eos_token_id, pad_token_id, next_token, rng, rows)

    return generate


def make_data_parallel_generate(gen: Callable, mesh) -> Callable:
    """`gen` (generate(input_ids, kv_lens, *arrays, **kw) -> ids) over the
    mesh's dp ranks: the batch is padded to a multiple of dp by repeating
    its last row, each rank generates its contiguous share, and the ids are
    all-gathered and the padding sliced off, so every rank returns the ids
    of the whole batch. With `rng=` (sampling) each rank draws the noise of
    the unpadded global batch and takes its rows (`rows=`), so the tokens
    are those of one process. `gen` alone where dp is 1. The model's own
    placement (replicated, or tensor-parallel) is the caller's."""
    from hsenet_torch.parallel.mesh import all_gather, axis_group, axis_rank, axis_size

    dp = axis_size(mesh, "dp")
    if dp == 1:
        return gen
    rank, group = axis_rank(mesh, "dp"), axis_group(mesh, "dp")

    def wrapped(input_ids, kv_lens, *rest, **kwargs):
        b = input_ids.shape[0]
        pad = (-b) % dp
        n = (b + pad) // dp

        def mine(a):
            if a is None:
                return None
            a = torch.as_tensor(a)
            if pad:
                a = torch.cat([a] + [a[-1:]] * pad)
            return a[rank * n:(rank + 1) * n]

        if kwargs.get("rng") is not None:
            kwargs["rows"] = (rank * n, b)
        out = gen(mine(input_ids), mine(kv_lens), *[mine(a) for a in rest],
                  **kwargs)
        return all_gather(out.contiguous(), group, 0)[:b]

    return wrapped


def make_greedy_generate_llm_only(
    model,
    *,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    cache_dtype=torch.bfloat16,
    dynamic_steps: bool = False,
    do_sample: bool = False,
    temperature: float = 1.0,
    top_p=None,
) -> Callable[..., torch.Tensor]:
    """Text-only variant for a bare `Phi3ForCausalLM`: returns
    generate(input_ids, kv_lens, *, rng=None) -> (B, max_new_tokens) int32
    token ids (pad after EOS).

    `dynamic_steps=True` returns generate(input_ids, kv_lens, num_steps, *,
    rng=None): the budget is a per-call value, clamped to `max_new_tokens`
    (which sizes the output and the KV cache); positions past it are pad.
    `do_sample`, `temperature`, `top_p` and `rng=` as in
    `make_greedy_generate`."""
    next_token = _make_next_token(do_sample, temperature, top_p)

    def step(token, cache):
        logits, cache = model(token, cache=cache)
        return logits[:, 0], cache

    @torch.inference_mode()
    def run(input_ids, kv_lens, n_steps, rng):
        _check_rng(do_sample, rng)
        b, prompt_len = input_ids.shape
        cache = KVCache.create(
            model.config, b, prompt_len + max_new_tokens, dtype=cache_dtype,
            device=input_ids.device,
        )
        logits, cache = model(input_ids, kv_lens=kv_lens.to(torch.int32),
                              cache=cache, last_token_only=True)
        first = next_token(logits[:, 0],
                           None if rng is None else fold_seed(rng, 0))
        out = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.int32,
                         device=input_ids.device)
        if n_steps > 0:
            out[:, :n_steps] = _greedy_loop(step, first, cache, n_steps,
                                            eos_token_id, pad_token_id,
                                            next_token, rng)
        return out

    if dynamic_steps:
        def generate(input_ids: torch.Tensor, kv_lens: torch.Tensor,
                     num_steps, *, rng: Optional[int] = None) -> torch.Tensor:
            return run(input_ids, kv_lens,
                       max(0, min(int(num_steps), max_new_tokens)), rng)
    else:
        def generate(input_ids: torch.Tensor, kv_lens: torch.Tensor, *,
                     rng: Optional[int] = None) -> torch.Tensor:
            return run(input_ids, kv_lens, max_new_tokens, rng)

    return generate
