"""Batched greedy generation (the port of the JAX package's
eval/generate.py: `make_greedy_generate`, `make_greedy_generate_llm_only`,
`apply_top_p`, `warp_logits`).

Vision encode + packers + prefill once, then cached decode steps with
per-row EOS freezing: once a row has emitted EOS, every later position of
that row is `pad_token_id`. Right-padded ragged prompts are handled by
per-row KV-cache lengths.

`apply_top_p` and `warp_logits` are the sampling warp (temperature, then
the nucleus filter) as pure functions; drawing from it (`do_sample=True`)
waits for the sampling slice, because its random stream is the JAX
package's and only the distribution can be held against it.
"""

from __future__ import annotations

from typing import Callable, Optional

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


def _make_next_token(do_sample: bool = False):
    """logits (B, V) -> token (B,) int32 by argmax. Sampling raises: it
    waits for the sampling slice of the port."""
    if do_sample:
        raise NotImplementedError(
            "do_sample=True waits for the sampling slice of the port: its "
            "random stream is the JAX package's"
        )
    return lambda logits: logits.argmax(dim=-1).to(torch.int32)


def _greedy_loop(step_fn, token, cache, max_new_tokens, eos_token_id,
                 pad_token_id):
    """The decode loop both generators share: emits `max_new_tokens`
    tokens from the prefill's first `token`, pad after EOS."""
    next_token = _make_next_token()
    done = torch.zeros_like(token, dtype=torch.bool)
    pad = torch.full_like(token, pad_token_id)
    out = []
    for i in range(max_new_tokens):
        out.append(torch.where(done, pad, token))
        if i == max_new_tokens - 1:
            break  # the JAX loop's last decode step feeds no output
        next_logits, cache = step_fn(token[:, None], cache)
        next_tok = next_token(next_logits)
        done = done | (token == eos_token_id)
        token = torch.where(done, pad, next_tok)
    return torch.stack(out, dim=1)


def make_greedy_generate(
    model: HSENetVLM,
    *,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    cache_dtype=torch.bfloat16,
) -> Callable[..., torch.Tensor]:
    """Returns generate(input_ids, kv_lens, volume=None, slice_features=None)
    -> (B, max_new_tokens) int32 token ids (pad after EOS), on the model's
    device."""

    @torch.inference_mode()
    def generate(input_ids: torch.Tensor, kv_lens: torch.Tensor,
                 volume: Optional[torch.Tensor] = None,
                 slice_features: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        b, prompt_len = input_ids.shape
        cache = KVCache.create(
            model.config.llm, b, prompt_len + max_new_tokens,
            dtype=cache_dtype, device=input_ids.device,
        )
        logits, cache = model.prefill(
            input_ids, volume, slice_features, cache, kv_lens.to(torch.int32)
        )
        return _greedy_loop(model.decode_step, _make_next_token()(logits),
                            cache, max_new_tokens, eos_token_id, pad_token_id)

    return generate


def make_greedy_generate_llm_only(
    model,
    *,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    cache_dtype=torch.bfloat16,
) -> Callable[..., torch.Tensor]:
    """Text-only variant for a bare `Phi3ForCausalLM`: returns
    generate(input_ids, kv_lens) -> (B, max_new_tokens) int32 token ids
    (pad after EOS)."""

    def step(token, cache):
        logits, cache = model(token, cache=cache)
        return logits[:, 0], cache

    @torch.inference_mode()
    def generate(input_ids: torch.Tensor,
                 kv_lens: torch.Tensor) -> torch.Tensor:
        b, prompt_len = input_ids.shape
        cache = KVCache.create(
            model.config, b, prompt_len + max_new_tokens, dtype=cache_dtype,
            device=input_ids.device,
        )
        logits, cache = model(input_ids, kv_lens=kv_lens.to(torch.int32),
                              cache=cache, last_token_only=True)
        return _greedy_loop(step, _make_next_token()(logits[:, 0]), cache,
                            max_new_tokens, eos_token_id, pad_token_id)

    return generate
