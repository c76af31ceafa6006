"""Batched greedy generation (the port of the JAX package's
eval/generate.py::make_greedy_generate).

Vision encode + packers + prefill once, then cached decode steps with
per-row EOS freezing: once a row has emitted EOS, every later position of
that row is `pad_token_id`. Right-padded ragged prompts are handled by
per-row KV-cache lengths. Sampling (`apply_top_p`, `warp_logits`) comes
with a later slice.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.models.phi3 import KVCache


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
        token = logits.argmax(dim=-1).to(torch.int32)
        done = torch.zeros(b, dtype=torch.bool, device=input_ids.device)
        pad = torch.full_like(token, pad_token_id)
        out = []
        for i in range(max_new_tokens):
            out.append(torch.where(done, pad, token))
            if i == max_new_tokens - 1:
                break  # the JAX loop's last decode step feeds no output
            next_logits, cache = model.decode_step(token[:, None], cache)
            next_tok = next_logits.argmax(dim=-1).to(torch.int32)
            done = done | (token == eos_token_id)
            token = torch.where(done, pad, next_tok)
        return torch.stack(out, dim=1)

    return generate
