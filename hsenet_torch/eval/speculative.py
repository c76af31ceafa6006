"""Prompt-lookup speculative decoding, greedy and lossless (the port of the
JAX package's eval/speculative.py: `pld_round`, `make_pld_generate_llm_only`,
`make_pld_generate`).

Each round drafts `draft_len` tokens per row by prompt lookup: the latest
earlier occurrence of the row's trailing n-gram in its own context (prompt
+ committed tokens) proposes the tokens that followed it. No draft model.
One forward over [pending, drafts] (the chunked-prefill path of the
decoder: per-row causal offsets over the KV cache) scores all of them; the
longest prefix of drafts that equals the target's argmax is accepted, and
the argmax after it becomes the next pending token. So every committed
token is the greedy token, and a round commits 1 to draft_len + 1 of them
for the cost of about one decode step at batch-1 widths, where decode reads
every weight once per forward whatever the number of rows.

Mechanics, as in the JAX package: the n-gram match is a shifted compare
over the whole context buffer on the device; a partial acceptance rolls the
KV cache back by rewriting `cache.lengths` alone (the rejected entries lie
past the row's length, masked, and the next verify overwrites them).

The 1-token decode forward and the multi-token verify forward sum in
different orders, so at a genuine near-tie of the top two logits (a margin
at rounding scale) the two can pick different tokens; away from ties the
output equals greedy decoding token for token. Speculative sampling
(`pld_round(sample=...)`) waits for the sampling slice of the port.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.models.phi3 import KVCache


def _write_rows(buf: torch.Tensor, vals: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor) -> torch.Tensor:
    """buf[b, starts[b] + i] = vals[b, i] for i < counts[b], in place. A
    start is clamped to [0, C - width] first, as `dynamic_update_slice`
    clamps it."""
    width = vals.shape[1]
    steps = torch.arange(width, device=buf.device)
    cols = starts.long().clamp(0, buf.shape[1] - width)[:, None] + steps
    keep = steps[None, :] < counts[:, None]
    buf.scatter_(1, cols, torch.where(keep, vals.to(buf.dtype),
                                      buf.gather(1, cols)))
    return buf


def pld_round(verify_fn: Callable, pending: torch.Tensor, cache: KVCache,
              ctx: torch.Tensor, ctx_len: torch.Tensor, done: torch.Tensor,
              emitted: torch.Tensor, limit: torch.Tensor, *, draft_len: int,
              ngram: int, eos_token_id: int, pad_token_id: int, sample=None):
    """One prompt-lookup draft + verify + accept round over B rows.

    State (device tensors; `ctx`, `ctx_len` and the cache change in place):
      pending (B,)   the next unverified greedy token per row
      cache          KVCache positioned at each row's committed length
      ctx (B, C)     prompt + committed tokens (+ pending at ctx_len - 1)
      ctx_len (B,)   live length of `ctx` (pending included)
      done (B,)      frozen rows: they neither draft nor advance
      emitted (B,)   tokens committed so far, against `limit`

    `verify_fn(tokens (B, draft_len + 1), cache) -> (logits (B, draft_len
    + 1, V), cache)` runs the multi-token decode over the cache.

    Returns (pending, cache, ctx, ctx_len, done, emitted, inputs, commit):
    this round's (B, draft_len + 1) candidates and how many of each row's
    candidates were committed (0 for done rows); the caller writes
    `inputs[:, :commit]` where it keeps its output."""
    if sample is not None:
        raise NotImplementedError(
            "speculative sampling (pld_round(sample=...)) waits for the "
            "sampling slice of the port")
    k = draft_len
    b, ctx_cap = ctx.shape
    kv_cap = cache.k.shape[3]
    dev = ctx.device

    # ---- draft: the latest earlier occurrence of the trailing n-gram ----
    grams = torch.arange(ngram, device=dev)
    key_at = (ctx_len.long() - ngram).clamp(0, ctx_cap - ngram)[:, None] + grams
    key = ctx.gather(1, key_at)
    n_win = ctx_cap - ngram + 1
    match = torch.ones((b, n_win), dtype=torch.bool, device=dev)
    for j in range(ngram):
        match &= ctx[:, j:j + n_win] == key[:, j:j + 1]
    widx = torch.arange(n_win, device=dev)[None, :]
    # a window must end strictly before the trailing key (pending sits at
    # ctx_len - 1)
    match &= widx + ngram < ctx_len[:, None]
    p = torch.where(match, widx, -1).amax(dim=1)  # -1: no match
    start = (p + ngram).clamp(0, ctx_cap - k)
    dpos = start[:, None] + torch.arange(k, device=dev)
    drafts = ctx.gather(1, dpos)
    valid = (p >= 0)[:, None] & (dpos < ctx_len[:, None])
    drafts = torch.where(valid, drafts, torch.full_like(drafts, pad_token_id))

    # ---- verify: one multi-token forward over [pending, drafts] ----
    inputs = torch.cat([pending[:, None].to(drafts.dtype), drafts], dim=1)
    lengths = cache.lengths  # the decoder replaces, never edits, this tensor
    logits, cache = verify_fn(inputs, cache)
    greedy = logits.argmax(dim=-1).to(torch.int32)  # (B, k + 1)
    ok = torch.cumprod((drafts == greedy[:, :k]).to(torch.int32), dim=1)
    a = ok.sum(dim=1)  # accepted drafts per row, 0..k
    new_pending = greedy.gather(1, a[:, None].long())[:, 0]

    # committed = inputs[:, :a + 1], cut at EOS and at the budget
    pos = torch.arange(k + 1, device=dev)[None, :]
    is_eos = (inputs == eos_token_id) & (pos <= a[:, None])
    eos_pos = torch.where(is_eos, pos, k + 1).amin(dim=1)
    commit = torch.minimum(a + 1, eos_pos + 1)
    commit = torch.minimum(commit, limit - emitted)
    commit = torch.where(done, torch.zeros_like(commit), commit).to(torch.int32)
    emitted = emitted + commit
    hit_eos = eos_pos <= a

    # append the accepted drafts and the new pending token to the context
    app = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    app.scatter_(1, a[:, None].long(), new_pending[:, None].to(app.dtype))
    n_app = torch.where(done | hit_eos, torch.zeros_like(a), a + 1)
    ctx = _write_rows(ctx, app, ctx_len, n_app)
    ctx_len = ctx_len + n_app.to(ctx_len.dtype)

    # cache rollback: only the lengths move, clamped so that a finished
    # row's (k + 1)-wide write never leaves the buffer
    adv = torch.where(done, torch.zeros_like(a), a + 1)
    cache.lengths = torch.minimum(lengths + adv.to(lengths.dtype),
                                  torch.full_like(lengths, kv_cap - (k + 1)))
    done = done | hit_eos | (emitted >= limit)
    return new_pending, cache, ctx, ctx_len, done, emitted, inputs, commit


def _pld_decode_loop(verify_fn: Callable, pending: torch.Tensor,
                     cache: KVCache, input_ids: torch.Tensor,
                     kv_lens: torch.Tensor, *, max_new_tokens: int,
                     eos_token_id: int, pad_token_id: int, draft_len: int,
                     ngram: int, budget=None):
    """Verify rounds until every row is done (one host check per round).
    Returns (tokens (B, max_new_tokens), rounds, emitted (B,))."""
    k = draft_len
    b, prompt_len = input_ids.shape
    dev = input_ids.device
    limit = torch.full((b,), max_new_tokens, dtype=torch.int32, device=dev)
    if budget is not None:
        limit = torch.minimum(limit, torch.as_tensor(
            budget, dtype=torch.int32, device=dev).expand(b))
    # prompt + committed + pending, with slack so that the append of a last
    # over-budget round never clamps
    ctx_cap = prompt_len + max_new_tokens + 2 * k + 2
    ctx = torch.zeros((b, ctx_cap), dtype=torch.int32, device=dev)
    ctx[:, :prompt_len] = input_ids.to(torch.int32)
    rows = torch.arange(b, device=dev)
    ctx[rows, kv_lens.long()] = pending
    ctx_len = kv_lens.to(torch.int32) + 1
    out = torch.full((b, max_new_tokens + k + 1), pad_token_id,
                     dtype=torch.int32, device=dev)
    out_pos = torch.zeros(b, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    rounds = 0
    while not bool(done.all()):
        (pending, cache, ctx, ctx_len, done, new_pos, inputs,
         commit) = pld_round(
            verify_fn, pending, cache, ctx, ctx_len, done, out_pos, limit,
            draft_len=k, ngram=ngram, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id,
        )
        out = _write_rows(out, inputs, out_pos, commit)
        out_pos = new_pos
        rounds += 1
    return out[:, :max_new_tokens], rounds, out_pos


def make_pld_generate_llm_only(
    model,
    *,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    draft_len: int = 7,
    ngram: int = 2,
    cache_dtype=torch.bfloat16,
    collect_stats: bool = False,
) -> Callable:
    """Prompt-lookup greedy decode for a bare `Phi3ForCausalLM`: returns
    generate(input_ids, kv_lens, num_tokens=None) -> (B, max_new_tokens)
    int32 token ids, pad after EOS, equal to
    `make_greedy_generate_llm_only`'s in fewer forwards. `num_tokens`
    (<= max_new_tokens) is a per-call budget. With `collect_stats` it
    returns (tokens, verify rounds, tokens emitted per row)."""

    @torch.inference_mode()
    def generate(input_ids: torch.Tensor, kv_lens: torch.Tensor,
                 num_tokens=None):
        b, prompt_len = input_ids.shape
        kv_lens = kv_lens.to(torch.int32)
        cache = KVCache.create(
            model.config, b, prompt_len + max_new_tokens + draft_len + 1,
            dtype=cache_dtype, device=input_ids.device,
        )
        logits, cache = model(input_ids, kv_lens=kv_lens, cache=cache,
                              last_token_only=True)
        pending = logits[:, 0].argmax(dim=-1).to(torch.int32)
        verify_lens = torch.full((b,), draft_len + 1, dtype=torch.int32,
                                 device=input_ids.device)

        def verify(tokens, cache):
            return model(tokens, cache=cache, kv_lens=verify_lens)

        tokens, rounds, emitted = _pld_decode_loop(
            verify, pending, cache, input_ids, kv_lens,
            max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, draft_len=draft_len, ngram=ngram,
            budget=num_tokens,
        )
        if collect_stats:
            return tokens, rounds, emitted
        return tokens

    return generate


def make_pld_generate(
    model: HSENetVLM,
    *,
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int = 0,
    draft_len: int = 7,
    ngram: int = 2,
    cache_dtype=torch.bfloat16,
) -> Callable:
    """Prompt-lookup greedy decode for the VLM: vision encode, packers and
    the multimodal prefill once, then verify rounds on the LLM. Returns
    generate(input_ids, kv_lens, volume=None, slice_features=None), the
    contract of `eval.generate.make_greedy_generate`."""

    @torch.inference_mode()
    def generate(input_ids: torch.Tensor, kv_lens: torch.Tensor,
                 volume: Optional[torch.Tensor] = None,
                 slice_features: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        b, prompt_len = input_ids.shape
        kv_lens = kv_lens.to(torch.int32)
        cache = KVCache.create(
            model.config.llm, b, prompt_len + max_new_tokens + draft_len + 1,
            dtype=cache_dtype, device=input_ids.device,
        )
        logits, cache = model.prefill(input_ids, volume, slice_features,
                                      cache, kv_lens)
        pending = logits.argmax(dim=-1).to(torch.int32)
        verify_lens = torch.full((b,), draft_len + 1, dtype=torch.int32,
                                 device=input_ids.device)

        def verify(tokens, cache):
            return model.verify_step(tokens, cache, verify_lens)

        tokens, _, _ = _pld_decode_loop(
            verify, pending, cache, input_ids, kv_lens,
            max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, draft_len=draft_len, ngram=ngram,
        )
        return tokens

    return generate
