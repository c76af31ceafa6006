"""Continuous-batching serving engine: fixed decode slots, chunked decode,
two admission caches (the port of the JAX package's serving.py).

  * a fixed number of decode SLOTS: the live KV cache has one row per slot
    and never changes shape as requests come and go;
  * per-slot prefill: one batch-1 prefill writes the request's keys and
    values straight into a view of its slot's row of the live cache (the
    JAX package builds a separate row and copies it in, because its arrays
    are immutable). Whatever an earlier request left in the slot beyond
    the new row's length is never read: the row's `lengths` bounds every
    attention read;
  * decode runs in CHUNKS of `chunk_size` steps as a loop over device
    tensors with no host synchronisation inside; the emitted tokens are
    stacked and copied to the host once per chunk, and admission happens at
    chunk boundaries;
  * a slot that hits EOS mid-chunk freezes (emits pad, latches its `done`
    flag, keeps its cache length) and is reaped and refilled at the next
    boundary: per-request tokens equal batch-1 greedy decode.

Two admission caches serve repeat-volume traffic (several questions about
one scan): `volume_cache_size` keeps the image FEATURES per volume (a hit
runs splice + LLM prefill, no towers); `kv_prefix_cache_size` keeps the
keys and values of the BOS + image-block PREFIX per volume (a hit prefills
the question chunk only). A prefix miss costs nothing extra: the cached
prefix is sliced out of the row the full prefill built.

With `speculative=True` a chunk is `chunk_size` prompt-lookup verify
ROUNDS (`eval/speculative.pld_round`): each round drafts `draft_len` tokens
per slot from the slot's own context and verifies them in one forward over
the live cache, committing 1 to draft_len + 1 greedy tokens, so the tokens
stay those of the greedy engine. The per-slot context buffer, its length
and the token budget live on the device; the candidates and commit counts
of a chunk's rounds reach the host in one copy.

The engine is greedy. Sampling (`do_sample=True`, and so speculative
sampling) and a device mesh (`mesh=`) wait for later slices of the port
and raise `NotImplementedError`.
"""

from __future__ import annotations

import hashlib
import itertools
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hsenet_torch import resolve_device
from hsenet_torch.eval.generate import _make_next_token
from hsenet_torch.eval.speculative import pld_round
from hsenet_torch.models.phi3 import KVCache


@dataclass
class _Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new: int
    volume: Optional[np.ndarray] = None  # (1, C, D, H, W), multimodal only
    slices: Optional[np.ndarray] = None  # (1, n_slices, feat_dim)
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0  # perf_counter at submit (latency stats)
    # perf_counter when the first output token reached the host (tokens
    # arrive with the one copy after each decode chunk)
    first_token_at: float = 0.0


class ServingEngine:
    """Greedy continuous-batching engine over a causal-LM module of the
    port, whose weights are already on `device`.

    Usage:
        eng = ServingEngine(model, eos_token_id=2)
        uid = eng.submit([1, 17, 93, ...])           # any number of these
        results = eng.run_until_drained()            # {uid: [tokens...]}
    or incrementally: `eng.step()` runs one admit + decode-chunk cycle and
    returns the requests finished in that cycle.

    With `multimodal=True`, `model` is an `HSENetVLM` and each submit also
    carries the CT volume (+ optional precomputed slice features); the
    prompt must contain the image-placeholder block the splice overwrites
    (BOS + num_image_tokens + text, as the datasets lay it out).
    """

    def __init__(
        self,
        model,
        *,
        eos_token_id: int,
        pad_token_id: int = 0,
        num_slots: int = 8,
        prompt_cap: int = 512,
        max_new_tokens: int = 512,
        chunk_size: int = 16,
        cache_dtype=torch.bfloat16,
        mesh=None,
        multimodal: bool = False,
        do_sample: bool = False,
        speculative: bool = False,
        draft_len: int = 7,
        ngram: int = 2,
        volume_cache_size: int = 0,
        kv_prefix_cache_size: int = 0,
        device="cuda",
    ):
        for flag, what in (
            (do_sample, "do_sample=True waits for the sampling slice of "
                        "the port"),
            (mesh is not None, "mesh= waits for the parallel slice of the "
                               "port"),
        ):
            if flag:
                raise NotImplementedError(what)
        self.device = resolve_device(device)
        self.model = model
        self.eos = eos_token_id
        self.pad = pad_token_id
        self.num_slots = num_slots
        self.prompt_cap = prompt_cap
        self.max_new = max_new_tokens
        self.chunk = chunk_size
        self.multimodal = multimodal
        self.speculative = speculative
        self.draft_len = draft_len
        self.ngram = ngram
        if speculative:
            # a verify writes draft_len + 1 entries at each row's offset, and
            # the budget may overshoot by one round before `done` latches
            # (pld_round clamps at capacity - (draft_len + 1) besides)
            self.capacity = prompt_cap + max_new_tokens + 2 * (draft_len + 1)
        else:
            self.capacity = prompt_cap + max_new_tokens + chunk_size
        self._next_token = _make_next_token()

        cfg = model.config.llm if multimodal else model.config
        self._cache = KVCache.create(cfg, num_slots, self.capacity,
                                     dtype=cache_dtype, device=self.device)
        self._token = torch.zeros(num_slots, dtype=torch.int32,
                                  device=self.device)
        # all slots start free
        self._done = torch.ones(num_slots, dtype=torch.bool,
                                device=self.device)
        if speculative:
            # per-slot context for drafting, and the budget state on the
            # device (a free slot has limit 0, so it commits nothing)
            zeros = dict(dtype=torch.int32, device=self.device)
            self._ctx = torch.zeros((num_slots, self.capacity), **zeros)
            self._ctx_len = torch.zeros(num_slots, **zeros)
            self._emitted = torch.zeros(num_slots, **zeros)
            self._limit = torch.zeros(num_slots, **zeros)
        self.verify_rounds_used = 0  # active-slot verify rounds (speculative)
        self.tokens_committed = 0
        self._slots: List[Optional[_Request]] = [None] * num_slots
        self._queue: List[_Request] = []
        self._uid = itertools.count()
        self.steps_run = 0
        self.slot_steps_used = 0  # active-slot steps (utilization stat)
        self.latencies: List[float] = []  # submit -> finish wall per request
        # TTFT = submit -> first token on the host: queueing + prefill + the
        # steps left of the chunk in flight, seen at chunk granularity
        self.ttfts: List[float] = []
        # time per output token after the first: (finish - first token) /
        # (n_tokens - 1) per finished request
        self.tpots: List[float] = []

        for size, name, what in (
            (volume_cache_size, "volume_cache_size", "image features"),
            (kv_prefix_cache_size, "kv_prefix_cache_size", "prefix KV"),
        ):
            if size > 0 and not multimodal:
                raise ValueError(f"{name} requires multimodal=True")
            if size > 0 and model.config.tower_mode == "med2e3":
                raise ValueError(
                    f"{name} is incompatible with tower_mode='med2e3' (its "
                    f"{what} depend on the prompt)"
                )
        # volume-feature LRU, keyed by the bytes of the volume (+ slice
        # features): a hit pays no vision towers at admission
        self.volume_cache_size = volume_cache_size
        self._vol_cache: "OrderedDict[bytes, torch.Tensor]" = OrderedDict()
        self.encode_hits = 0
        self.encode_misses = 0
        # KV-prefix LRU, one level above: the prompt prefix (BOS + the
        # image-placeholder block) is the same for every question about one
        # scan and its keys and values depend only on (volume, slices,
        # prefix ids), so the first 1 + num_image_tokens entries of a full
        # prefill are reusable as they are
        self.kv_prefix_cache_size = kv_prefix_cache_size
        self._prefix_len = 1 + model.config.num_image_tokens if multimodal else 0
        self._kv_prefix_cache: (
            "OrderedDict[bytes, Tuple[torch.Tensor, ...]]") = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0

    # ---- public API ----

    def submit(
        self,
        prompt_ids,
        max_new: Optional[int] = None,
        *,
        volume=None,
        slice_features=None,
        submitted_at: Optional[float] = None,
    ) -> int:
        """`submitted_at` (perf_counter clock) backdates the latency clock
        to the request's true arrival: an open-loop caller only gets to
        call submit() between engine steps, so a stamp taken at the call
        would leave up to one decode chunk of queueing out of TTFT."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) > self.prompt_cap:
            raise ValueError(
                f"prompt length {len(prompt)} > prompt_cap {self.prompt_cap}"
            )
        if self.multimodal and volume is None:
            raise ValueError("multimodal engine: submit() requires volume=")
        if not self.multimodal and volume is not None:
            raise ValueError("volume= requires ServingEngine(multimodal=True)")
        if self.multimodal:
            vcfg = self.model.config.vision
            expect = (vcfg.in_channels, *vcfg.image_size)
            got = tuple(np.shape(volume)[-4:])
            if got != expect:
                raise ValueError(
                    f"volume shape {np.shape(volume)} does not match the "
                    f"model's (C, D, H, W) = {expect}"
                )
        req = _Request(
            uid=next(self._uid),
            prompt=prompt,
            max_new=min(max_new or self.max_new, self.max_new),
            volume=None if volume is None
            else np.asarray(volume).reshape((1,) + np.shape(volume)[-4:]),
            slices=None if slice_features is None
            else np.asarray(slice_features).reshape(
                (1,) + np.shape(slice_features)[-2:]
            ),
            submitted_at=(
                time.perf_counter() if submitted_at is None else submitted_at
            ),
        )
        self._queue.append(req)
        return req.uid

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def pending(self) -> int:
        return len(self._queue)

    @torch.inference_mode()
    def step(self) -> Dict[int, List[int]]:
        """Admit queued requests into free slots, decode one chunk, reap
        finished requests. Returns {uid: tokens} finished this cycle."""
        self._admit()
        if self.active == 0:
            return {}
        if self.speculative:
            return self._step_spec()
        block = self._decode_chunk().cpu().numpy()  # the one host sync
        now = time.perf_counter()  # when this chunk's tokens became visible
        self.steps_run += self.chunk
        finished: Dict[int, List[int]] = {}
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            self.slot_steps_used += self.chunk
            fresh = not req.tokens
            for t in block[s]:
                t = int(t)
                if req.done:
                    break
                req.tokens.append(t)
                if t == self.eos or len(req.tokens) >= req.max_new:
                    req.done = True
            if fresh and req.tokens:
                req.first_token_at = now
                self.ttfts.append(now - req.submitted_at)
            if req.done:
                finished[req.uid] = req.tokens
                self.latencies.append(now - req.submitted_at)
                if len(req.tokens) > 1:
                    self.tpots.append(
                        (now - req.first_token_at) / (len(req.tokens) - 1)
                    )
                self._slots[s] = None
                self._done[s] = True
        return finished

    def _step_spec(self) -> Dict[int, List[int]]:
        """One speculative cycle: `chunk_size` verify rounds, then each
        round's committed window per slot (the rounds already cut at EOS
        and at the budget, and commit nothing for done rows)."""
        blocks, counts = (t.cpu().numpy() for t in self._spec_chunk())
        now = time.perf_counter()  # when this chunk's tokens became visible
        self.steps_run += self.chunk
        finished: Dict[int, List[int]] = {}
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            self.slot_steps_used += self.chunk
            fresh = not req.tokens
            for r in range(self.chunk):
                n = int(counts[r, s])
                if n:
                    self.verify_rounds_used += 1
                    self.tokens_committed += n
                for t in blocks[r, s, :n]:
                    t = int(t)
                    if req.done:
                        break
                    req.tokens.append(t)
                    if t == self.eos or len(req.tokens) >= req.max_new:
                        req.done = True
                if req.done:
                    break
            if fresh and req.tokens:
                req.first_token_at = now
                self.ttfts.append(now - req.submitted_at)
            if req.done:
                finished[req.uid] = req.tokens
                self.latencies.append(now - req.submitted_at)
                if len(req.tokens) > 1:
                    self.tpots.append(
                        (now - req.first_token_at) / (len(req.tokens) - 1)
                    )
                self._slots[s] = None
                self._done[s] = True
        return finished

    @property
    def mean_accepted(self) -> float:
        """Mean committed tokens per verify round (1 = no draft accepted,
        draft_len + 1 = all accepted); speculative mode only."""
        if not self.verify_rounds_used:
            return 0.0
        return self.tokens_committed / self.verify_rounds_used

    def latency_stats(self) -> Dict[str, float]:
        """Submit-to-finish wall-clock percentiles over finished requests
        (queueing included), plus TTFT and TPOT percentiles when any
        request has recorded them."""
        if not self.latencies:
            return {}

        def pct(arr, q):
            a = np.sort(np.asarray(arr))
            return float(a[min(int(q * len(a)), len(a) - 1)])

        out = {
            "p50_s": pct(self.latencies, 0.50),
            "p95_s": pct(self.latencies, 0.95),
            "max_s": float(max(self.latencies)),
            "mean_s": float(np.mean(self.latencies)),
        }
        if self.ttfts:
            out["ttft_p50_s"] = pct(self.ttfts, 0.50)
            out["ttft_p99_s"] = pct(self.ttfts, 0.99)
            out["ttft_max_s"] = float(max(self.ttfts))
        if self.tpots:
            out["tpot_p50_s"] = pct(self.tpots, 0.50)
            out["tpot_p99_s"] = pct(self.tpots, 0.99)
        return out

    def run_until_drained(self) -> Dict[int, List[int]]:
        """Run cycles until every submitted request has finished."""
        results: Dict[int, List[int]] = {}
        while self._queue or self.active:
            results.update(self.step())
        return results

    @property
    def utilization(self) -> float:
        """Fraction of decoded slot-steps that belonged to live requests."""
        total = self.steps_run * self.num_slots
        return self.slot_steps_used / total if total else 0.0

    def hbm_stats(self) -> Dict[str, float]:
        """Device memory of the engine's card in GB: in use, limit,
        headroom and peak, from the allocator's `torch.cuda.memory_stats`
        (slot-count sizing needs this). {} on the CPU."""
        if self.device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(self.device)
        gb = 1 / 1e9
        out = {
            "in_use_gb": stats.get("allocated_bytes.all.current", 0) * gb,
            "limit_gb": torch.cuda.get_device_properties(
                self.device).total_memory * gb,
            "peak_gb": stats.get("allocated_bytes.all.peak", 0) * gb,
        }
        out["headroom_gb"] = out["limit_gb"] - out["in_use_gb"]
        return out

    # ---- internals ----

    def _decode_chunk(self) -> torch.Tensor:
        """`chunk_size` decode steps over every slot, no host sync inside.
        Returns the emitted tokens (num_slots, chunk) on the device."""
        cache, token, done = self._cache, self._token, self._done
        pad = torch.full_like(token, self.pad)
        emitted = []
        for _ in range(self.chunk):
            emitted.append(torch.where(done, pad, token))
            if self.multimodal:
                logits, cache = self.model.decode_step(token[:, None], cache)
            else:
                logits, cache = self.model(token[:, None], cache=cache)
                logits = logits[:, 0]
            done_next = done | (token == self.eos)
            nxt = torch.where(done_next, pad, self._next_token(logits))
            # the decoder added 1 to every row's length: free and finished
            # slots must not advance (their rows are overwritten at the
            # next admission, but a length past capacity would clamp the
            # writes), so undo it for frozen rows, clamped at 0 for slots
            # never used
            cache.lengths.sub_(done.to(cache.lengths.dtype)).clamp_(min=0)
            token, done = nxt, done_next
        self._cache, self._token, self._done = cache, token, done
        return torch.stack(emitted, dim=1)

    def _spec_chunk(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """`chunk_size` verify rounds over every slot, no host sync inside.
        Returns the rounds' candidates (chunk, slots, draft_len + 1) and
        commit counts (chunk, slots) on the device."""
        verify_lens = torch.full((self.num_slots,), self.draft_len + 1,
                                 dtype=torch.int32, device=self.device)

        def verify(tokens, cache):
            if self.multimodal:
                return self.model.verify_step(tokens, cache, verify_lens)
            return self.model(tokens, cache=cache, kv_lens=verify_lens)

        toks, counts = [], []
        for _ in range(self.chunk):
            (self._token, self._cache, self._ctx, self._ctx_len, self._done,
             self._emitted, inputs, commit) = pld_round(
                verify, self._token, self._cache, self._ctx, self._ctx_len,
                self._done, self._emitted, self._limit,
                draft_len=self.draft_len, ngram=self.ngram,
                eos_token_id=self.eos, pad_token_id=self.pad,
            )
            toks.append(inputs)
            counts.append(commit)
        return torch.stack(toks), torch.stack(counts)

    def _slot_row(self, s: int) -> KVCache:
        """A batch-1 cache that is a view of slot `s` of the live cache,
        with length 0: a prefill into it writes the slot in place."""
        c = self._cache
        quant = c.quantized
        return KVCache(
            k=c.k[:, s:s + 1], v=c.v[:, s:s + 1],
            lengths=torch.zeros(1, dtype=torch.int32, device=self.device),
            k_scale=c.k_scale[:, s:s + 1] if quant else None,
            v_scale=c.v_scale[:, s:s + 1] if quant else None,
        )

    def _slice_prefix(self, row: KVCache) -> Tuple[torch.Tensor, ...]:
        """Copies of the first prefix_len entries of a freshly prefilled
        row, the part that depends on the volume alone (+ their scales on
        an int8 cache; both index token axis 3)."""
        n = self._prefix_len
        out = (row.k[:, :, :, :n].clone(), row.v[:, :, :, :n].clone())
        if row.quantized:
            out += (row.k_scale[:, :, :, :n].clone(),
                    row.v_scale[:, :, :, :n].clone())
        return out

    def _volume_hash(self, req: _Request):
        h = hashlib.blake2b(req.volume.tobytes(), digest_size=16)
        if req.slices is not None:
            h.update(req.slices.tobytes())
        return h

    def _to_device(self, array: Optional[np.ndarray]):
        return None if array is None else torch.as_tensor(array).to(self.device)

    def _cached_features(self, req: _Request) -> torch.Tensor:
        """LRU lookup of the request's image features; on a miss, run the
        towers and packers and keep up to `volume_cache_size` blocks."""
        key = self._volume_hash(req).digest()
        feats = self._vol_cache.get(key)
        if feats is not None:
            self._vol_cache.move_to_end(key)
            self.encode_hits += 1
            return feats
        self.encode_misses += 1
        feats = self.model.encode_images_only(
            self._to_device(req.volume), self._to_device(req.slices))
        self._vol_cache[key] = feats
        while len(self._vol_cache) > self.volume_cache_size:
            self._vol_cache.popitem(last=False)
        return feats

    def _prefix_key(self, req: _Request) -> bytes:
        """The prefix KV is a function of the volume (+ slice features)
        and the prefix token ids."""
        h = self._volume_hash(req)
        h.update(np.asarray(req.prompt[: self._prefix_len], np.int32).tobytes())
        return h.digest()

    def _padded(self, tokens: np.ndarray, cap: int):
        """(ids (1, cap) right-padded, valid length (1,)) on the device."""
        ids = np.full((1, cap), self.pad, np.int32)
        ids[0, : len(tokens)] = tokens
        return (self._to_device(ids),
                torch.tensor([len(tokens)], dtype=torch.int32,
                             device=self.device))

    def _prefill(self, req: _Request, row: KVCache) -> torch.Tensor:
        """Prefill the request into `row` (its slot's view) by the cheapest
        admission its caches allow. Returns the last-token logits (1, V)."""
        model = self.model
        pkey = pkv = None
        if self.kv_prefix_cache_size > 0 and len(req.prompt) > self._prefix_len:
            pkey = self._prefix_key(req)
            pkv = self._kv_prefix_cache.get(pkey)
        if pkv is not None:
            # prefix hit: seed the row with the cached BOS + image-block KV
            # and prefill the question chunk alone, from offset prefix_len
            self._kv_prefix_cache.move_to_end(pkey)
            self.prefix_hits += 1
            n = self._prefix_len
            targets = (row.k, row.v) + (
                (row.k_scale, row.v_scale) if row.quantized else ())
            for target, cached in zip(targets, pkv):
                target[:, :, :, :n] = cached
            row.lengths.fill_(n)
            q_ids, q_len = self._padded(req.prompt[n:], self.prompt_cap - n)
            logits, _ = model.prefill_continue(q_ids, row, q_len)
            return logits
        ids, kv_len = self._padded(req.prompt, self.prompt_cap)
        if not self.multimodal:
            logits, _ = model(ids, kv_lens=kv_len, cache=row,
                              last_token_only=True)
            logits = logits[:, 0]
        elif self.volume_cache_size > 0:
            logits, _ = model.prefill_with_features(
                ids, self._cached_features(req), row, kv_len)
        else:
            logits, _ = model.prefill(
                ids, self._to_device(req.volume), self._to_device(req.slices),
                row, kv_len)
        if pkey is not None:
            # miss: keep this row's prefix KV for the next question about
            # the same volume (no extra compute)
            self.prefix_misses += 1
            self._kv_prefix_cache[pkey] = self._slice_prefix(row)
            while len(self._kv_prefix_cache) > self.kv_prefix_cache_size:
                self._kv_prefix_cache.popitem(last=False)
        return logits

    def _admit(self) -> None:
        for s in range(self.num_slots):
            if self._slots[s] is not None or not self._queue:
                continue
            req = self._queue.pop(0)
            row = self._slot_row(s)
            logits = self._prefill(req, row)
            # the prefill's argmax becomes the slot's pending token; the
            # decode chunk emits it as the request's first output
            self._cache.lengths[s] = row.lengths[0]
            self._token[s] = self._next_token(logits)[0]
            self._done[s] = False
            if self.speculative:
                self._seed_context(s, req)
            self._slots[s] = req

    def _seed_context(self, s: int, req: _Request) -> None:
        """The speculative state of a newly admitted slot: its context is
        the padded prompt with the first token after the prompt; its budget
        starts anew."""
        n = len(req.prompt)
        self._ctx[s].zero_()
        self._ctx[s, : self.prompt_cap] = self.pad
        self._ctx[s, :n] = torch.as_tensor(req.prompt, device=self.device)
        self._ctx[s, n] = self._token[s]
        self._ctx_len[s] = n + 1
        self._emitted[s] = 0
        self._limit[s] = req.max_new


def run_open_loop(engine: ServingEngine, requests, arrival_offsets):
    """Drive the engine under an OPEN-LOOP arrival process: each request is
    submitted when its arrival offset (seconds from start) comes due,
    whatever the service progress, stepping the engine whenever work is in
    flight and sleeping to the next arrival when idle.

    `requests` is a list of kwargs dicts for `engine.submit` (at least
    `prompt_ids`); `arrival_offsets` the matching offsets (any order).
    Returns `({uid: tokens}, makespan_seconds)`; latency percentiles are
    read from `engine.latency_stats()` afterwards."""
    if len(requests) != len(arrival_offsets):
        raise ValueError("requests and arrival_offsets differ in length")
    order = sorted(range(len(requests)), key=lambda i: arrival_offsets[i])
    results: Dict[int, List[int]] = {}
    n = len(requests)
    i = 0
    t0 = time.perf_counter()
    while len(results) < n:
        now = time.perf_counter() - t0
        while i < n and arrival_offsets[order[i]] <= now:
            # backdate the latency clock to the SCHEDULED arrival: this
            # loop regains control only between engine steps
            engine.submit(
                **requests[order[i]],
                submitted_at=t0 + arrival_offsets[order[i]],
            )
            i += 1
        if engine.active == 0 and engine.pending == 0:
            # nothing in flight: sleep to the next arrival
            wait = arrival_offsets[order[i]] - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            continue
        results.update(engine.step())
    return results, time.perf_counter() - t0


def engine_generate_fn(engine: ServingEngine):
    """Adapter: run a batched eval harness through a `ServingEngine`.

    Returns generate(input_ids, kv_lens, volume=None, slice_features=None)
    -> (B, engine.max_new) int32 token ids on the engine's device, the
    contract of `eval.generate.make_greedy_generate`: each row becomes one
    engine request, the engine drains with continuous batching, and the
    output is repacked in row order, pad after EOS."""

    def as_numpy(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def generate(input_ids, kv_lens, volume=None, slice_features=None):
        ids, lens = as_numpy(input_ids), as_numpy(kv_lens)
        uids = []
        for i in range(len(ids)):
            kw = {}
            if engine.multimodal:
                kw["volume"] = as_numpy(volume)[i:i + 1]
                if slice_features is not None:
                    kw["slice_features"] = as_numpy(slice_features)[i:i + 1]
            uids.append(engine.submit(ids[i, : int(lens[i])], **kw))
        results = engine.run_until_drained()
        out = np.full((len(ids), engine.max_new), engine.pad, np.int32)
        for r, uid in enumerate(uids):
            toks = results[uid]
            out[r, : len(toks)] = toks
        return torch.as_tensor(out).to(engine.device)

    return generate
