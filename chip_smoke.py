#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hsenet_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel of the port from `hsenet_torch/csrc/` with nvcc;
3. holds each kernel against its plain PyTorch version on the card, in
   bf16, at the shapes the main path gives it, and times the kernel, the
   plain version and one PyTorch library call computing the same function
   (a yardstick only: the port never calls it);
4. drives the main path at the full width of `VLMConfig()` (dual ViT-B
   towers, two packers, Phi-4-mini with 32 layers, vocab 200064) with
   random bf16 weights drawn on the card from a seeded generator:
   B=2 prompts of BOS + 256 image tokens + text (valid lengths 300 and
   320) through `make_greedy_generate` for 32 new tokens. It checks that
   the flash kernel ran exactly 24 (towers) + 32 (prefill) times, that
   logits are finite and tokens inside the vocabulary, and that prefill
   logits through the kernel agree with those of the plain sdpa path;
5. prints one JSON line of kernel numbers, then as its last line
   {"ok": true, "device": {...}}.

Any failed phase raises and the script exits non-zero. Without a CUDA
device, or without the hsenet_torch package beside it, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM dense peaks (NVIDIA data sheet) for the bound of each kernel
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# device-side sleep that the timed calls queue behind (~10 ms at the
# H100's 1.98 GHz boost clock)
SLEEP_CYCLES = 20_000_000

# bf16 tolerance of a kernel against its plain version, as a share of the
# largest |value| in each output row (a row with no valid column must give
# exact zeros): both round O to bf16, which alone can put them 2^-7 of the
# row's largest value apart, and the kernel rounds P to bf16 as well.
# check_flash_kernel shows that a version that drops one 64-key tile at
# the tower shape breaks it.
KERNEL_ROW_TOL = 2e-2
# prefill last-token logits, kernel vs plain sdpa, as a relative L2 error:
# the two attention paths round at different places in each of 32 bf16
# layers, and the differences travel through the residual stream
LOGITS_REL_L2 = 5e-2

EOS_TOKEN_ID = 200020  # Phi-4-mini <|end|>
IM_PATCH_TOKEN_ID = 200010  # placeholder id under the spliced image block
MAX_NEW_TOKENS = 32
KV_LENS = (300, 320)
PROMPT_LEN = 320


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3, runs: int = 5) -> float:
    """Device time of one call: `reps` calls between two CUDA events, queued
    behind a device-side sleep so that the host's own time per call (the
    wrapper's Python, the launch) stays out of the interval; the median
    over `runs` such intervals of their mean per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        cycles = SLEEP_CYCLES
        while True:  # until the host queued every call inside the sleep
            slept, start, end = (torch.cuda.Event(enable_timing=True)
                                 for _ in range(3))
            slept.record()
            torch.cuda._sleep(cycles)
            start.record()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            end.record()
            host_ms = (time.perf_counter() - t) * 1e3
            end.synchronize()
            if host_ms < slept.elapsed_time(start) or cycles >= 16 * SLEEP_CYCLES:
                break
            cycles *= 2
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def median_wall_ms(fn, runs: int = 5) -> float:
    """Median host-clock time of `fn` over `runs` calls, each closed by a
    device synchronise."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def profile_phase(label: str, fn, wall_ms: float, top: int = 6) -> dict:
    """One call of `fn` under torch.profiler: summed device kernel time,
    the heaviest kernels, and the device's idle share against `wall_ms`,
    the phase's unprofiled median wall time (the profiler's own cost would
    inflate a profiled wall time). Device numbers are None where the
    profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"[profile] {label}: wall {wall_ms:.2f} ms; device time not measured")
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None}
    kernels.sort(key=lambda e: -e.self_device_time_total)
    heavy = [(e.key[:60], e.self_device_time_total / 1e3, e.count)
             for e in kernels[:top]]
    out = {"wall_ms": wall_ms, "device_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms)}
    print(f"[profile] {label}: wall {wall_ms:.2f} ms (unprofiled median), "
          f"device busy {busy_ms:.2f} ms (profiled call), idle share "
          f"{out['idle_share']:.1%}")
    for name, ms, count in heavy:
        print(f"[profile] {label}:   {ms:9.3f} ms  x{count:<5d} {name}")
    return out


def attention_bound(b, h, sq, skv, d, kv_lens, q_off, causal):
    """(bound_ms, bound_by, flops, bytes) of one attention call: Q read and
    O written whole in bf16, K and V read up to the last column some row of
    each batch row needs; 4*d operations for every (row, column) pair these
    kv_lens and offsets leave valid."""
    pairs = kv_rows = 0
    for kv, off in zip(kv_lens, q_off):
        valid = [max(min(kv, skv, r + off + 1) if causal else min(kv, skv), 0)
                 for r in range(sq)]
        pairs += sum(valid)
        kv_rows += max(valid)
    flops = 4 * d * h * pairs
    nbytes = 2 * (2 * b * h * sq * d + 2 * h * kv_rows * d) + 8 * b
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", flops, nbytes
    return t_bytes, "bytes", flops, nbytes


def compare(out, ref):
    """(max abs error, max error over its row's largest |ref|, within the
    bf16 tolerance and finite) of a kernel's output against its plain
    version's."""
    err = (out.float() - ref.float()).abs()
    scale = ref.float().abs().amax(dim=-1, keepdim=True)
    ok = bool((err <= KERNEL_ROW_TOL * scale).all())
    row_rel = (err / scale.clamp_min(1e-30)).max().item()
    return err.max().item(), row_rel, ok and bool(out.float().isfinite().all())


def check_flash_kernel():
    """B1 against its plain version at the tower and prefill shapes."""
    import torch
    import torch.nn.functional as F
    from einops import rearrange

    from hsenet_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    # tower: q/k/v are head-split views of one packed qkv projection
    b, h, s, d = 2, 12, 2049, 64
    qkv = randn(b, s, 3 * h * d)
    tq, tk, tv = (rearrange(t, "b s (n d) -> b n s d", n=h)
                  for t in qkv.chunk(3, dim=-1))
    # prefill: q from the q projection, k/v GQA-expanded from a 352-slot
    # cache (8 kv heads -> 24)
    pq = rearrange(randn(2, 320, 24 * 128), "b s (n d) -> b n s d", n=24)
    pk = randn(2, 8, 352, 128).repeat_interleave(3, dim=1)
    pv = randn(2, 8, 352, 128).repeat_interleave(3, dim=1)
    cases = [
        ("tower", (tq, tk, tv), (2049, 1900), (0, 0), False),
        ("prefill", (pq, pk, pv), KV_LENS, (0, 0), True),
        ("prefill_q_offset", (pq, pk, pv), (316, 352), (16, 32), True),
    ]
    # ragged edges off the main path: Sq and Skv not multiples of 64, an
    # empty row (kv_len 0 -> zeros) and a causal offset; checked, not timed
    eq, ek, ev = (randn(2, 4, n, 64) for n in (70, 100, 100))
    for causal in (False, True):
        kw = dict(kv_lens=torch.tensor([0, 77], dtype=torch.int32, device=dev),
                  causal=causal, q_offset=torch.tensor([5, 9], dtype=torch.int32,
                                                       device=dev))
        out = flash_attention(eq, ek, ev, **kw)
        max_abs, _, ok = compare(out, flash_attention_reference(eq, ek, ev, **kw))
        if not ok or torch.count_nonzero(out[0]) != 0:
            raise AssertionError(f"flash_fwd edge case (causal={causal}) failed")
        print(f"[kernel] flash_fwd edge case causal={causal}: Sq 70, Skv 100, "
              f"kv_lens (0, 77), q_offset (5, 9): max_abs_err {max_abs:.3e}, "
              f"empty row all zeros")

    results = {}
    for name, (q, k, v), kv_lens, q_off, causal in cases:
        kv_t = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        off_t = torch.tensor(q_off, dtype=torch.int32, device=dev)
        kw = dict(kv_lens=kv_t, causal=causal, q_offset=off_t)
        out = flash_attention(q, k, v, **kw)
        ref = flash_attention_reference(q, k, v, **kw)
        max_abs, row_rel, ok = compare(out, ref)
        ref_max = ref.float().abs().max().item()
        print(f"[kernel] flash_fwd {name}: shape q{tuple(q.shape)} "
              f"k{tuple(k.shape)} causal={causal} kv_lens={kv_lens} "
              f"q_offset={q_off}: max_abs_err {max_abs:.3e} (max |ref| "
              f"{ref_max:.3e}), max err / row's max |ref| {row_rel:.3e} "
              f"(tol {KERNEL_ROW_TOL})")
        if not ok:
            raise AssertionError(f"flash_fwd {name} disagrees with its plain version")
        if name == "tower":
            # the limit's power: attention without keys 64..127 must fail it
            keep = torch.cat([torch.arange(64, device=dev),
                              torch.arange(128, k.shape[2], device=dev)])
            dropped = flash_attention_reference(
                q, k[:, :, keep], v[:, :, keep], kv_lens=kv_t - 64)
            _, drop_rel, drop_ok = compare(dropped, ref)
            print(f"[kernel] flash_fwd tower without one 64-key tile: max err "
                  f"/ row's max |ref| {drop_rel:.3e} (must exceed {KERNEL_ROW_TOL})")
            if drop_ok:
                raise AssertionError("the kernel tolerance passes a dropped key tile")
        # the library yardstick: one SDPA call with the same boolean mask
        col = torch.arange(k.shape[2], device=dev)
        mask = col[None, None, None, :] < kv_t[:, None, None, None]
        if causal:
            row = torch.arange(q.shape[2], device=dev)[None, None, :, None]
            mask = mask & (col[None, None, None, :] <= row + off_t[:, None, None, None])
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        bound, bound_by, flops, nbytes = attention_bound(
            q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3],
            kv_lens, q_off, causal,
        )
        results[name] = {
            "max_abs_err": max_abs,
            "max_row_rel_err": row_rel,
            "ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
            "plain_ms": time_ms(lambda: flash_attention_reference(q, k, v, **kw), reps=5),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, attn_mask=mask)),
            "bound_ms": bound,
            "bound_by": bound_by,
            "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
        }
        r = results[name]
        print(f"[kernel] flash_fwd {name}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library (SDPA) {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({bound_by}: {r['gflop']:.2f} "
              f"GFLOP, {r['mbytes']:.2f} MB)")
    return results


def run_main_path(card: str):
    """The full-width main path. Returns the flash launches of one
    generate run, in all and at each path shape, and the main path's
    numbers."""
    import torch

    from hsenet_torch.configs import VLMConfig
    from hsenet_torch.eval.generate import make_greedy_generate
    from hsenet_torch.models import init_random_
    from hsenet_torch.models.mllm import HSENetVLM, splice_image_embeds
    from hsenet_torch.models.phi3 import KVCache
    from hsenet_torch.ops import attention
    from hsenet_torch.ops.flash_attention import (
        flash_attention,
        reset_launch_counts,
    )

    cfg = VLMConfig()
    dev = "cuda"
    t0 = time.perf_counter()
    model = HSENetVLM(cfg, dtype=torch.bfloat16, device=dev)
    init_random_(model, torch.Generator(device=dev).manual_seed(0))
    model.eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main] HSENetVLM(VLMConfig()) with {n_params / 1e9:.3f} B "
          f"parameters in bf16, random weights (seed 0), built in "
          f"{time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(1)
    b = len(KV_LENS)
    n_img = cfg.num_image_tokens
    ids = torch.randint(3, 100000, (b, PROMPT_LEN), generator=gen, device=dev)
    ids[:, 0] = 1  # BOS
    ids[:, 1:1 + n_img] = IM_PATCH_TOKEN_ID
    kv_lens = torch.tensor(KV_LENS, dtype=torch.int32, device=dev)
    for row, n in enumerate(KV_LENS):
        ids[row, n:] = 0  # right padding
    volume = torch.rand((b, 1, *cfg.vision.image_size), generator=gen,
                        device=dev)
    slices = torch.randn((b, cfg.vision.num_slices,
                          cfg.vision.slice_feature_dim), generator=gen,
                         device=dev)
    capacity = PROMPT_LEN + MAX_NEW_TOKENS

    with torch.inference_mode():
        # the first encode and prefill warm up cuBLAS handles and the
        # allocator
        feats = model.encode_images(volume, slices)
        embeds = splice_image_embeds(model.llm.embed_tokens(ids), feats)

        def prefill():
            return model.llm.decode_embeds(
                embeds, kv_lens=kv_lens, last_token_only=True,
                cache=KVCache.create(cfg.llm, b, capacity, device=dev))

        prefill()
        logits, cache = prefill()
        steps = MAX_NEW_TOKENS - 1

        def decode():
            token = prefill_token
            for _ in range(steps):
                step_logits, _ = model.decode_step(token, decode_cache)
                token = step_logits.argmax(dim=-1, keepdim=True)

        # host-clock times of the phases, median of several runs each (the
        # host is shared, so one run can be far off)
        encode_ms = median_wall_ms(lambda: model.encode_images(volume, slices))
        prefill_ms = median_wall_ms(prefill)
        decode_runs = []
        for _ in range(3):
            step_logits, decode_cache = prefill()
            prefill_token = step_logits[:, 0].argmax(dim=-1, keepdim=True)
            decode_runs.append(median_wall_ms(decode, runs=1))
        decode_ms = statistics.median(decode_runs)
        token = prefill_token

        # where the device time goes in each phase, and its idle share
        # against the unprofiled wall times above
        profiles = {
            "encode": profile_phase(
                "encode", lambda: model.encode_images(volume, slices),
                encode_ms),
            "prefill": profile_phase("prefill", prefill, prefill_ms),
            "decode_step": profile_phase(
                "decode step", lambda: model.decode_step(token, cache),
                decode_ms / steps),
        }

        # the same prefill through the plain sdpa path, same weights
        ref_cache = KVCache.create(cfg.llm, b, capacity, device=dev)
        try:
            attention.set_flash_mode("never")
            ref_logits, _ = model.llm.decode_embeds(
                embeds, kv_lens=kv_lens, cache=ref_cache, last_token_only=True)
        finally:
            attention.set_flash_mode("auto")
    got, want = logits[:, 0].float(), ref_logits[:, 0].float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError("prefill logits are not finite")
    rel_l2 = ((got - want).norm() / want.norm()).item()
    max_abs = (got - want).abs().max().item()
    same_argmax = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"[main] prefill last-token logits, kernel vs plain sdpa: rel L2 "
          f"{rel_l2:.3e} (tol {LOGITS_REL_L2}), max abs {max_abs:.3e}, "
          f"logit std {want.std().item():.3f}, same argmax in "
          f"{same_argmax:.0%} of rows")
    if rel_l2 > LOGITS_REL_L2:
        raise AssertionError("prefill logits through the kernel disagree with sdpa")

    generate = make_greedy_generate(model, max_new_tokens=MAX_NEW_TOKENS,
                                    eos_token_id=EOS_TOKEN_ID)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()  # the main path, counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate(ids, kv_lens, volume, slices)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = flash_attention.launches
    by_d = flash_attention.launches_by_head_dim  # d 64: towers, 128: prefill
    by_shape = {"tower": by_d[cfg.vision.hidden_size // cfg.vision.num_heads],
                "prefill": by_d[cfg.llm.head_dim]}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {"tower": 2 * cfg.vision.num_layers, "prefill": cfg.llm.num_layers}
    print(f"[main] generate: tokens {tuple(tokens.shape)}, flash launches "
          f"{launches}: {by_shape} (expected {expected})")
    if by_shape != expected or launches != sum(expected.values()):
        raise AssertionError(f"flash kernel launched {launches} times "
                             f"({by_shape}), not {expected}")
    if tokens.shape != (b, MAX_NEW_TOKENS) or not bool(
            ((tokens >= 0) & (tokens < cfg.llm.vocab_size)).all()):
        raise AssertionError("generated tokens outside the vocabulary")
    numbers = {
        "encode_ms": encode_ms,
        "prefill_ms": prefill_ms,
        "decode_tokens_per_s": b * steps / (decode_ms / 1e3),
        "generate_ms": generate_ms,
        "peak_memory_gb": peak_gb,
        "profiles": profiles,
        "batch": b,
        "max_new_tokens": MAX_NEW_TOKENS,
    }
    print(f"[main] on {card}: encode {encode_ms:.2f} ms, prefill (LLM, "
          f"320 tokens x 2) {prefill_ms:.2f} ms, decode "
          f"{numbers['decode_tokens_per_s']:.1f} tokens/s at batch {b}, "
          f"generate end to end {generate_ms:.1f} ms, peak memory "
          f"{peak_gb:.2f} GB")
    print(f"[main] first tokens: {tokens[:, :8].tolist()}")
    return launches, by_shape, numbers


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    if not (ROOT / "hsenet_torch" / "csrc").is_dir():
        print(f"chip_smoke: no hsenet_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    card = card_line()
    print(f"[card] {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    from hsenet_torch.ops import _build

    t0 = time.perf_counter()
    _build.load("flash_fwd")
    print(f"[build] {time.perf_counter() - t0:.1f} s for "
          f"{sorted(_build.BUILD_LOGS) or 'cached'}")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    per_shape = check_flash_kernel()
    launches, counts, numbers = run_main_path(card)

    def per_run(key):  # one main-path run: launches at each shape
        return sum(per_shape[s][key] * n for s, n in counts.items())

    # the shape that holds most of the bound names what bounds the kernel
    heaviest = max(counts, key=lambda s: per_shape[s]["bound_ms"] * counts[s])
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "hsenet_torch/csrc/flash_fwd.cu",
        "replaces": "hsenet_tpu/ops/flash_attention.py:109",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape.values()),
        "ms": per_run("ms"),
        "plain_ms": per_run("plain_ms"),
        "bound_ms": per_run("bound_ms"),
        "bound_by": per_shape[heaviest]["bound_by"],
        "library_ms": per_run("library_ms"),
        "times_are": "sums over one main-path run: per-launch times at the "
                     "tower shape x tower launches + at the prefill shape x "
                     "prefill launches",
        "shapes": {s: {**per_shape[s], "launches": counts.get(s, 0)}
                   for s in per_shape},
    }]
    print(json.dumps({"kernels": kernels, "main_path": numbers, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
