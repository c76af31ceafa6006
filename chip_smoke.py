#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hsenet_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel of the port from `hsenet_torch/csrc/` with nvcc,
   one nvcc per source, all started at once;
3. [kernel] holds the forward kernel against its plain PyTorch version on
   the card, in bf16, at the shapes the paths give it (towers, prefill,
   and the LLM training shape with its log-sum-exp output), and times the
   kernel, the plain version and one PyTorch library call computing the
   same function (a yardstick only: the port never calls it);
4. [kernel-bwd] holds the two backward kernels (dQ; dK and dV) against
   their plain version at the LLM training shape (3 x 24 heads x 800
   tokens, d 128, causal, kv_lens 800/700/560) and the tower shape (2 x 12
   x 2049, d 64), each error a share of its row's largest value; shows
   that versions with delta left out, the last valid key tile dropped or
   the diagonal tile dropped miss the limit, and that keys past kv_len and
   a row with kv_len 0 get exactly zero gradients; and times them against
   the bound, the plain version and the backward of one SDPA call;
5. [main] drives generation at the full width of `VLMConfig()` (dual ViT-B
   towers, two packers, Phi-4-mini with 32 layers, vocab 200064) with
   random bf16 weights drawn on the card from a seeded generator: B=2
   prompts of BOS + 256 image tokens + text (valid lengths 300 and 320)
   through `make_greedy_generate` for 32 new tokens. It checks that the
   flash kernel ran exactly 24 (towers) + 32 (prefill) times, that logits
   are finite and tokens inside the vocabulary, and that prefill logits
   through the kernel agree with those of the plain sdpa path (and that
   a kernel without the last 64 keys of each row would not);
6. [train] runs the VLM LoRA finetune at the configuration of the JAX
   package's `cli/train_vlm.py` (`VLMConfig()` with LoRA r16/a32 on the
   LLM, f32 trainable masters over a bf16 base, towers frozen, remat on)
   through `Trainer` and `make_vlm_train_step`: batch 3 of BOS + 256 image
   tokens + report, right-padded to 800 tokens (valid 800, 700, 560), 2
   warm-up and 6 timed steps on that one batch. It prints step ms, tokens/s,
   peak memory and each step's loss (which must fall), profiles one step,
   and checks the flash launches per step: 24 forward d64 (towers), 64
   forward d128 with the log-sum-exp (32 layers, twice under remat), 32 dQ
   and 32 dK/dV;
7. [train-grads] one step's gradients through the kernels against the same
   step through the plain sdpa path, as relative L2 per group of leaves,
   and shows that steps with a planted fault in the attention backward
   (delta left out; no gradient through attention) miss the limit;
8. prints one JSON line of kernel numbers, then as its last line
   {"ok": true, "device": {...}}.

Any failed phase raises and the script exits non-zero. Without a CUDA
device, or without the hsenet_torch package beside it, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import gc
import json
import math
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

# backward kernels against their plain version: |error| as a share of the
# largest |value| in its row (a query row of dQ, a key row of dK and dV),
# that largest value floored at BWD_ROW_FLOOR of the output's largest: a
# query row with one valid column has a gradient of exactly 0 in exact
# arithmetic, so both sides hold rounding noise there. P and dS are rounded
# to bf16 for the tensor cores and each output to bf16 at the end (2^-9 of
# the row's largest value); check_flash_bwd_kernels shows that versions
# with delta left out, the last valid key tile of each batch row dropped,
# or the diagonal tile dropped break it. Keys at or past kv_len, and a
# batch row with kv_len 0, must get exact zeros.
KERNEL_BWD_TOL = 2e-2
BWD_ROW_FLOOR = 1e-4
# the forward's log-sum-exp against the plain version's, absolute: both
# sum the same bf16 products in f32
LSE_ABS_TOL = 1e-3
# one training step's gradients through the kernels against the plain sdpa
# path, relative L2 per group of leaves: 32 bf16 layers that round at
# different places; check_train_grads shows that steps with delta left out
# of the backward, or with no gradient through attention, break it
TRAIN_GRAD_REL_L2 = 5e-2

EOS_TOKEN_ID = 200020  # Phi-4-mini <|end|>
IM_PATCH_TOKEN_ID = 200010  # placeholder id under the spliced image block
MAX_NEW_TOKENS = 32
KV_LENS = (300, 320)
PROMPT_LEN = 320
# the finetune's traffic: batch 3 (the reference's per-GPU batch), right
# padded to the MRG max length, rows of different valid length
TRAIN_KV_LENS = (800, 700, 560)
TRAIN_SEQ = 800
TRAIN_WARMUP_STEPS = 2
TRAIN_TIMED_STEPS = 6


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
    the heaviest kernels and ops, and the device's idle share against `wall_ms`,
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
    # device time by kind of kernel: the port's flash kernels, cuBLAS
    # matrix products, and everything else (elementwise, norms, reductions,
    # copies)
    kinds = {"flash": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        kind = ("flash" if "flash_" in name else
                "gemm" if any(w in name for w in ("nvjet", "gemm", "cutlass"))
                else "other")
        kinds[kind] += e.self_device_time_total / 1e3
    out = {"wall_ms": wall_ms, "device_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms), "by_kind_ms": kinds}
    print(f"[profile] {label}: wall {wall_ms:.2f} ms (unprofiled median), "
          f"device busy {busy_ms:.2f} ms (profiled call), idle share "
          f"{out['idle_share']:.1%}; device ms by kind: "
          + ", ".join(f"{k} {v:.2f}" for k, v in kinds.items()))
    for name, ms, count in heavy:
        print(f"[profile] {label}:   {ms:9.3f} ms  x{count:<5d} {name}")
    # the same device time by the PyTorch op that launched it
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    out["by_op_ms"] = {e.key: e.self_device_time_total / 1e3 for e in ops[:top]}
    for e in ops[:top]:
        print(f"[profile] {label}: op {e.key[:40]:40s} "
              f"{e.self_device_time_total / 1e3:9.3f} ms  x{e.count}")
    return out


def attention_pairs(sq, skv, kv_lens, q_off, causal):
    """(valid (row, column) pairs summed over the batch, K/V rows that some
    row of each batch row needs, summed over the batch)."""
    pairs = kv_rows = 0
    for kv, off in zip(kv_lens, q_off):
        valid = [max(min(kv, skv, r + off + 1) if causal else min(kv, skv), 0)
                 for r in range(sq)]
        pairs += sum(valid)
        kv_rows += max(valid)
    return pairs, kv_rows


def kernel_bound(kind, b, h, sq, skv, d, kv_lens, q_off, causal):
    """(bound_ms, bound_by, flops, bytes) of one launch of `kind`: each
    input read once and each output written once in bf16 (K and V only up
    to the last column some row needs; log-sum-exp and delta in f32), and
    2 d operations per product per valid (row, column) pair: 2 products
    (S, PV) for flash_fwd, 3 (S, dP, dQ) for flash_bwd_dq and 4 (S, dP,
    dV, dK) for flash_bwd_dkv."""
    pairs, kv_rows = attention_pairs(sq, skv, kv_lens, q_off, causal)
    q_bytes = 2 * b * h * sq * d  # one (B, H, Sq, D) bf16 tensor
    kv_bytes = 2 * 2 * h * kv_rows * d  # K and V below the valid edge
    rows = 4 * b * h * sq  # one f32 value per query row
    products, nbytes = {
        "flash_fwd": (2, 2 * q_bytes + kv_bytes),
        "flash_fwd_lse": (2, 2 * q_bytes + kv_bytes + rows),
        "flash_bwd_dq": (3, 3 * q_bytes + kv_bytes + 2 * rows),
        "flash_bwd_dkv": (4, 2 * q_bytes + kv_bytes + 2 * rows
                          + 2 * 2 * b * h * skv * d),
    }[kind]
    flops = products * 2 * d * h * pairs
    nbytes += 8 * b  # kv_lens and q_offset
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
    """B1 against its plain version at the tower, prefill and training
    shapes."""
    import torch
    import torch.nn.functional as F
    from einops import rearrange

    from hsenet_torch.ops import flash_attention as tfa
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
    # training: 3 x 800 tokens, q from its projection, k/v GQA-expanded
    lq, lk, lv = llm_training_qkv(randn)
    cases = [
        ("tower", (tq, tk, tv), (2049, 1900), (0, 0), False),
        ("prefill", (pq, pk, pv), KV_LENS, (0, 0), True),
        ("prefill_q_offset", (pq, pk, pv), (316, 352), (16, 32), True),
        ("train", (lq, lk, lv), TRAIN_KV_LENS, (0, 0, 0), True),
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
        if name == "train":
            # the launch of the training path, which also writes the
            # log-sum-exp that the backward kernels read
            def run(q=q, k=k, v=v):
                return tfa._forward_kernel(q, k, v, kv_t, off_t, causal,
                                           q.shape[3] ** -0.5, True)

            out, lse = run()
            ref, ref_lse = flash_attention_reference(q, k, v, with_lse=True, **kw)
            lse_err = (lse - ref_lse).abs().max().item()
            # the limit's power: the log-sum-exp without the last 64 valid
            # keys of each batch row must miss it
            _, short_lse = flash_attention_reference(
                q, k, v, with_lse=True, **{**kw, "kv_lens": kv_t - 64})
            short_err = (short_lse - ref_lse).abs().max().item()
            print(f"[kernel] flash_fwd train: log-sum-exp max abs err "
                  f"{lse_err:.3e} (tol {LSE_ABS_TOL}); without the last 64 "
                  f"keys {short_err:.3e}")
            if not lse_err <= LSE_ABS_TOL:
                raise AssertionError("flash_fwd log-sum-exp disagrees with its plain version")
            if short_err <= LSE_ABS_TOL:
                raise AssertionError("the log-sum-exp tolerance passes 64 dropped keys")
        else:
            def run(q=q, k=k, v=v, kw=kw):
                return flash_attention(q, k, v, **kw)

            out = run()
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
        bound, bound_by, flops, nbytes = kernel_bound(
            "flash_fwd_lse" if name == "train" else "flash_fwd",
            q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3],
            kv_lens, q_off, causal,
        )
        results[name] = {
            "max_abs_err": max_abs,
            "max_row_rel_err": row_rel,
            "ms": time_ms(run),
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


def llm_training_qkv(randn):
    """q, k, v of one Phi layer at the training shape: q a head-split view
    of its (3, 800, 24 x 128) projection, k and v GQA-expanded from 8 kv
    heads (what `multi_head_attention` hands the kernels)."""
    from einops import rearrange

    b, s = len(TRAIN_KV_LENS), TRAIN_SEQ
    q = rearrange(randn(b, s, 24 * 128), "b s (n d) -> b n s d", n=24)
    k, v = (rearrange(randn(b, s, 8 * 128), "b s (n d) -> b n s d", n=8)
            .repeat_interleave(3, dim=1) for _ in range(2))
    return q, k, v


def row_rel(out, ref):
    """(max |out - ref|, max over rows of |out - ref| / the row's largest
    |ref|) of one backward output, a row being the last axis (a query row
    of dQ, a key row of dK and dV), each row's largest |ref| floored at
    BWD_ROW_FLOOR of the output's largest. A non-finite value gives inf."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    floor = max(BWD_ROW_FLOOR * ref.abs().max().item(), 1e-30)
    scale = ref.abs().amax(dim=-1, keepdim=True).clamp_min(floor)
    share = torch.where(out.isfinite(), err / scale, math.inf)
    return err.max().item(), share.max().item()


def backward_dropping(q, k, v, out, lse, do, kv_t, off_t, causal, drop):
    """The plain backward with the (row, column) pairs of `drop` left out of
    P (dQ, dK, dV in f32): what a kernel that skipped those tiles would
    give."""
    import torch

    from hsenet_torch.ops import flash_attention as tfa

    scale = q.shape[3] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    keep = tfa._valid(q, k, kv_t, off_t, causal) & ~drop
    p = torch.where(keep, torch.exp(qf @ kf.transpose(-1, -2) * scale
                                    - lse.float()[..., None]), 0.0)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta) * scale
    return ds @ kf, ds.transpose(-1, -2) @ qf, p.transpose(-1, -2) @ dof


def wrong_backwards(q, k, v, out, lse, do, kv_t, off_t, causal):
    """Deliberately wrong backwards, by name: delta left out; the last
    valid 64-key tile of each batch row dropped; and under causal the
    diagonal tile (keys of the query's own 64-row tile) dropped."""
    import torch

    from hsenet_torch.ops import flash_attention as tfa

    dev = q.device
    col = torch.arange(k.shape[2], device=dev)[None, None, None, :]
    last_tile = (kv_t.clamp_min(1) - 1) // 64 * 64
    drops = {"last key tile dropped": col >= last_tile[:, None, None, None]}
    if causal:
        row = torch.arange(q.shape[2], device=dev)[None, None, :, None]
        drops["diagonal tile dropped"] = (
            col // 64 == (row + off_t[:, None, None, None]) // 64)
    wrong = {"delta left out": tfa.flash_attention_backward_reference(
        q, k, v, torch.zeros_like(out), lse, do, kv_t, off_t, causal)}
    for name, drop in drops.items():
        wrong[name] = backward_dropping(q, k, v, out, lse, do, kv_t, off_t,
                                        causal, drop)
    return wrong


def check_flash_bwd_kernels():
    """B3 (dQ; dK and dV) against its plain version at the training and
    tower shapes, with edge cases and wrong variants."""
    import torch
    import torch.nn.functional as F
    from einops import rearrange

    from hsenet_torch.ops import flash_attention as tfa

    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    # edge cases off the main path: Sq, Skv not multiples of 64, a batch
    # row with kv_len 0 (all its gradients exactly 0), a causal offset
    for d in (64, 128):
        for causal in (False, True):
            q, k, v = (randn(2, 3, n, d) for n in (70, 100, 100))
            kv_t = torch.tensor([0, 77], dtype=torch.int32, device=dev)
            off_t = torch.tensor([5, 9], dtype=torch.int32, device=dev)
            out, lse = tfa._forward_kernel(q, k, v, kv_t, off_t, causal,
                                           d ** -0.5, True)
            do = randn(*out.shape)
            got = tfa.flash_attention_backward(q, k, v, out, lse, do, kv_t,
                                               off_t, causal)
            want = tfa.flash_attention_backward_reference(
                q, k, v, out, lse, do, kv_t, off_t, causal)
            rels = [row_rel(g, w)[1] for g, w in zip(got, want)]
            zeros = all(torch.count_nonzero(g[0]) == 0 for g in got)
            print(f"[kernel-bwd] edge case d {d} causal={causal}: Sq 70, Skv "
                  f"100, kv_lens (0, 77), q_offset (5, 9): dQ/dK/dV err / row's "
                  f"max |ref| {rels[0]:.3e} {rels[1]:.3e} {rels[2]:.3e}, kv_len-0 "
                  f"row all zeros: {zeros}")
            if not (zeros and max(rels) <= KERNEL_BWD_TOL):
                raise AssertionError(f"flash backward edge case d {d} "
                                     f"causal={causal} failed")

    tq, tk, tv = (rearrange(t, "b s (n d) -> b n s d", n=12)
                  for t in randn(2, 2049, 3 * 12 * 64).chunk(3, dim=-1))
    cases = [
        ("train", llm_training_qkv(randn), TRAIN_KV_LENS, (0, 0, 0), True),
        ("tower", (tq, tk, tv), (2049, 2049), (0, 0), False),
    ]
    results = {}
    for name, (q, k, v), kv_lens, q_off, causal in cases:
        kv_t = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        off_t = torch.tensor(q_off, dtype=torch.int32, device=dev)
        scale = q.shape[3] ** -0.5
        out, lse = tfa._forward_kernel(q, k, v, kv_t, off_t, causal, scale, True)
        do = randn(*out.shape)
        got = tfa.flash_attention_backward(q, k, v, out, lse, do, kv_t, off_t,
                                           causal)
        want = tfa.flash_attention_backward_reference(
            q, k, v, out, lse, do, kv_t, off_t, causal)
        errs = {g: row_rel(a, b) for g, a, b in zip(("dq", "dk", "dv"), got, want)}
        past_kv = (torch.arange(k.shape[2], device=dev)[None, None, :, None]
                   >= kv_t[:, None, None, None])
        past_kv_zero = all(torch.count_nonzero(torch.where(past_kv, g, 0)) == 0
                           for g in got[1:])
        print(f"[kernel-bwd] {name}: q{tuple(q.shape)} k{tuple(k.shape)} "
              f"causal={causal} kv_lens={kv_lens}: err / row's max |ref| "
              + ", ".join(f"{g} {e[1]:.3e} (abs {e[0]:.3e})" for g, e in errs.items())
              + f" (tol {KERNEL_BWD_TOL}, floor {BWD_ROW_FLOOR} of the "
              f"output's max); dK, dV exactly 0 at keys past kv_len: {past_kv_zero}")
        if not past_kv_zero or max(e[1] for e in errs.values()) > KERNEL_BWD_TOL:
            raise AssertionError(f"flash backward {name} disagrees with its plain version")
        # the limit's power: each wrong variant must miss it
        for wname, wgrads in wrong_backwards(q, k, v, out, lse, do, kv_t,
                                             off_t, causal).items():
            wrels = [row_rel(a, b)[1] for a, b in zip(wgrads, want)]
            print(f"[kernel-bwd] {name} {wname}: dQ/dK/dV err / row's max "
                  f"|ref| {wrels[0]:.3e} {wrels[1]:.3e} {wrels[2]:.3e}")
            if max(wrels) <= KERNEL_BWD_TOL:
                raise AssertionError(f"the backward tolerance passes {wname}")
            del wgrads

        # per-kernel device times, against the bound, the plain version (it
        # computes dQ, dK and dV together) and one SDPA call's backward
        delta = (do.float() * out.float()).sum(dim=-1).contiguous()
        args = (q, k, v, do, lse, delta, kv_t, off_t, causal, scale)
        plain_ms = time_ms(lambda: tfa.flash_attention_backward_reference(
            q, k, v, out, lse, do, kv_t, off_t, causal), reps=3)
        mask = tfa._valid(q, k, kv_t, off_t, causal)
        leaves = [t.detach().contiguous().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True))
        shape_args = (q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                      q.shape[3], kv_lens, q_off, causal)
        for kname, fn in (("flash_bwd_dq", tfa._bwd_dq_kernel),
                          ("flash_bwd_dkv", tfa._bwd_dkv_kernel)):
            bound, bound_by, flops, nbytes = kernel_bound(kname, *shape_args)
            errs_k = ([errs["dq"]] if kname == "flash_bwd_dq"
                      else [errs["dk"], errs["dv"]])
            r = results.setdefault(kname, {})[name] = {
                "max_abs_err": max(e[0] for e in errs_k),
                "max_rel_err": max(e[1] for e in errs_k),
                "ms": time_ms(lambda fn=fn: fn(*args)),
                "plain_ms": plain_ms,
                "library_ms": library_ms,
                "bound_ms": bound,
                "bound_by": bound_by,
                "gflop": flops / 1e9,
                "mbytes": nbytes / 1e6,
            }
            print(f"[kernel-bwd] {kname} {name}: kernel {r['ms']:.4f} ms, "
                  f"plain (dQ, dK, dV) {plain_ms:.4f} ms, library (SDPA "
                  f"backward, dQ, dK, dV) {library_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({bound_by}: {r['gflop']:.2f} GFLOP, "
                  f"{r['mbytes']:.2f} MB)")
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
    from hsenet_torch.ops import flash_attention as tfa

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
    # the limit's power: prefill through a kernel that skips the last 64
    # valid keys of each row must miss it
    sound = tfa._forward_kernel
    try:
        tfa._forward_kernel = lambda q, k, v, kv, *rest: sound(
            q, k, v, (kv - 64).clamp_min(1), *rest)
        with torch.inference_mode():
            short_logits, _ = prefill()
    finally:
        tfa._forward_kernel = sound
    short_rel = ((short_logits[:, 0].float() - want).norm() / want.norm()).item()
    print(f"[main] prefill last-token logits through a kernel without the "
          f"last 64 keys, vs plain sdpa: rel L2 {short_rel:.3e}")
    if short_rel <= LOGITS_REL_L2:
        raise AssertionError("the logits tolerance passes 64 dropped keys")

    generate = make_greedy_generate(model, max_new_tokens=MAX_NEW_TOKENS,
                                    eos_token_id=EOS_TOKEN_ID)
    torch.cuda.reset_peak_memory_stats()
    tfa.reset_launch_counts()  # the main path, counted
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate(ids, kv_lens, volume, slices)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = sum(tfa.launches.values())
    by_d = tfa.fwd_launches  # d 64: towers, 128: prefill; no log-sum-exp
    by_shape = {"tower": by_d[(cfg.vision.hidden_size // cfg.vision.num_heads, False)],
                "prefill": by_d[(cfg.llm.head_dim, False)]}
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


def training_batch(cfg):
    """The finetune's batch, made as its dataset makes one: BOS + 256
    <im_patch> + prompt, then a report of seeded random words, tokenized by
    `tokenize_qa_sample` right-padded to TRAIN_SEQ (valid lengths
    TRAIN_KV_LENS), collated by the port's `DataLoader`; random volumes and
    slice features from a seeded numpy generator."""
    import numpy as np

    from hsenet_torch.data.datasets import (
        IM_PATCH_TOKEN,
        SPECIAL_TOKENS,
        DataArgs,
        DataLoader,
        SimpleTokenizer,
        tokenize_qa_sample,
    )

    tokenizer = SimpleTokenizer(vocab_size=cfg.llm.vocab_size)
    tokenizer.add_special_tokens({"additional_special_tokens": SPECIAL_TOKENS})
    args = DataArgs(max_length=TRAIN_SEQ, proj_out_num=cfg.num_image_tokens)
    rng = np.random.default_rng(3)
    question = IM_PATCH_TOKEN * args.proj_out_num + "Describe the scan."
    q_len = 1 + args.proj_out_num + 3  # BOS, image block, three words

    class Reports:
        def __len__(self):
            return len(TRAIN_KV_LENS)

        def __getitem__(self, i):
            words = rng.integers(0, 5000, TRAIN_KV_LENS[i] - q_len)
            tok = tokenize_qa_sample(
                tokenizer, question, " ".join(f"w{w}" for w in words),
                args.max_length,
            )
            return {
                "image": rng.random((1, *cfg.vision.image_size), np.float32),
                "image_2d": rng.standard_normal(
                    (cfg.vision.num_slices, cfg.vision.slice_feature_dim)
                ).astype(np.float32),
                **{k: tok[k] for k in ("input_ids", "attention_mask", "labels")},
            }

    batch = next(iter(DataLoader(Reports(), len(TRAIN_KV_LENS), shuffle=False)))
    valid = tuple(int(n) for n in batch["attention_mask"].sum(axis=1))
    if valid != TRAIN_KV_LENS:
        raise AssertionError(f"training batch valid lengths {valid}, not {TRAIN_KV_LENS}")
    return batch


def finetune_config():
    """The finetune's configuration, as the JAX package's
    `cli/train_vlm.py::build_vlm_config` makes it for a real run:
    `VLMConfig()` with LoRA (rank 16, alpha 32) on the Phi-4-mini LLM."""
    import dataclasses

    from hsenet_torch.configs import LoRAConfig, VLMConfig

    base = VLMConfig()
    return dataclasses.replace(
        base, llm=dataclasses.replace(base.llm, lora=LoRAConfig()))


def build_finetune_model(cfg, remat: bool = True):
    """The finetune's model on the card: bf16 modules with random weights
    (seed 0), trainable leaves (LoRA, packers, tied embedding) held as f32
    masters, everything else frozen."""
    import torch

    from hsenet_torch.models import init_random_
    from hsenet_torch.models.mllm import HSENetVLM
    from hsenet_torch.train.vlm import to_training_dtypes, vlm_trainable_mask

    model = HSENetVLM(cfg, dtype=torch.bfloat16, device="cuda", remat=remat)
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    mask = vlm_trainable_mask(model)
    to_training_dtypes(model, mask)
    return model, mask


def run_train_path(card: str):
    """The finetune at full width: Trainer + make_vlm_train_step for warm-up
    and timed steps on one batch. Returns the launches per step by kind and
    the phase's numbers."""
    import torch

    from hsenet_torch.configs import TrainConfig
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.train.train_state import TrainState, make_optimizer
    from hsenet_torch.train.trainer import Trainer, TrainerHooks
    from hsenet_torch.train.vlm import make_vlm_eval_fn, make_vlm_train_step

    cfg = finetune_config()
    t0 = time.perf_counter()
    model, mask = build_finetune_model(cfg)
    n_train = sum(p.numel() for n, p in model.named_parameters() if mask[n])
    n_all = sum(p.numel() for p in model.parameters())
    print(f"[train] HSENetVLM(VLMConfig() + LoRA r{cfg.llm.lora.rank}/a"
          f"{cfg.llm.lora.alpha}), remat on: {n_all / 1e9:.3f} B parameters, {n_train / 1e6:.1f} M "
          f"trainable (f32), built in {time.perf_counter() - t0:.1f} s")
    batch = training_batch(cfg)
    total = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    train_cfg = TrainConfig(learning_rate=1e-4, total_steps=total,
                            log_every=1, eval_every=0, seed=0)
    tx = make_optimizer(train_cfg, mask)
    state = TrainState.create(model, tx)
    step_fn = make_vlm_train_step(model, tx)
    counts = {}

    def on_log(step, row):
        if step == TRAIN_WARMUP_STEPS:  # the timed steps start here
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tfa.reset_launch_counts()
        if step == total:
            counts.update(kernels=dict(tfa.launches), fwd=dict(tfa.fwd_launches))

    trainer = Trainer(step_fn, state, lambda: [batch], train_cfg,
                      hooks=TrainerHooks(on_log=on_log))
    state = trainer.fit()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = trainer.history
    losses = [row["loss"] for row in hist]
    timed = hist[TRAIN_WARMUP_STEPS:]
    step_ms = [1e3 / row["steps_per_sec"] for row in timed]
    med = statistics.median(step_ms)
    tokens = sum(TRAIN_KV_LENS)
    per_step = {
        "fwd_d64": counts["fwd"][(64, False)] / TRAIN_TIMED_STEPS,
        "fwd_d128_lse": counts["fwd"][(128, True)] / TRAIN_TIMED_STEPS,
        "dq": counts["kernels"]["flash_bwd_dq"] / TRAIN_TIMED_STEPS,
        "dkv": counts["kernels"]["flash_bwd_dkv"] / TRAIN_TIMED_STEPS,
    }
    expected = {"fwd_d64": 2 * cfg.vision.num_layers,
                "fwd_d128_lse": 2 * cfg.llm.num_layers,
                "dq": cfg.llm.num_layers, "dkv": cfg.llm.num_layers}
    print(f"[train] losses by step: {[round(x, 4) for x in losses]}")
    print(f"[train] grad norms by step: "
          f"{[round(row['grad_norm'], 4) for row in hist]}")
    print(f"[train] flash launches per step: {per_step} (expected {expected}); "
          f"forward launches by (head dim, log-sum-exp) {counts['fwd']}")
    print(f"[train] on {card}: step {med:.1f} ms median of "
          f"{TRAIN_TIMED_STEPS} (min {min(step_ms):.1f}, max "
          f"{max(step_ms):.1f}), {tokens / (med / 1e3):.0f} valid tokens/s "
          f"({tokens} a step), peak memory {peak_gb:.2f} GB")
    if per_step != expected or sum(counts["fwd"].values()) != (
            per_step["fwd_d64"] + per_step["fwd_d128_lse"]) * TRAIN_TIMED_STEPS:
        raise AssertionError(f"flash launches per step {per_step}, not {expected}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[TRAIN_WARMUP_STEPS]:
        raise AssertionError(f"the loss did not fall over the timed steps: {losses}")

    device_batch = trainer._place(batch)
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], device_batch, 7)

    profile = profile_phase("train step", one_step, med, top=12)
    val = make_vlm_eval_fn(model)([batch])
    print(f"[train] eval on the batch (deterministic): {val}")
    numbers = {
        "step_ms_median": med, "step_ms": step_ms, "losses": losses,
        "tokens_per_s": tokens / (med / 1e3), "peak_memory_gb": peak_gb,
        "launches_per_step": per_step, "profile": profile, "eval": val,
        "batch": len(TRAIN_KV_LENS), "seq": TRAIN_SEQ,
        "kv_lens": list(TRAIN_KV_LENS),
    }
    del model, state, trainer, holder
    return per_step, numbers


def check_train_grads():
    """One step's gradients through the kernels against the same step
    through the plain sdpa path, same weights and batch, no dropout; then
    the same step with planted faults in the attention backward."""
    import torch

    from hsenet_torch.ops import attention
    from hsenet_torch.ops import flash_attention as tfa
    from hsenet_torch.train.vlm import vlm_loss_fn

    cfg = finetune_config()
    model, mask = build_finetune_model(cfg)
    # LoRA B starts at 0, which leaves LoRA A without gradient: draw it
    with torch.no_grad():
        gen = torch.Generator(device="cuda").manual_seed(5)
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=gen)
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             training_batch(cfg).items() if hasattr(v, "shape")}
    names = [n for n in mask if mask[n]]
    params = [dict(model.named_parameters())[n] for n in names]

    def grads():
        loss, _ = vlm_loss_fn(model, batch)
        return loss.item(), torch.autograd.grad(loss, params)

    groups = {"lora": "lora_", "packers": "mm_projector", "embedding": "llm.embed"}

    def rel_l2(g, ref):
        rel = {}
        for group, key in groups.items():
            idx = [i for i, n in enumerate(names) if key in n]
            num = sum((g[i].float() - ref[i].float()).pow(2).sum() for i in idx)
            den = sum(ref[i].float().pow(2).sum() for i in idx)
            rel[group] = (num / den).sqrt().item()
        return rel

    loss_k, g_k = grads()
    try:
        attention.set_flash_mode("never")
        loss_p, g_p = grads()
    finally:
        attention.set_flash_mode("auto")
    rel = rel_l2(g_k, g_p)
    del g_k
    # the loss is printed, not held to a limit: at random init it sits near
    # ln(vocab) whatever attention does; [kernel] and [main] hold the forward
    print(f"[train-grads] loss kernel {loss_k:.6f} vs plain sdpa {loss_p:.6f} "
          f"(rel {abs(loss_k - loss_p) / abs(loss_p):.2e}); gradient rel L2 by "
          + ", ".join(f"{g} {r:.3e}" for g, r in rel.items())
          + f" (tol {TRAIN_GRAD_REL_L2})")
    if max(rel.values()) > TRAIN_GRAD_REL_L2:
        raise AssertionError("training gradients through the kernels disagree "
                             "with the plain path")

    # the limit's power: the same step with a planted fault in the attention
    # backward (the kernels launched with delta = 0; no gradient through
    # attention at all, the fault this port once had) must miss it
    sound = tfa.flash_attention_backward
    faults = {
        "delta left out": lambda q, k, v, o, *rest: sound(
            q, k, v, torch.zeros_like(o), *rest),
        "no attention gradient": lambda q, k, v, *rest: tuple(
            torch.zeros_like(t) for t in (q, k, v)),
    }
    wrong = {}
    for fault, backward in faults.items():
        try:
            tfa.flash_attention_backward = backward
            _, g_w = grads()
        finally:
            tfa.flash_attention_backward = sound
        wrong[fault] = rel_l2(g_w, g_p)
        del g_w
        print(f"[train-grads] {fault}: gradient rel L2 by "
              + ", ".join(f"{g} {r:.3e}" for g, r in wrong[fault].items()))
        if max(wrong[fault].values()) <= TRAIN_GRAD_REL_L2:
            raise AssertionError(f"the training gradient limit passes {fault}")
    del model, params, g_p
    return {"loss_kernel": loss_k, "loss_plain": loss_p, "grad_rel_l2": rel,
            "planted_faults_rel_l2": wrong}


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
    from hsenet_torch.ops.flash_attention import KERNELS

    t0 = time.perf_counter()
    _build.load_all(KERNELS)  # one nvcc per source, all at once
    print(f"[build] {time.perf_counter() - t0:.1f} s for "
          f"{sorted(_build.BUILD_LOGS) or 'cached'}")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    per_shape = check_flash_kernel()
    bwd = check_flash_bwd_kernels()
    launches, counts, numbers = run_main_path(card)
    gc.collect()
    torch.cuda.empty_cache()
    train_counts, train_numbers = run_train_path(card)
    gc.collect()
    torch.cuda.empty_cache()
    grad_numbers = check_train_grads()

    # launches on the main paths, by shape: one generate run and one
    # training step (its towers run at the tower shape)
    fwd_counts = {"tower": counts["tower"] + train_counts["fwd_d64"],
                  "prefill": counts["prefill"],
                  "train": train_counts["fwd_d128_lse"]}
    bwd_counts = {"flash_bwd_dq": {"train": train_counts["dq"]},
                  "flash_bwd_dkv": {"train": train_counts["dkv"]}}

    def entry(name, source, replaces, shapes, path_counts, note):
        def per_run(key):  # per-launch times x launches at each shape
            return sum(shapes[s][key] * n for s, n in path_counts.items())

        # the shape that holds most of the bound names what bounds it
        heaviest = max(path_counts,
                       key=lambda s: shapes[s]["bound_ms"] * path_counts[s])
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": int(sum(path_counts.values())),
            "max_abs_err": max(r["max_abs_err"] for r in shapes.values()),
            "ms": per_run("ms"),
            "plain_ms": per_run("plain_ms"),
            "bound_ms": per_run("bound_ms"),
            "bound_by": shapes[heaviest]["bound_by"],
            "library_ms": per_run("library_ms"),
            "times_are": note,
            "shapes": {s: {**shapes[s], "launches": path_counts.get(s, 0)}
                       for s in shapes},
        }

    note = ("sums over one generate run and one training step: per-launch "
            "times at each shape x its launches there")
    kernels = [
        entry("flash_fwd", "hsenet_torch/csrc/flash_fwd.cu",
              "hsenet_tpu/ops/flash_attention.py:109", per_shape, fwd_counts,
              note),
        entry("flash_bwd_dq", "hsenet_torch/csrc/flash_bwd_dq.cu",
              "hsenet_tpu/ops/flash_attention.py:552", bwd["flash_bwd_dq"],
              bwd_counts["flash_bwd_dq"],
              note + "; plain and library times compute dQ, dK and dV"),
        entry("flash_bwd_dkv", "hsenet_torch/csrc/flash_bwd_dkv.cu",
              "hsenet_tpu/ops/flash_attention.py:611", bwd["flash_bwd_dkv"],
              bwd_counts["flash_bwd_dkv"],
              note + "; plain and library times compute dQ, dK and dV"),
    ]
    print(json.dumps({"kernels": kernels, "main_path": numbers,
                      "train": train_numbers, "train_grads": grad_numbers,
                      "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
