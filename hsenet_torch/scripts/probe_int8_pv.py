"""Probe of attention's P.V product in the W8A8 serving-encode mode (the
port of the JAX package's scripts/_probe_pallas_int8.py), through the
hand-written kernel of `ops/int8_pv.py`:

    python -m hsenet_torch.scripts.probe_int8_pv [modes ...]

Modes `bf16`, `int8_pre`, `quant_then_int8` and `glue_only` (all four by
default) at the probe's shapes: G = 192 grid cells (batch x heads x 2
query blocks of the tower), M = 1152 query rows, K = 2176 keys, N = 64.
Inputs are drawn on the device from seed 0 with the JAX probe's
distributions (P uniform in [0, 1) or int8 codes in [0, 127); V standard
normal or int8 codes in [-127, 127)). Each mode prints its device time per
launch, from CUDA events around `reps` launches after a warm-up, and the
rate 2 G M K N / time. `main(..., device="cpu")` runs the plain versions
at the given shapes and measures no time.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Sequence

import torch

from hsenet_torch import resolve_device
from hsenet_torch.ops.int8_pv import DTYPES, HEAD_DIM, MODES, int8_pv

# grid cells = batch x heads x 2 query blocks; query rows per block; keys
# (2049 tower tokens padded to 2176); head dim
SHAPES = (192, 1152, 2176, HEAD_DIM)


def make_inputs(mode: str, shapes=SHAPES, *, device, seed: int = 0):
    """(P, V) of `mode` at `shapes` = (G, M, K, N), drawn on `device`."""
    g, m, k, n = shapes
    gen = torch.Generator(device=device).manual_seed(seed)
    p_dtype, v_dtype = DTYPES[mode]
    if p_dtype == torch.int8:
        p = torch.randint(0, 127, (g, m, k), generator=gen, device=device,
                          dtype=torch.int8)
    else:
        p = torch.rand((g, m, k), generator=gen, device=device).to(p_dtype)
    if v_dtype == torch.int8:
        v = torch.randint(-127, 127, (g, k, n), generator=gen, device=device,
                          dtype=torch.int8)
    else:
        v = torch.randn((g, k, n), generator=gen, device=device).to(v_dtype)
    return p, v


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def probe(modes: Sequence[str] = MODES, shapes=SHAPES, *, device="cuda",
          reps: int = 20) -> Dict[str, dict]:
    """Run each mode at `shapes`; {mode: {"ms", "tflops", "shape"}} with
    times None on the CPU, where nothing is timed."""
    device = resolve_device(device)
    g, m, k, n = shapes
    flops = 2 * g * m * k * n
    out = {}
    for mode in modes:
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; modes are {MODES}")
        p, v = make_inputs(mode, shapes, device=device)
        result = int8_pv(p, v, mode)
        if result.shape != (g, m, n) or not bool(result.isfinite().all()):
            raise AssertionError(f"{mode}: output {tuple(result.shape)} is "
                                 "not finite or not (G, M, N)")
        ms = None
        if device.type == "cuda":
            ms = device_ms(lambda: int8_pv(p, v, mode), reps=reps)
        out[mode] = {"ms": ms, "tflops": None if ms is None else flops / ms / 1e9,
                     "shape": list(shapes)}
        if ms is None:
            print(f"{mode}: G={g} M={m} K={k} N={n}, plain version on "
                  f"{device}; device time not measured", flush=True)
        else:
            print(f"{mode}: {ms:.3f} ms ({out[mode]['tflops']:.0f} TF/s)",
                  flush=True)
        del p, v, result
    return out


def main(argv=None, *, device="cuda", shapes=SHAPES) -> Dict[str, dict]:
    """Probe the modes named in `argv` (all by default) and print a JSON
    line of the results last."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("modes", nargs="*", default=list(MODES),
                        help=f"any of {', '.join(MODES)}")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    results = probe(args.modes, shapes, device=device, reps=args.reps)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
