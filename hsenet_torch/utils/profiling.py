"""Profiling and timing helpers (the port of the JAX package's
utils/profiling.py).

`trace` records a torch.profiler trace of the block (host and CUDA
activity) and writes it as a Chrome/Perfetto trace file; `time_fn` times a
call with warm-up, synchronising the device of its outputs; and simple
FLOP and MFU accounting for the encode path.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

# one H100 SXM's dense bf16 tensor-core peak (NVIDIA's data sheet, without
# sparsity, at the 700 W power limit)
H100_BF16_PEAK_FLOPS = 989e12


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Record host and CUDA activity of the block with torch.profiler and
    write it to `<logdir>/trace.json` (open it in Perfetto or
    chrome://tracing). `logdir` defaults to `hsenet_trace` under the
    temporary directory. Yields the trace file's path."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "hsenet_trace")
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def _sync(out) -> None:
    """Wait for the devices of the tensors in `out` (nested tuples, lists
    and dicts) to finish their work."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _sync(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _sync(v)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 5,
            **kwargs) -> Dict[str, float]:
    """Best and mean wall-clock seconds of `fn(*args, **kwargs)`, each call
    closed by a synchronise of its outputs' devices, after `warmup` calls."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {"best_s": min(times), "mean_s": sum(times) / len(times),
            "iters": iters}


def transformer_flops(batch: int, seq: int, hidden: int, mlp: int, layers: int,
                      extra_matmul_flops: float = 0.0) -> float:
    """Forward FLOPs of a standard pre-LN transformer stack (2 x MACs)."""
    per_layer = (
        4 * seq * hidden * hidden * 2  # qkv + out projections
        + 2 * seq * seq * hidden * 2  # attention score + weighted sum
        + 2 * seq * hidden * mlp * 2  # mlp
    )
    return batch * (layers * per_layer + extra_matmul_flops)


def vit3d_encode_flops(batch: int, cfg) -> float:
    """Forward FLOPs of one ViT3D tower (patch embed + blocks)."""
    patch_embed = cfg.num_patches * cfg.patch_dim * cfg.hidden_size * 2
    return transformer_flops(batch, cfg.seq_len, cfg.hidden_size, cfg.mlp_dim,
                             cfg.num_layers, extra_matmul_flops=patch_embed)


def mfu(flops: float, seconds: float,
        peak_flops: float = H100_BF16_PEAK_FLOPS) -> float:
    """Model FLOPs utilisation against a peak; the default is one H100
    SXM's dense bf16 peak, 989 TFLOP/s (a card set below its 700 W power
    limit reaches less)."""
    return flops / seconds / peak_flops
