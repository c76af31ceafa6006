"""ZeRO-1 optimizer-state sharding (the port of the JAX package's
parallel/zero.py).

Each dp rank keeps its slice of Adam's m and v along the largest dim that
divides by dp (`zero1_spec_for`), updates that slice of the parameter, and
all-gathers the new parameter over dp (`train_state.AdamW.step`).
Parameters stay whole (or tensor-parallel); checkpoints hold the gathered
moments, so a run resumes under any layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hsenet_torch.parallel.mesh import axis_group, axis_rank, axis_size

Spec = Tuple[Optional[str], ...]


def zero1_spec_for(leaf, dp: int) -> Spec:
    """"dp" on the largest dim divisible by dp; replicated otherwise."""
    shape = tuple(getattr(leaf, "shape", ()))
    if not shape:
        return ()
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % dp == 0 and shape[d] >= dp:
            spec = [None] * len(shape)
            spec[d] = "dp"
            return tuple(spec)
    return ()


def zero1_dim(leaf, dp: int) -> Optional[int]:
    spec = zero1_spec_for(leaf, dp)
    return spec.index("dp") if "dp" in spec else None


def shard_opt_state(opt_state, params, mesh):
    """`opt_state` (an `AdamWState` over `params`, in order) with each
    moment cut to this dp rank's ZeRO-1 slice; `dims` records the split
    dim of each (None: kept whole), `group` the dp group."""
    from hsenet_torch.train.train_state import AdamWState

    dp = axis_size(mesh, "dp")
    if dp == 1:
        return opt_state
    rank = axis_rank(mesh, "dp")
    dims = [zero1_dim(p, dp) for p in params]

    def cut(t: torch.Tensor, d: Optional[int]) -> torch.Tensor:
        return t if d is None else t.chunk(dp, dim=d)[rank].clone()

    return AdamWState(
        opt_state.count,
        [cut(t, d) for t, d in zip(opt_state.mu, dims)],
        [cut(t, d) for t, d in zip(opt_state.nu, dims)],
        zero1_dims=dims, zero1_group=axis_group(mesh, "dp"),
        zero1_rank=rank, zero1_size=dp,
    )
