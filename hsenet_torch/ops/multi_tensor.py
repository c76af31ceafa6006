"""The train step's optimizer over every trained leaf at once: the wrapper of
`csrc/multi_tensor_adamw.cu` (see there for the arithmetic and the bound).

Two calls replace the leaf-by-leaf loops of `train/train_state.py`:

  * `sum_of_squares(grads)`: each gradient's sum of squares, an f32 vector
    with one entry per leaf (`global_norm` adds it up, by split class over
    a mesh);
  * `adamw_(params, grads, mus, nus, grad_norm, ...)`: the clip by
    `grad_norm` and one AdamW update of `params`, `mus` and `nus` in place.

Each launches through a registered operator (`ops/library.py`), so that a
profile finds the kernels under an operation and so under the train step's
`train.optimizer` span.

Every leaf on the card goes to the kernels (`fused_route`): a gradient of
another dtype or strides is summed and applied from a contiguous f32 copy
(`as_f32`); the kernels take the rest as they are. Leaves on the CPU keep
the plain versions (`sum_of_squares_per_leaf`, `AdamW.update_per_leaf`).
The leaves are cut into chunks of `CHUNK` elements (`chunk_plan`, cached
per set of sizes); a table of at most `MAX_LEAVES` leaves goes to each
launch by value, so a step is 2 launches for the squares and 1 for the
update per `MAX_LEAVES` leaves.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

from hsenet_torch.ops import _build, library

KERNEL = "multi_tensor_adamw"
CHUNK = 65536  # elements of one leaf a CTA (kChunk)
MAX_LEAVES = 640  # leaves of one launch's table (kMaxLeaves)


class _Table(ctypes.Structure):
    """`LeafTable` of csrc/multi_tensor_adamw.cu; ptr rows: g, p, mu, nu."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("chunk_start", ctypes.c_int * (MAX_LEAVES + 1)),
        ("numel", ctypes.c_longlong * MAX_LEAVES),
        ("ptr", (ctypes.c_void_p * MAX_LEAVES) * 4),
    ]


@dataclass(frozen=True)
class ChunkPlan:
    """How the kernels cut leaves of these sizes: leaf i holds the chunks
    [chunk_start[i], chunk_start[i + 1]), chunk j of it the elements
    [j * CHUNK, min((j + 1) * CHUNK, numel)). A leaf of 0 elements has no
    chunk. `template` is the bytes of a `_Table` of these leaves without
    pointers."""

    numels: Tuple[int, ...]
    chunk_start: Tuple[int, ...]
    template: bytes = field(repr=False, compare=False)

    @property
    def chunks(self) -> int:
        return self.chunk_start[-1]

    def table(self, *rows: Sequence[torch.Tensor]) -> _Table:
        """A fresh table of these leaves with the data pointers of `rows`
        (g; or g, p, mu, nu)."""
        t = _Table.from_buffer_copy(self.template)
        for r, tensors in enumerate(rows):
            t.ptr[r][:len(tensors)] = [x.data_ptr() for x in tensors]
        return t


@functools.lru_cache(maxsize=64)
def chunk_plan(numels: Tuple[int, ...]) -> ChunkPlan:
    """The cut of leaves of `numels` elements (at most MAX_LEAVES)."""
    if not 1 <= len(numels) <= MAX_LEAVES:
        raise ValueError(f"a table holds 1 to {MAX_LEAVES} leaves, got {len(numels)}")
    starts = tuple(itertools.accumulate((-(-n // CHUNK) for n in numels), initial=0))
    if starts[-1] >= 2**31:
        raise ValueError(f"{starts[-1]} chunks do not fit one grid")
    t = _Table()
    t.n = len(numels)
    t.chunk_start[:t.n + 1] = starts
    t.numel[:t.n] = numels
    return ChunkPlan(tuple(numels), starts, bytes(t))


def fused_route(t: torch.Tensor) -> bool:
    """Whether the kernels take leaves on `t`'s device: those on CUDA."""
    return t.is_cuda


def as_f32(g: torch.Tensor) -> torch.Tensor:
    """`g` as the kernels read a gradient: itself when it is contiguous f32,
    else a contiguous f32 copy."""
    if g.dtype is torch.float32 and g.is_contiguous():
        return g
    return g.to(torch.float32).contiguous()


def _groups(n: int):
    return [range(i, min(i + MAX_LEAVES, n)) for i in range(0, n, MAX_LEAVES)]


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry `hsenet_multi_tensor_<name>`."""
    lib = _build.load(KERNEL)
    size = lib.hsenet_multi_tensor_table_bytes()
    if size != ctypes.sizeof(_Table):
        raise RuntimeError(f"{KERNEL}: the kernel's table is {size} bytes, "
                           f"the wrapper's {ctypes.sizeof(_Table)}")
    fn = getattr(lib, f"hsenet_multi_tensor_{name}")
    fn.argtypes = {
        "sum_squares": [ctypes.c_void_p] * 3,
        "leaf_sums": [ctypes.c_void_p] * 4,
        "adamw": [ctypes.c_void_p] * 2 + [ctypes.c_float] * 10 + [ctypes.c_void_p],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, *args) -> None:
    err = _entry(name)(*args)
    if err != 0:
        raise RuntimeError(f"{KERNEL} {name} launch failed: CUDA error {err}")
    launches[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(tensors: Sequence[torch.Tensor], device: torch.device) -> None:
    for t in tensors:
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{KERNEL} takes contiguous float32 tensors on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ', not contiguous'}")


def sum_of_squares_per_leaf(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernels' plain version: each leaf's `g.float().pow(2).sum()`,
    stacked."""
    return torch.stack([g.float().pow(2).sum() for g in grads])


def sum_of_squares(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The f32 sum of the squares of each of `grads`, an [n] vector: through
    `hsenet_torch::multi_tensor_sum_squares` when they are on `fused_route`,
    else by `sum_of_squares_per_leaf`."""
    if not all(fused_route(g) for g in grads):
        return sum_of_squares_per_leaf(grads)
    return sum_squares_op([as_f32(g) for g in grads])


def _sum_squares_cuda(grads: List[torch.Tensor]) -> torch.Tensor:
    """`hsenet_torch::multi_tensor_sum_squares` on CUDA tensors: 2 launches
    a table."""
    device = grads[0].device
    _check(grads, device)
    out = torch.empty(len(grads), dtype=torch.float32, device=device)
    stream = _stream(out)
    for group in _groups(len(grads)):
        leaves = [grads[i] for i in group]
        plan = chunk_plan(tuple(g.numel() for g in leaves))
        table = plan.table(leaves)
        partials = torch.empty(plan.chunks, dtype=torch.float32, device=device)
        _launch("sum_squares", ctypes.addressof(table), partials.data_ptr(), stream)
        _launch("leaf_sums", ctypes.addressof(table), partials.data_ptr(),
                out[group.start:].data_ptr(), stream)
    return out


def _sum_squares_fake(grads):
    return grads[0].new_empty(len(grads), dtype=torch.float32)


sum_squares_op = library.define(
    "multi_tensor_sum_squares", "(Tensor[] grads) -> Tensor",
    cuda=_sum_squares_cuda, cpu=sum_of_squares_per_leaf, fake=_sum_squares_fake,
)


def _f32(x: float) -> float:
    return float(np.float32(x))


def adamw_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
           mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
           grad_norm: torch.Tensor, *, max_norm: float, b1: float, b2: float,
           eps: float, weight_decay: float, lr: float, c1: float,
           c2: float) -> None:
    """Clip by `grad_norm` (a device scalar: the global norm) and one AdamW
    update of `params`, `mus` and `nus` in place, by the kernel (through
    `hsenet_torch::multi_tensor_adamw_`), with the bias corrections `c1`,
    `c2` and the learning rate `lr` of this step. Every tensor must be
    contiguous f32 on one CUDA device; `grads` are left as they are."""
    # as the loop's PyTorch kernels round them: a Python float operand
    # becomes an f32, and a tensor divided by one is multiplied by its
    # reciprocal, taken in f64 and rounded to f32 (measured on the card)
    hyper = [_f32(max_norm), _f32(b1), _f32(1.0 - b1), _f32(b2), _f32(1.0 - b2),
             _f32(1.0 / c1), _f32(1.0 / c2), _f32(eps), _f32(weight_decay),
             _f32(-lr)]
    adamw_op(list(params), list(grads), list(mus), list(nus), grad_norm, hyper)


def _adamw_cuda(params, grads, mus, nus, grad_norm, hyper) -> None:
    """`hsenet_torch::multi_tensor_adamw_` on CUDA tensors: 1 launch a
    table."""
    device = params[0].device
    _check([*params, *grads, *mus, *nus, grad_norm], device)
    if grad_norm.numel() != 1 or len(hyper) != 10:
        raise ValueError("grad_norm must hold one value and hyper ten")
    for row in (grads, mus, nus):
        if [t.shape for t in row] != [p.shape for p in params]:
            raise ValueError("grads, mus and nus must match params leaf for leaf")
    stream = _stream(grad_norm)
    for group in _groups(len(params)):
        rows = [[row[i] for i in group] for row in (grads, params, mus, nus)]
        plan = chunk_plan(tuple(p.numel() for p in rows[1]))
        table = plan.table(*rows)
        _launch("adamw", ctypes.addressof(table), grad_norm.data_ptr(), *hyper,
                stream)


adamw_op = library.define(
    "multi_tensor_adamw_",
    "(Tensor(a!)[] params, Tensor[] grads, Tensor(b!)[] mus, Tensor(c!)[] nus, "
    "Tensor grad_norm, float[] hyper) -> ()",
    cuda=_adamw_cuda, fake=lambda *args: None,
)


# launches since the last reset, by entry; the leaves `AdamW.step` gave to
# each route (fused: on the card; per_leaf: on the CPU)
launches = {"sum_squares": 0, "leaf_sums": 0, "adamw": 0}
routes = {"fused": 0, "per_leaf": 0}


def reset_launch_counts() -> None:
    for counts in (launches, routes):
        for k in counts:
            counts[k] = 0
