"""The process mesh and its collectives (the port of the JAX package's
parallel/mesh.py): ("dp", "tp"), ("dp", "pp") or ("dp", "sp").

The JAX package runs one SPMD program over every device and XLA inserts
the collectives. The port runs one process per device, launched by
`torchrun --nproc-per-node N -m hsenet_torch.cli.<cli> ...`, and its
collectives are explicit:

  * data parallel: each dp rank loads its own rows of the global batch
    (`data.datasets.DataLoader(num_shards=dp, shard_index=dp rank)`), and
    the train step averages the gradients over dp;
  * tensor parallel: the LLM's projections, embedding and LM head hold
    their Megatron shards (`parallel/sharding.py`), and the layers call the
    autograd collectives below;
  * the global contrastive loss gathers every rank's features with
    `gather_with_grad`, whose backward sums the gradients of each shard
    over the ranks: the reference's `torch.distributed.nn.all_gather`;
  * pipeline parallel (`parallel/pipeline.py`): each pp rank holds a stage
    of the decoder's layers, activations travel stage to stage, and the
    last stage's hidden states reach every stage through `broadcast_from`;
  * sequence parallel (`parallel/sp.py`): each sp rank holds a contiguous
    chunk of the tokens, and ring attention rotates K/V with `ppermute`.

pp and sp compose with dp only, as in the JAX package: the pp (or sp)
axis is the inner one, so a stage's (or a ring's) ranks are neighbours.

`init_distributed` joins the process group that torchrun's environment
describes (NCCL on the card, gloo on the CPU); a caller that has joined a
group of its own (two ranks sharing one card need gloo) keeps it. `create_mesh`
returns a `DeviceMesh` with axes ("dp", "tp"), ("dp", "pp") or ("dp", "sp"),
or None where no process group exists and the mesh is 1 x 1: then every
caller takes the single-card path unchanged. An axis the mesh lacks has
size 1. Nothing falls back: a failed group or a missing collective raises.

Gloo takes host tensors only for most collectives, so a collective over
a gloo group stages a CUDA tensor through host memory.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
import torch.distributed as dist

from hsenet_torch.configs import MeshConfig

def init_distributed(device, *, init_method: Optional[str] = None) -> bool:
    """Join the process group of RANK / WORLD_SIZE (LOCAL_RANK picks the
    card). Returns True when a group exists afterwards, False when the
    environment names none and no `init_method` is given (one process)."""
    if dist.is_initialized():
        return True
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return False
    device = torch.device(device)
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    return True


def create_mesh(config: Optional[MeshConfig] = None, device="cuda"):
    """A `DeviceMesh` over every process of the group: ("dp", "pp") where
    pp is above 1, ("dp", "sp") where sp is, else ("dp", "tp"); None for a
    1 x 1 mesh without a group. dp = -1 takes world // (the inner axis).
    pp and sp compose with dp only; the JAX package's asserts of that, and
    of a mesh that needs more processes than the group has, are ValueErrors
    with its messages here; so is a mesh that leaves processes out."""
    config = config or MeshConfig()
    if config.pp > 1:
        if config.tp != 1 or config.sp != 1:
            raise ValueError("pp composes with dp only (pipeline.py)")
        inner, names = config.pp, ("dp", "pp")
    elif config.sp > 1:
        if config.tp != 1:
            raise ValueError("sp composes with dp only (parallel/sp.py)")
        inner, names = config.sp, ("dp", "sp")
    else:
        inner, names = config.tp, tuple(config.axis_names)
    n = dist.get_world_size() if dist.is_initialized() else 1
    dp = config.dp if config.dp > 0 else n // inner
    if dp < 1 or dp * inner > n:
        raise ValueError(f"mesh {max(dp, 1)}x{inner} needs more than {n} devices")
    if not dist.is_initialized():
        return None
    if dp * inner != n:
        raise ValueError(f"mesh {dp}x{inner} leaves {n - dp * inner} of {n} "
                         "processes without a place")
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh's device type only places DTensors, which the port does not
    # use; a gloo group (CPU ranks, or ranks sharing one card) takes "cpu"
    device_type = (torch.device(device).type if dist.get_backend() == "nccl"
                   else "cpu")
    return init_device_mesh(device_type, (dp, inner), mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    """The size of `axis` ("dp", "tp", "pp" or "sp"); 1 without a mesh or
    where the mesh has no such axis."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh, axis: str) -> int:
    """This process's coordinate along `axis`; 0 without a mesh or such an
    axis."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def is_main_process() -> bool:
    """Rank 0 of the group, or the only process: the one that logs and
    writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


# ---- collectives (host-staged over gloo) ----

def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or `op`) of `t` over `group`, as a new tensor."""
    if _staged(group, t):
        host = t.detach().cpu()
        dist.all_reduce(host, op=op, group=group)
        return host.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (of one shape) concatenated along `dim` in rank
    order."""
    size = dist.get_world_size(group)
    src = t.detach().contiguous()
    if _staged(group, src):
        host = src.cpu()
        parts: List[torch.Tensor] = [torch.empty_like(host) for _ in range(size)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(t.device)
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along `dim` of the sum of `t` over `group`."""
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if dist.get_backend(group) == "nccl":
        src = t.detach().movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // size,) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim)
    total = all_reduce(t, group)
    return total.chunk(size, dim=dim)[rank].contiguous()


def broadcast(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """Rank `src`'s (a rank of `group`) `t` on every rank of the group, as a
    new tensor; `t` gives the shape and dtype on the others."""
    root = dist.get_global_rank(group, src)
    out = t.detach().contiguous()
    if _staged(group, out):
        host = out.cpu()
        dist.broadcast(host, root, group=group)
        return host.to(t.device)
    out = out.clone()
    dist.broadcast(out, root, group=group)
    return out


def send(t: torch.Tensor, group, dst: int, tag: int = 0) -> None:
    """Send `t` to rank `dst` of `group` (blocking)."""
    src = t.detach().contiguous()
    dist.send(src.cpu() if _staged(group, src) else src,
              dist.get_global_rank(group, dst), group=group, tag=tag)


def recv(like: torch.Tensor, group, src: int, tag: int = 0) -> torch.Tensor:
    """A tensor of `like`'s shape, dtype and device, received from rank
    `src` of `group`."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if _staged(group, like) else like.device)
    dist.recv(buf, dist.get_global_rank(group, src), group=group, tag=tag)
    return buf.to(like.device)


def _rotate(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Each rank i's `t` lands on rank (i + shift) mod n of `group`: one
    send and one receive a rank, posted together (`batch_isend_irecv`), so
    no order of the ring deadlocks."""
    n = dist.get_world_size(group)
    if shift % n == 0:
        return t.detach().clone()
    i = dist.get_rank(group)
    out = t.detach().contiguous()
    staged = _staged(group, out)
    if staged:
        out = out.cpu()
    buf = torch.empty_like(out)
    ops = [dist.P2POp(dist.isend, out, dist.get_global_rank(group, (i + shift) % n),
                      group),
           dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, (i - shift) % n),
                      group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return buf.to(t.device) if staged else buf


def broadcast_object(obj, src: int = 0):
    """`obj` of rank `src`, on every rank (itself without a group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


# ---- autograd collectives ----

class _CopyToGroup(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g: sum over the group forward, identity gradient."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    """Concatenate the ranks' shards along `dim`; the gradient of the
    replicated result is sliced back to this rank's shard."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.width,
                           ctx.width).contiguous(), None, None


class _GatherWithGrad(torch.autograd.Function):
    """All-gather along `dim` whose backward sums every rank's gradient of
    the gathered tensor and returns this rank's shard of the sum
    (`torch.distributed.nn.all_gather`'s gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad.contiguous(), ctx.group, ctx.dim), None, None


class _PPermute(torch.autograd.Function):
    """The JAX package's ppermute by a shift: rank i's tensor goes to rank
    (i + shift) mod n; the backward rotates the cotangent the other way
    (its transpose)."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _rotate(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _rotate(grad, ctx.group, -ctx.shift), None, None


class _BroadcastFrom(torch.autograd.Function):
    """Rank `src`'s tensor on every rank of the group (the JAX package's
    psum of a value masked to one rank). Every rank goes on to compute the
    same loss from it, so the gradient is that loss's once: the source
    keeps its own cotangent and the others pass zeros."""

    @staticmethod
    def forward(ctx, x, group, src):
        ctx.is_src = dist.get_rank(group) == src
        return broadcast(x, group, src)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.is_src else torch.zeros_like(grad)), None, None


def ppermute(x, group, shift: int = 1):
    """Rank i of `group` receives the `x` of rank (i - shift) mod n, with
    the transposed rotation as its gradient."""
    return _PPermute.apply(x, group, shift)


def broadcast_from(x, group, src: int):
    """Rank `src`'s `x` on every rank of `group`; its gradient reaches the
    source once."""
    return _BroadcastFrom.apply(x, group, src)


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x, group, dim: int = -1):
    return _GatherFromGroup.apply(x, group, dim % x.dim())


def gather_with_grad(x, group, dim: int = 0):
    return _GatherWithGrad.apply(x, group, dim % x.dim())
