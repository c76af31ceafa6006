"""Train state, schedule and optimizer (the port of the JAX package's
train/train_state.py).

`make_optimizer` is optax's `chain(clip_by_global_norm(max_grad_norm),
adamw(schedule, b1, b2, eps, weight_decay))`, masked to the trainable
leaves, written out step for step so that both packages take the same
update:

  * the global norm covers the trainable gradients only, and scales them by
    max_norm / norm only when norm >= max_norm (no epsilon);
  * Adam's moments are mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu,
    bias-corrected by 1 - b^count with count counted from 1, and the update
    is mu_hat / (sqrt(nu_hat) + eps), plus weight_decay * param;
  * the learning rate is the schedule at the step count BEFORE it is
    incremented, so the first step (count 0) takes lr = schedule(0), 0 in
    warmup.

Parameters are updated in place. Freezing is `requires_grad=False` on the
leaves the mask leaves out, which also keeps autograd from computing
their gradients.

Two routes compute this update, with the same arithmetic op for op (the
same bits from the same grad_norm, measured on an H100). On the card every
leaf takes the fused route (`ops/multi_tensor.py`,
`csrc/multi_tensor_adamw.cu`): one launch updates all of them, and two
launches give `global_norm` every gradient's sum of squares. A gradient of
another dtype or strides goes in as a contiguous f32 copy, a strided
param or moment as a contiguous copy written back after the launch, and a
ZeRO-1 leaf as its slice, gathered after the launch; the masters and
moments must be f32 there (`train/vlm.py` `to_training_dtypes`). On the
CPU every leaf takes the per-leaf loop, `AdamW.update_per_leaf`, which is
also the plain version the kernel is held to; its squares are
`g.float().pow(2).sum()` a leaf. Nothing but the tensors' device chooses
the route.

Over a mesh (`TrainState.create(..., mesh=)`) the train step averages the
gradients over dp (`reduce_gradients`), sums those of the sequence-parallel
ring's leaves over sp (`sum_over_sp`) and takes the global norm over every
shard once (`global_norm(..., model=)`; a pipeline stage's own layers
count once each). Under ZeRO-1
(`parallel/zero.shard_opt_state`) each dp rank holds its slice of m and v,
updates that slice of the parameter and all-gathers the parameter.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from hsenet_torch.configs import TrainConfig
from hsenet_torch.ops import multi_tensor

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _warmup_cosine(peak: float, warmup: int, decay_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps, 0)."""
    rise = _linear(0.0, peak, warmup)
    span = decay_steps - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return rise(count)
        t = min(count - warmup, span)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / span))

    return schedule


def make_schedule(cfg: TrainConfig) -> Schedule:
    """Warmup + cosine (or + constant), as the JAX package builds it."""
    warmup = max(1, int(cfg.total_steps * cfg.warmup_ratio))
    if cfg.schedule == "cosine":
        # optax requires decay_steps > warmup_steps; a 1-step run
        # degenerates to warmup only
        return _warmup_cosine(
            cfg.learning_rate, warmup, max(cfg.total_steps, warmup + 1)
        )
    if cfg.schedule == "constant":
        rise = _linear(0.0, cfg.learning_rate, warmup)
        return lambda count: rise(count) if count < warmup else cfg.learning_rate
    raise ValueError(cfg.schedule)


@dataclass
class AdamWState:
    """Adam's count and moments, one per trainable leaf in order. Under
    ZeRO-1 `zero1_dims[i]` is the dim along which leaf i's moments hold
    only this dp rank's slice (None: whole), over `zero1_group`."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    zero1_dims: Optional[List[Optional[int]]] = None
    zero1_group: object = None
    zero1_rank: int = 0
    zero1_size: int = 1


class AdamW:
    """Global-norm clipping + AdamW over the leaves that `trainable_mask`
    (parameter name -> bool; None trains every leaf) selects."""

    def __init__(self, cfg: TrainConfig,
                 trainable_mask: Optional[Mapping[str, bool]] = None):
        self.schedule = make_schedule(cfg)
        self.cfg = cfg
        self.trainable_mask = trainable_mask

    def trainable(self, model: nn.Module) -> Dict[str, nn.Parameter]:
        """The model's trainable leaves by name; every other leaf is set to
        requires_grad=False."""
        out = {}
        for name, p in model.named_parameters():
            keep = self.trainable_mask is None or bool(self.trainable_mask[name])
            p.requires_grad_(keep)
            if keep:
                out[name] = p
        return out

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        zeros = [torch.zeros_like(p) for p in params.values()]
        return AdamWState(0, zeros, [torch.zeros_like(z) for z in zeros])

    def coefficients(self, count: int):
        """(lr, c1, c2) of the step from Adam's `count`: the schedule before
        the increment, and the bias corrections 1 - b^(count + 1)."""
        cfg = self.cfg
        return (self.schedule(count), 1.0 - cfg.adam_b1 ** (count + 1),
                1.0 - cfg.adam_b2 ** (count + 1))

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: AdamWState, grad_norm: torch.Tensor) -> AdamWState:
        """Clip by `grad_norm` (the global norm of `grads`), then one AdamW
        update of `params` in place: on the card by the multi-tensor kernel,
        on the CPU by `update_per_leaf`. `grads` may be overwritten."""
        cfg = self.cfg
        dims = state.zero1_dims or [None] * len(params)
        leaves = list(zip(params, grads, state.mu, state.nu, dims))
        if not multi_tensor.fused_route(grad_norm):
            multi_tensor.routes["per_leaf"] += len(leaves)
            self.update_per_leaf(leaves, state, grad_norm)
            return dataclasses.replace(state, count=state.count + 1)
        multi_tensor.routes["fused"] += len(leaves)
        rows = ([], [], [], [])  # p, g, mu, nu as the kernel takes them
        back = []  # (a strided param or moment, the copy the kernel updates)
        gathers = []  # ZeRO-1: (the whole param, its split dim)
        for i, (p, g, mu, nu, dim) in enumerate(leaves):
            if not p.dtype is mu.dtype is nu.dtype is torch.float32:
                raise TypeError(
                    f"AdamW on the card takes f32 masters and moments "
                    f"(to_training_dtypes); leaf {i} holds {p.dtype}, "
                    f"{mu.dtype} and {nu.dtype}")
            if dim is not None:  # ZeRO-1: this rank's slice only
                gathers.append((p, dim))
                p, g = (t.chunk(state.zero1_size, dim=dim)[state.zero1_rank]
                        for t in (p, g))
            rows[1].append(multi_tensor.as_f32(g))
            for row, t in zip((rows[0], rows[2], rows[3]), (p, mu, nu)):
                if not t.is_contiguous():
                    back.append((t, t.contiguous()))
                    t = back[-1][1]
                row.append(t)
        lr, c1, c2 = self.coefficients(state.count)
        multi_tensor.adamw_(rows[0], rows[1], rows[2], rows[3], grad_norm,
                            max_norm=cfg.max_grad_norm, b1=cfg.adam_b1,
                            b2=cfg.adam_b2, eps=cfg.adam_eps,
                            weight_decay=cfg.weight_decay, lr=lr, c1=c1, c2=c2)
        for t, copy in back:
            t.copy_(copy)
        if gathers:
            from hsenet_torch.parallel.mesh import all_gather

            for whole, dim in gathers:
                mine = whole.chunk(state.zero1_size, dim=dim)[state.zero1_rank]
                whole.copy_(all_gather(mine, state.zero1_group, dim))
        return dataclasses.replace(state, count=state.count + 1)

    @torch.no_grad()
    def update_per_leaf(self, leaves: Sequence[tuple], state: AdamWState,
                        grad_norm: torch.Tensor) -> None:
        """`step`'s update of `leaves`, each (param, grad, mu, nu, ZeRO-1
        dim or None), one leaf at a time in plain PyTorch: the plain version
        that the fused kernel is held to, and the route of every leaf on the
        CPU. The grads are overwritten."""
        cfg = self.cfg
        lr, c1, c2 = self.coefficients(state.count)
        # scale by max/norm when norm >= max, else by exactly 1 (a device
        # scalar, so the step never waits on the host)
        clip = torch.where(grad_norm < cfg.max_grad_norm, 1.0,
                           cfg.max_grad_norm / grad_norm)
        for p, g, mu, nu, dim in leaves:
            g = g.to(p.dtype).mul_(clip)
            whole = p
            if dim is not None:  # ZeRO-1: this rank's slice only
                g = g.chunk(state.zero1_size, dim=dim)[state.zero1_rank]
                p = p.chunk(state.zero1_size, dim=dim)[state.zero1_rank].clone()
            mu.mul_(cfg.adam_b1).add_(g, alpha=1.0 - cfg.adam_b1)
            nu.mul_(cfg.adam_b2).addcmul_(g, g, value=1.0 - cfg.adam_b2)
            update = (mu / c1).div_((nu / c2).sqrt_().add_(cfg.adam_eps))
            if cfg.weight_decay:
                update.add_(p, alpha=cfg.weight_decay)
            p.sub_(update, alpha=lr)
            if dim is not None:
                from hsenet_torch.parallel.mesh import all_gather

                whole.copy_(all_gather(p, state.zero1_group, dim))


def make_optimizer(cfg: TrainConfig,
                   trainable_mask: Optional[Mapping[str, bool]] = None) -> AdamW:
    """AdamW + global-norm clipping; `trainable_mask` (name -> bool) picks
    the leaves it trains, as the JAX package's optax mask does."""
    return AdamW(cfg, trainable_mask)


@functools.lru_cache(maxsize=16)
def _class_masks(classes: Tuple[int, ...], n: int,
                 device: torch.device) -> torch.Tensor:
    """[n, len(classes)] bool, row c marking the leaves of class c: made
    once per set of classes, so that a step copies nothing to the device
    (a copy from host memory would wait for the whole backward)."""
    index = torch.tensor(classes, device=device)
    return torch.arange(n, device=device)[:, None] == index


def global_norm(grads: List[torch.Tensor], names: Sequence[str] = (),
                model: Optional[nn.Module] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32, from each
    leaf's sum of squares (`multi_tensor.sum_of_squares`). With `model`
    sharded over a mesh (`parallel/sharding.py`) and `names` the grads'
    leaves, the squares of a split leaf are summed over the ranks that
    split it, so every rank holds the norm of the full gradients."""
    squares = multi_tensor.sum_of_squares(grads)
    dims = model.__dict__.get("shard_dims", {}) if model is not None else {}
    stage = model.__dict__.get("pipeline") if model is not None else None
    if stage is None and not dims:
        return torch.sqrt(squares.sum())

    def by_class(classes: List[int], n: int) -> torch.Tensor:
        # a masked sum, not index_add_: its CUDA kernel adds by atomics
        masks = _class_masks(tuple(classes), n, squares.device)
        return torch.where(masks, squares, 0.0).sum(dim=1)

    if stage is not None:
        # a pipeline stage's own layers' squares are summed over pp; the
        # replicated leaves' gradients are alike on every stage
        from hsenet_torch.parallel.mesh import all_reduce

        own = by_class([int(stage.holds(name)) for name in names], 2)
        return torch.sqrt(own[0] + all_reduce(own[1:], stage.group)[0])
    from hsenet_torch.parallel.mesh import all_reduce, axis_group

    mesh = model.mesh
    # squares by the axes a leaf is split over: none, tp, dp, both
    splits = [dims.get(name, (None, None)) for name in names]
    sums = by_class([(tp is not None) + 2 * (dp is not None) for tp, dp in splits], 4)
    dp_part = all_reduce(sums[2:], axis_group(mesh, "dp"))
    tp_part = all_reduce(torch.stack([sums[1], dp_part[1]]),
                         axis_group(mesh, "tp"))
    return torch.sqrt(sums[0] + dp_part[0] + tp_part.sum())


def reduce_gradients(grads: List[torch.Tensor], names: Sequence[str],
                     model: nn.Module, mesh) -> List[torch.Tensor]:
    """The mean over dp of every rank's gradients: one summed all-reduce of
    the whole leaves, flattened together per dtype, divided by dp. A
    dp-split (FSDP) leaf's gradient already holds the sum over dp (its
    gather's backward scatters it), so it is only divided."""
    from hsenet_torch.parallel.mesh import all_reduce, axis_group, axis_size

    dp = axis_size(mesh, "dp")
    if dp == 1:
        return grads
    dims = model.__dict__.get("shard_dims", {})
    out = list(grads)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, (name, g) in enumerate(zip(names, grads)):
        if dims.get(name, (None, None))[1] is not None:
            out[i] = g / dp
        else:
            groups.setdefault(g.dtype, []).append(i)
    for idx in groups.values():
        flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]),
                          axis_group(mesh, "dp"))
        flat.div_(dp)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def sum_over_sp(grads: List[torch.Tensor], names: Sequence[str],
                region: Sequence[str], mesh) -> List[torch.Tensor]:
    """`grads` with those of the leaves named under one of the `region`
    prefixes summed over the mesh's sp axis (one flat all-reduce per
    dtype): inside the sequence-parallel ring each rank's gradient of such
    a leaf covers its own token chunk only."""
    from hsenet_torch.parallel.mesh import all_reduce, axis_group, axis_size

    if axis_size(mesh, "sp") == 1:
        return grads
    out = list(grads)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, (name, g) in enumerate(zip(names, grads)):
        if name.startswith(tuple(region)):
            groups.setdefault(g.dtype, []).append(i)
    for idx in groups.values():
        flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]),
                          axis_group(mesh, "sp"))
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


@dataclass
class TrainState:
    """Step count, the model's trainable leaves by name (parameters of the
    model, updated in place), the optimizer state, and the model itself
    (its frozen leaves and buffers, e.g. int8 codes, are not in `params`)."""

    step: int
    params: Dict[str, nn.Parameter]
    opt_state: AdamWState
    model: Optional[nn.Module] = None
    mesh: object = None

    @classmethod
    def create(cls, model: nn.Module, tx: AdamW, mesh=None) -> "TrainState":
        """The state over `model`'s trainable leaves; `mesh` (a (dp, tp)
        `DeviceMesh`, `parallel/mesh.py`) makes the train step average the
        gradients over dp."""
        params = tx.trainable(model)
        return cls(step=0, params=params, opt_state=tx.init(params), model=model,
                   mesh=mesh)
