"""Parameter partition rules, tensor parallelism and FSDP (the port of the
JAX package's parallel/sharding.py).

A spec is a tuple with one entry per leading dim of a leaf: the mesh axis
("tp" or "dp") that dim is split over, or None; `()` is replicated. The
rules follow the JAX package's Megatron placement over the port's layout:
the port's `weight` / `weight_q` are (out, in), Flax kernels (in, out), and
the port's decoder layers are separate modules where the JAX package stacks
them on a leading scan axis. So:

  * column-parallel (q/k/v/gate/up) splits dim 0 of `weight`, `weight_q`,
    `weight_scale` and `bias`, and dim 1 of `lora_b` (r, out);
  * row-parallel (o/down) splits dim 1 of `weight` / `weight_q` and dim 0
    of `lora_a` (in, r); its `weight_scale` and `bias` stay whole;
  * the embedding, its int8 codes and per-row scales and an untied LM head
    split the vocabulary (dim 0);
  * everything else is replicated: the towers, BERT, the packers and
    SegVol, as in the JAX package (`sharding.py:5-8`).

The rules apply to the LLM's subtree only (`llm.` in a VLM, the whole
model for a bare decoder). Two placements differ from the JAX rules: a
column-parallel bias is split with its outputs (the JAX rules leave it
whole and XLA slices it at use), and SegVol's own `q_proj` / `k_proj` /
`v_proj`, which the JAX regexes also match, stay replicated.

`shard_params(model, mesh)` turns a full model into this rank's
tensor-parallel shard in place: every leaf keeps its name and holds its
local slice, each attention layer holds num_heads / tp query heads and
num_kv_heads / tp key/value heads (contiguous, so GQA's grouping is kept;
where num_kv_heads does not divide by tp, all of them, the k / v
projections and the KV cache replicated as the JAX package's engine
replicates its cache), and the layers call the collectives of
`parallel/mesh.py` (Megatron's f
and g around the column- and row-parallel products, a masked vocabulary
lookup summed over tp, and the vocabulary-split logits gathered before any
argmax or sampling, so every rank picks the same token). The LLM configs
the modules hold become the local ones (heads / tp), so a `KVCache` made
from them holds this rank's heads.

`shard_params_fsdp(model, mesh)` splits, on top of that, every parameter
of at least `FSDP_MIN_SIZE` elements over dp on its largest dim still
whole (`make_fsdp_specs`). The modules see full parameters, all-gathered
with a gradient that is summed over dp and scattered back to the shards,
one unit at a time as FSDP wraps them: each decoder layer gathers its own
shards as its forward starts and lets them go as it returns; where the
backward needs one of those weights, it gathers it again (the layer's
recomputation under remat, else a saved-tensor hook that keeps the shard
in place of the full weight). The rest of the model (towers, packers,
embedding, LM head, final norm) is gathered for the whole loss and its
backward: the train step enters `fsdp_gathered(model)` around them. So the
step holds the shards, the root's full weights and one layer's. The int8
codes and their scales (buffers here, params in the JAX package) are split
and gathered as the float leaves are, without a gradient.

`full_state_dict` gathers every split leaf back to its full shape (for
checkpoints and exports); `split_leaf` cuts a full leaf to this rank's
shard (for a restore). Under a pipeline a rank holds some of the
decoder's layers: `gather_model_leaves` completes a rank's leaves to the
whole model's, and `keep_rank_leaves` picks a rank's out of the whole
model's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from hsenet_torch.parallel.mesh import (
    all_gather,
    axis_group,
    axis_rank,
    axis_size,
    gather_with_grad,
)

Spec = Tuple[Optional[str], ...]

COLUMN = r"(q_proj|k_proj|v_proj|gate_proj|up_proj)"
ROW = r"(o_proj|down_proj)"

# (regex over a state-dict name, spec): the first match wins
LLM_PARTITION_RULES: List[Tuple[str, Spec]] = [
    (rf".*{COLUMN}\.(weight|weight_q|weight_scale|bias)$", ("tp",)),
    (rf".*{ROW}\.(weight|weight_q)$", (None, "tp")),
    (rf".*{ROW}\.(weight_scale|bias)$", ()),
    (rf".*{COLUMN}\.lora_b$", (None, "tp")),
    (rf".*{ROW}\.lora_a$", ("tp",)),
    (r".*lora_[ab]$", ()),
    (r"(.*\.)?embed\.(weight|embedding_q|scale)$", ("tp",)),
    (r"(.*\.)?lm_head\.weight$", ("tp",)),
    (r".*", ()),
]

FSDP_MIN_SIZE = 1 << 14  # leaves below 16k elements stay replicated


@dataclass
class TPGroup:
    """The tensor-parallel group a sharded layer talks over."""

    group: object
    rank: int
    size: int


def partition_spec_for(name: str) -> Spec:
    for pattern, spec in LLM_PARTITION_RULES:
        if re.match(pattern, name):
            return spec
    return ()


def _llm_prefix(model: nn.Module) -> Optional[str]:
    """The state-dict prefix of the model's Phi3 decoder ("" for a bare
    `Phi3ForCausalLM`), None where it has none."""
    from hsenet_torch.models.phi3 import Phi3ForCausalLM

    for name, module in model.named_modules():
        if isinstance(module, Phi3ForCausalLM):
            return f"{name}." if name else ""
    return None


def _leaves(model: nn.Module) -> Dict[str, torch.Tensor]:
    return dict(model.state_dict(keep_vars=True))


def make_param_specs(model: nn.Module) -> Dict[str, Spec]:
    """Name -> spec over every parameter and buffer of `model`, trailing
    Nones dropped."""
    prefix = _llm_prefix(model)
    specs = {}
    for name, leaf in _leaves(model).items():
        spec: Spec = ()
        if prefix is not None and name.startswith(prefix):
            spec = partition_spec_for(name[len(prefix):])[: leaf.dim()]
        parts = list(spec)
        while parts and parts[-1] is None:
            parts.pop()
        specs[name] = tuple(parts)
    return specs


def _reference_axis_order(name: str, leaf: torch.Tensor) -> List[int]:
    """The port's dims in the order of the JAX leaf's axes: a 2-D Dense
    weight is (out, in) here and (in, out) there."""
    if leaf.dim() == 2 and name.rsplit(".", 1)[-1] in ("weight", "weight_q") \
            and "embed." not in f".{name}":
        return [1, 0]
    return list(range(leaf.dim()))


def make_fsdp_specs(model: nn.Module, mesh, *,
                    min_size: int = FSDP_MIN_SIZE) -> Dict[str, Spec]:
    """The TP specs plus "dp" on the largest dim still whole (ties go to
    the earlier axis of the JAX leaf) of every leaf of at least `min_size`
    elements whose size there divides by dp: parameters and buffers (the
    int8 codes and their scales) alike, as the JAX package splits every
    leaf of its tree. The port has no scan axis: each decoder layer is its
    own leaf."""
    dp = axis_size(mesh, "dp")
    base = make_param_specs(model)
    leaves = _leaves(model)
    specs = {}
    for name, spec in base.items():
        leaf = leaves[name]
        if dp == 1 or leaf.dim() == 0 or leaf.numel() < min_size:
            specs[name] = spec
            continue
        full = list(spec) + [None] * (leaf.dim() - len(spec))
        order = _reference_axis_order(name, leaf)
        for d in sorted(order, key=lambda i: (-leaf.shape[i], order.index(i))):
            if full[d] is None and leaf.shape[d] % dp == 0:
                full[d] = "dp"
                break
        while full and full[-1] is None:
            full.pop()
        specs[name] = tuple(full)
    return specs


def validate_divisibility(model: nn.Module, mesh) -> None:
    """Raise ValueError where a split dim does not divide by its axis, or
    the heads do not divide by tp."""
    sizes = {"dp": axis_size(mesh, "dp"), "tp": axis_size(mesh, "tp")}
    leaves = _leaves(model)
    for name, spec in make_param_specs(model).items():
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            if leaves[name].shape[dim] % sizes[axis] != 0:
                raise ValueError(
                    f"{name} dim {dim} ({leaves[name].shape[dim]}) not "
                    f"divisible by mesh axis {axis} ({sizes[axis]})")
    prefix = _llm_prefix(model)
    if prefix is not None and sizes["tp"] > 1:
        cfg = model.get_submodule(prefix.rstrip(".")).config if prefix \
            else model.config
        if cfg.num_heads % sizes["tp"]:
            raise ValueError(f"num_heads ({cfg.num_heads}) not divisible by "
                             f"mesh axis tp ({sizes['tp']})")


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, attr = name.rpartition(".")
    return (model.get_submodule(path) if path else model), attr


def _replace_leaf(model: nn.Module, name: str, value: torch.Tensor) -> None:
    module, attr = _owner(model, name)
    if attr in module._parameters:
        module._parameters[attr].data = value
    else:
        module._buffers[attr] = value


def _split(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    return t.detach().chunk(size, dim=dim)[rank].clone()


def _shard_dims(model: nn.Module) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
    """name -> (dim split over tp, dim split over dp), recorded on the
    model by `shard_params` / `shard_params_fsdp`."""
    return model.__dict__.setdefault("shard_dims", {})


def _kv_split(cfg, tp: int) -> bool:
    """The kv heads split over tp (else each rank keeps them all)."""
    return cfg.num_kv_heads % tp == 0


def _local_llm_config(cfg, tp: int):
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp if _kv_split(cfg, tp)
        else cfg.num_kv_heads,
        intermediate_size=cfg.intermediate_size // tp)


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Make `model` (full, on this rank's device) this rank's
    tensor-parallel shard, in place, and return it. Nothing changes at
    tp = 1."""
    from hsenet_torch.models.lora import LoRADense
    from hsenet_torch.models.phi3 import Phi3Block, Phi3Decoder, Phi3ForCausalLM

    model.__dict__["mesh"] = mesh
    tp = axis_size(mesh, "tp")
    if tp == 1:
        return model
    validate_divisibility(model, mesh)
    info = TPGroup(axis_group(mesh, "tp"), axis_rank(mesh, "tp"), tp)
    dims = _shard_dims(model)
    prefix = _llm_prefix(model)
    llm = model.get_submodule(prefix.rstrip(".")) if prefix else model
    full_cfg = llm.config
    # kv heads that do not split over tp stay whole on every rank (the JAX
    # package's engine replicates its cache then)
    whole = () if _kv_split(full_cfg, tp) else (".k_proj.", ".v_proj.")
    for name, spec in make_param_specs(model).items():
        if "tp" not in spec or any(w in name for w in whole):
            continue
        dim = spec.index("tp")
        _replace_leaf(model, name, _split(_leaves(model)[name], dim, info.rank, tp))
        dims[name] = (dim, None)
    local = _local_llm_config(full_cfg, tp)
    for name, module in llm.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(module, LoRADense) and not (whole and leaf in ("k_proj",
                                                                     "v_proj")):
            module.tp = info
            module.tp_mode = "row" if leaf in ("o_proj", "down_proj") else "column"
        elif isinstance(module, (Phi3Block, Phi3Decoder, Phi3ForCausalLM)):
            module.config = local
        if isinstance(module, Phi3Block) and whole:
            module.kv_select = (info.rank * local.num_heads,
                                full_cfg.num_heads // full_cfg.num_kv_heads,
                                info.group)
    llm.tp = info
    llm.full_config = full_cfg
    if llm is not model and hasattr(model, "config") and hasattr(model.config, "llm"):
        model.config = dataclasses.replace(model.config, llm=local)
    return model


def shard_params_fsdp(model: nn.Module, mesh, *,
                      min_size: int = FSDP_MIN_SIZE) -> nn.Module:
    """Tensor-parallel shards (`shard_params`), then every parameter of
    `make_fsdp_specs` split over dp, in place; each decoder layer gathers
    its own shards around its forward."""
    from hsenet_torch.models.phi3 import Phi3Block

    shard_params(model, mesh)
    dp = axis_size(mesh, "dp")
    if dp == 1:
        return model
    rank = axis_rank(mesh, "dp")
    dims = _shard_dims(model)
    leaves = _leaves(model)
    # the specs are those of the full model: a tp-split dim counts at its
    # local size, as the divisibility was checked on the full one
    split = []
    for name, spec in make_fsdp_specs(model, mesh, min_size=min_size).items():
        if "dp" not in spec:
            continue
        dim = spec.index("dp")
        _replace_leaf(model, name, _split(leaves[name], dim, rank, dp))
        dims[name] = (dims.get(name, (None, None))[0], dim)
        split.append((name, dim))
    fsdp = _FSDP(axis_group(mesh, "dp"))
    for unit, block in model.named_modules():
        if not isinstance(block, Phi3Block):
            continue
        mine = [(name, dim) for name, dim in split if name.startswith(unit + ".")]
        split = [leaf for leaf in split if leaf not in mine]
        fsdp.wrap(block, [(name[len(unit) + 1:], dim) for name, dim in mine])
    fsdp.root = split
    model.__dict__["fsdp"] = fsdp
    return model


class _FSDP:
    """The dp group, the root's split leaves [(name, dim)], and the storages
    of the layer weights gathered at this moment (data pointer -> (shard,
    dim)), which the saved-tensor hook packs as their shards."""

    def __init__(self, group):
        self.group = group
        self.root: List[Tuple[str, int]] = []
        self.live: Dict[int, Tuple[torch.Tensor, int]] = {}

    def wrap(self, block: nn.Module, leaves) -> None:
        forward = block.forward

        def gathered_forward(*args, **kwargs):
            with _gathered(block, leaves, self.group, self.live):
                return forward(*args, **kwargs)

        block.forward = gathered_forward

    def pack(self, t: torch.Tensor):
        src = self.live.get(t.untyped_storage().data_ptr()) if self.live else None
        if src is None:
            return t
        return src + (t.shape, t.stride(), t.storage_offset())

    def unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        shard, dim, shape, stride, offset = packed
        return all_gather(shard, self.group, dim).as_strided(shape, stride, offset)


@contextlib.contextmanager
def _gathered(module: nn.Module, leaves, group, live=None) -> Iterator[None]:
    """Inside, each of `module`'s split leaves [(name, dim)] reads as its
    full tensor (gathered with a gradient where the shard trains; a buffer,
    such as the int8 codes, without); `live` records the full tensors'
    storages meanwhile."""
    swapped = []
    try:
        for name, dim in leaves:
            owner, attr = _owner(module, name)
            slots = owner._parameters if attr in owner._parameters \
                else owner._buffers
            shard = slots[attr]
            full = gather_with_grad(shard, group, dim) if shard.requires_grad \
                else all_gather(shard, group, dim)
            slots[attr] = full
            ptr = full.untyped_storage().data_ptr()
            swapped.append((slots, attr, shard, ptr))
            if live is not None:
                live[ptr] = (shard, dim)
        yield
    finally:
        for slots, attr, shard, ptr in swapped:
            slots[attr] = shard
            if live is not None:
                live.pop(ptr, None)


@contextlib.contextmanager
def fsdp_gathered(model: nn.Module) -> Iterator[None]:
    """Inside, the root's dp-split parameters read as their full tensors,
    and the decoder layers' full weights that the backward needs are kept as
    their shards and gathered again there. A model without FSDP shards is
    left as it is."""
    fsdp = model.__dict__.get("fsdp")
    if fsdp is None:
        yield
        return
    with _gathered(model, fsdp.root, fsdp.group), \
            torch.autograd.graph.saved_tensors_hooks(fsdp.pack, fsdp.unpack):
        yield


def gather_leaf(model: nn.Module, name: str, t: torch.Tensor,
                extra: Optional[Tuple[int, object]] = None) -> torch.Tensor:
    """`t`, a leaf of `name`'s sharding (or of one of its optimizer
    moments), gathered to its full shape; `extra` = (dim, group) first
    undoes one more split (ZeRO-1's)."""
    if extra is not None:
        t = all_gather(t, extra[1], extra[0])
    tp_dim, dp_dim = _shard_dims(model).get(name, (None, None))
    mesh = model.__dict__.get("mesh")
    if dp_dim is not None:
        t = all_gather(t, axis_group(mesh, "dp"), dp_dim)
    if tp_dim is not None:
        t = all_gather(t, axis_group(mesh, "tp"), tp_dim)
    return t


def split_leaf(model: nn.Module, name: str, full: torch.Tensor) -> torch.Tensor:
    """The inverse of `gather_leaf` without `extra`: this rank's slice of a
    full leaf."""
    tp_dim, dp_dim = _shard_dims(model).get(name, (None, None))
    mesh = model.__dict__.get("mesh")
    if tp_dim is not None:
        full = _split(full, tp_dim, axis_rank(mesh, "tp"), axis_size(mesh, "tp"))
    if dp_dim is not None:
        full = _split(full, dp_dim, axis_rank(mesh, "dp"), axis_size(mesh, "dp"))
    return full


def is_sharded(model: nn.Module) -> bool:
    return bool(_shard_dims(model))


def gather_model_leaves(model: nn.Module, leaves: Dict[str, object]
                        ) -> Dict[str, object]:
    """`leaves` (name -> a whole leaf, or a tuple of tensors such as a leaf
    with its optimizer moments) of this rank's part of the model, completed
    to the whole model's in its order: under a pipeline every stage's layer
    leaves, the other stages' as host copies (a collective: every rank
    calls it). Itself otherwise."""
    from hsenet_torch.parallel.pipeline import gather_stages

    return gather_stages(model, leaves)


def keep_rank_leaves(model: nn.Module, leaves: Dict[str, object]
                     ) -> Dict[str, object]:
    """The inverse of `gather_model_leaves`: of the whole model's `leaves`,
    those this rank's part of the model holds."""
    from hsenet_torch.parallel.pipeline import own_stage

    return own_stage(model, leaves)


def full_state_dict(model: nn.Module, keep=None) -> Dict[str, torch.Tensor]:
    """The model's state dict with every split leaf gathered, and under a
    pipeline every stage's layers, in the full model's order (a collective:
    every rank calls it); `keep(name)` picks the leaves (all by default).
    An unsharded model's own state dict."""
    state = {k: v for k, v in model.state_dict().items()
             if keep is None or keep(k)}
    if is_sharded(model):
        state = {name: gather_leaf(model, name, t) for name, t in state.items()}
    return gather_model_leaves(model, state)

