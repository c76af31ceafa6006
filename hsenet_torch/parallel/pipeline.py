"""GPipe pipeline parallelism over a "pp" mesh axis (the port of the JAX
package's parallel/pipeline.py).

The LLM decoder's layers split into pp stages: stage s holds layers
[s L / pp, (s + 1) L / pp) (`shard_params_pp`); the other layers' modules
are dropped from the rank, so its optimizer holds only what it keeps.
Everything else (towers, packers, token table, final norm, LM head) is
replicated and runs on every stage alike.

Schedule (`_Schedule`): the batch splits into n_micro microbatches of
consecutive rows, and the pipeline runs n_micro + pp - 1 ticks. At tick t
stage s runs microbatch t - s through its layers (with that microbatch's
own kv_lens) and sends the result to stage s + 1; stage 0 takes the
embedded microbatch, the last stage keeps what it computes. On a bubble
tick (t - s outside [0, n_micro)) a stage computes nothing, where the JAX
package computes and discards. The last stage's hidden states then reach
every stage (`broadcast_from`), and each stage computes the final norm, the
LM head and `masked_lm_loss` over the whole batch, alike.

Backward (`_GPipe`): the last stage takes its own cotangent of the hidden
states (every stage computed the same loss, so it counts once) and the
microbatches run back in reverse order, each stage sending the gradient of
its input to the stage before. Each stage's forward keeps, per microbatch,
each layer's input only, and the backward recomputes the layer (under the
decoder's `remat_policy`), as the JAX package rematerialises every layer
of its pipeline. The gradient of the embedded batch arises on stage 0 and
is summed over pp, so the towers, packers and token table get their whole
gradient on every stage, and the replicated leaves stay equal across
stages.

Composition: pp composes with dp (a ("dp", "pp") mesh: each dp replica
runs its own pipeline on its rows). Dropout inside the pipeline (LoRA's) is
off, as in the JAX package.

Checkpoints hold the full model: `gather_stages` collects every stage's
layer leaves in the full model's order, and `own_stage` keeps the leaves
of the rank's own layers of a full set (the checkpoint reaches both
through `parallel/sharding.py`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from hsenet_torch.models.layers import checkpointed, dropout_rng
from hsenet_torch.parallel.mesh import (
    all_reduce,
    axis_group,
    axis_rank,
    axis_size,
    broadcast,
    broadcast_from,
    recv,
    send,
)
from hsenet_torch.train.vlm import lm_loss_terms, make_masked_train_step

Batch = Dict[str, torch.Tensor]


def stage_layers(num_layers: int, pp: int, stage: int) -> range:
    """The decoder layers stage `stage` of `pp` holds."""
    per = num_layers // pp
    return range(stage * per, (stage + 1) * per)


@dataclass
class PipelineStage:
    """This rank's stage: the pp `group`, its `rank` and `size` there, the
    decoder's state-dict prefix ("llm.decoder." in a VLM) and the layers it
    holds."""

    group: object
    rank: int
    size: int
    prefix: str
    layers: range

    def holds(self, name: str) -> bool:
        """Whether `name` is a leaf of this stage's own layers."""
        head = self.prefix + "layers."
        return name.startswith(head) and _layer_index(name, head) in self.layers

    def other(self, name: str) -> bool:
        """Whether `name` is a leaf of another stage's layers."""
        return name.startswith(self.prefix + "layers.") and not self.holds(name)

    @property
    def first(self) -> bool:
        return self.rank == 0

    @property
    def last(self) -> bool:
        return self.rank == self.size - 1


class OtherStage(nn.Module):
    """The place of a decoder layer another pipeline stage holds."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"decoder layer {self.index} is held by another "
                           "pipeline stage")


def _decoder(model: nn.Module):
    """(state-dict prefix of the LLM's decoder layers, the `Phi3Decoder`)."""
    from hsenet_torch.models.phi3 import Phi3Decoder

    for name, module in model.named_modules():
        if isinstance(module, Phi3Decoder):
            return (f"{name}." if name else ""), module
    raise ValueError("the model has no Phi-3 decoder to pipeline")


def _layer_index(name: str, head: str) -> int:
    return int(name[len(head):].split(".", 1)[0])


def make_pp_specs(model: nn.Module) -> Dict[str, tuple]:
    """Name -> spec of the pipeline placement: ("pp",) for the leaves of
    the LLM decoder's layers (split by layer over the stages), () for the
    rest, the towers' own layers included (they run outside the
    pipeline)."""
    head = _decoder(model)[0] + "layers."
    return {name: ("pp",) if name.startswith(head) else ()
            for name in model.state_dict(keep_vars=True)}


def shard_params_pp(model: nn.Module, mesh) -> nn.Module:
    """Make `model` (full, on this rank's device) this rank's pipeline
    stage, in place, by `make_pp_specs`: the decoder layers whose leaves
    are split over pp and that other stages hold are dropped. The number
    of layers must divide by pp (ValueError, the JAX CLI's message)."""
    pp = axis_size(mesh, "pp")
    prefix, decoder = _decoder(model)
    n = len(decoder.layers)
    if n % pp:
        raise ValueError(f"--pp {pp} must divide num_layers {n}")
    rank = axis_rank(mesh, "pp")
    stage = PipelineStage(axis_group(mesh, "pp"), rank, pp, prefix,
                          stage_layers(n, pp, rank))
    head = prefix + "layers."
    split = {_layer_index(name, head)
             for name, spec in make_pp_specs(model).items() if "pp" in spec}
    for i in sorted(split - set(stage.layers)):
        decoder.layers[i] = OtherStage(i)
    model.__dict__["mesh"] = mesh
    model.__dict__["pipeline"] = stage
    decoder.pipeline = stage
    return model


def pipeline_stage(model: nn.Module) -> Optional[PipelineStage]:
    return model.__dict__.get("pipeline")


class _Schedule:
    """One GPipe run of a stage: its layers, the microbatches' rope tables
    and kv_lens."""

    def __init__(self, decoder, stage: PipelineStage, n_micro: int, cos, sin,
                 kv_lens):
        self.decoder, self.stage, self.n = decoder, stage, n_micro
        self.cos, self.sin = cos, sin
        self.lens = kv_lens.chunk(n_micro)

    def run_stack(self, x, lens):
        policy = self.decoder.config.remat_policy
        for i in self.stage.layers:
            layer = self.decoder.layers[i]
            if torch.is_grad_enabled():  # every layer recomputed, whatever --remat
                x = checkpointed(layer, x, self.cos, self.sin, lens,
                                 deterministic=True, policy=policy)
            else:
                x = layer(x, self.cos, self.sin, lens, deterministic=True)
        return x

    def forward(self, xs: List[torch.Tensor], graph: bool):
        """The ticks of this stage: its outputs (the last stage's, the
        microbatches concatenated; None on the others) and, with `graph`,
        each microbatch's (input, output) with the layers' graph between."""
        st, n = self.stage, self.n
        saved, outs = [], []
        for t in range(n + st.size - 1):
            m = t - st.rank  # the microbatch this stage runs at tick t
            if not 0 <= m < n:
                continue  # a bubble tick
            x = xs[m] if st.first else recv(xs[m], st.group, st.rank - 1, tag=m)
            if graph:
                with torch.enable_grad():
                    x = x.detach().requires_grad_(not st.first
                                                  or xs[m].requires_grad)
                    y = self.run_stack(x, self.lens[m])
                saved.append((x, y))
            else:
                y = self.run_stack(x, self.lens[m])
            if st.last:
                outs.append(y.detach())
            else:
                send(y, st.group, st.rank + 1, tag=m)
        return (torch.cat(outs) if st.last else None), saved

    def backward(self, saved, grad_out, params):
        """The microbatches back in reverse order: (gradient of the
        embedded batch, summed over pp; the params' gradients)."""
        st, n = self.stage, self.n
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        g_out = grad_out.chunk(n) if st.last else None
        g_in: List[Optional[torch.Tensor]] = [None] * n
        for m in reversed(range(n)):
            x, y = saved[m]
            saved[m] = None
            g_y = g_out[m] if st.last else recv(y, st.group, st.rank + 1, tag=n + m)
            inputs = ([x] if x.requires_grad else []) + list(params)
            got = torch.autograd.grad(y, inputs, g_y, allow_unused=True)
            if x.requires_grad:
                gx, got = got[0], got[1:]
                gx = torch.zeros_like(x) if gx is None else gx
                if st.first:
                    g_in[m] = gx
                else:
                    send(gx, st.group, st.rank - 1, tag=n + m)
            for i, g in enumerate(got):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
        return g_in, grads


class _GPipe(torch.autograd.Function):
    """The stage's part of the pipeline as one autograd node: the last
    stage returns the hidden states (zeros elsewhere); the backward runs
    the schedule back."""

    @staticmethod
    def forward(ctx, embeds, schedule, *params):
        xs = list(embeds.chunk(schedule.n))
        if embeds.requires_grad:  # stage 0's inputs need their gradient
            xs = [x.detach().requires_grad_() for x in xs]
        out, saved = schedule.forward(xs, graph=True)
        ctx.schedule, ctx.saved, ctx.params = schedule, saved, params
        ctx.embeds_grad = embeds.requires_grad
        return out if out is not None else torch.zeros_like(embeds)

    @staticmethod
    def backward(ctx, grad):
        schedule = ctx.schedule
        g_in, grads = schedule.backward(ctx.saved, grad, ctx.params)
        g_embeds = None
        if ctx.embeds_grad:
            st = schedule.stage
            # stage 0 holds the embedded batch's gradient; every stage
            # takes it (a sum over pp with zeros elsewhere)
            local = (torch.cat(g_in) if st.first
                     else torch.zeros_like(grad))
            g_embeds = all_reduce(local, st.group)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ctx.params, grads)]
        return (g_embeds, None, *grads)


def _rope(decoder, s: int, device):
    from hsenet_torch.models.phi3 import _longrope_params, _rope_cos_sin

    cfg = decoder.config
    ext, scaling = _longrope_params(cfg, s)
    return _rope_cos_sin(torch.arange(s, device=device)[None, :], cfg.rotary_dim,
                         cfg.rope_theta, ext_factors=ext,
                         attention_scaling=scaling)


def pp_hidden(model: nn.Module, decoder, embeds: torch.Tensor,
              kv_lens: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, S, D) hidden states of the decoder's layers pipelined over the
    stages (before the final norm), on every stage. B must split into
    n_micro microbatches."""
    stage = pipeline_stage(model)
    b, s, _ = embeds.shape
    if b % n_micro:
        dp = axis_size(model.__dict__.get("mesh"), "dp")
        raise ValueError(f"batch {b * dp} must split into n_micro={n_micro} "
                         f"x dp={dp} microbatches")
    x = embeds.to(decoder.dtype)
    cos, sin = _rope(decoder, s, x.device)
    kv_lens = kv_lens.to(device=x.device, dtype=torch.int32)
    schedule = _Schedule(decoder, stage, n_micro, cos, sin, kv_lens)
    params = [p for i in stage.layers for p in decoder.layers[i].parameters()
              if p.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or params):
        local = _GPipe.apply(x, schedule, *params)
        return broadcast_from(local, stage.group, stage.size - 1)
    out, _ = schedule.forward(list(x.chunk(n_micro)), graph=False)
    return broadcast(out if out is not None else torch.zeros_like(x),
                     stage.group, stage.size - 1)


def make_pp_causal_lm_forward(model: nn.Module, mesh, n_micro: int):
    """forward(input_ids, kv_lens) -> (B, S, V) logits of a pipelined
    `Phi3ForCausalLM`: the embedding lookup, the final norm and the LM head
    run on every stage."""
    if pipeline_stage(model) is None:
        raise ValueError("place the model with shard_params_pp first")

    def forward(input_ids, kv_lens):
        embeds = model.embed_tokens(input_ids)
        hidden = pp_hidden(model, model.decoder, embeds, kv_lens, n_micro)
        return model.compute_logits(model.decoder.norm(hidden))

    return forward


def make_pp_causal_lm_train_step(model: nn.Module, tx, mesh, n_micro: int):
    """The pipelined causal-LM train step (input_ids / labels /
    attention_mask; `make_masked_train_step`'s contract). The loss is the
    masked LM loss of the whole batch."""
    forward = make_pp_causal_lm_forward(model, mesh, n_micro)

    def loss_fn(batch: Batch, generator=None):
        kv_lens = batch["attention_mask"].sum(dim=-1).to(torch.int32)
        return lm_loss_terms(model, forward(batch["input_ids"], kv_lens),
                         batch["labels"])

    return make_masked_train_step(loss_fn, tx)


def pp_vlm_loss_fn(model: nn.Module, batch: Batch,
                   generator: Optional[torch.Generator] = None, *,
                   n_micro: int):
    """The VLM's LM loss with its decoder pipelined: towers, packers and
    splice on every stage (their dropout drawing from `generator`, alike on
    every stage), LoRA dropout off inside the pipeline."""
    kv_lens = batch["attention_mask"].sum(dim=-1).to(torch.int32)
    with dropout_rng(generator):
        embeds = model.multimodal_embeds(
            batch["input_ids"], batch.get("image"), batch.get("image_2d"),
            deterministic=generator is None)
    decoder = model.llm.decoder
    hidden = pp_hidden(model, decoder, embeds, kv_lens, n_micro)
    logits = model.llm.compute_logits(decoder.norm(hidden))
    return lm_loss_terms(model, logits, batch["labels"])


def make_pp_vlm_train_step(model: nn.Module, tx, mesh, n_micro: int):
    """The pipelined VLM finetune step (`train.vlm.make_vlm_train_step`'s
    batch contract): towers, packers and splice outside the pipeline, the
    decoder's layers GPipe'd over pp. The model must be placed with
    `shard_params_pp`."""
    if pipeline_stage(model) is None:
        raise ValueError("place the model with shard_params_pp first")
    return make_masked_train_step(
        functools.partial(pp_vlm_loss_fn, model, n_micro=n_micro), tx)


def _order(model: nn.Module, names: Sequence[str], layers: Sequence[str]):
    """`names` (this stage's, in its order) with `layers` (every stage's
    layer leaves, in stage order) in place of its own: the full model's
    order."""
    stage = pipeline_stage(model)
    own = [n for n in names if stage.holds(n)]
    if not own:
        # where this stage has none, the layers go where the decoder's do
        prefix = stage.prefix + "layers."
        params = [n for n, _ in model.named_parameters()]
        first = next(i for i, n in enumerate(params) if n.startswith(prefix))
        before = set(params[:first])
        pre = [n for n in names if n in before]
        return pre + list(layers) + [n for n in names if n not in before]
    start, stop = names.index(own[0]), names.index(own[-1]) + 1
    return list(names[:start]) + list(layers) + list(names[stop:])


def own_stage(model: nn.Module, leaves: Dict[str, object]) -> Dict[str, object]:
    """The inverse of `gather_stages`: of the full model's `leaves`, those
    of this stage (the other stages' layers dropped). Itself without a
    pipeline."""
    stage = pipeline_stage(model)
    if stage is None:
        return dict(leaves)
    return {k: v for k, v in leaves.items() if not stage.other(k)}


def gather_stages(model: nn.Module, tensors: Dict[str, object]
                  ) -> Dict[str, object]:
    """`tensors` (name -> a tensor or a tuple of tensors, this stage's
    leaves) with every stage's layer leaves, on every stage, in the full
    model's order (host copies of the other stages'). Itself without a
    pipeline."""
    stage = pipeline_stage(model)
    if stage is None:
        return dict(tensors)

    def host(v):
        return tuple(t.detach().cpu() for t in v) if isinstance(v, tuple) \
            else v.detach().cpu()

    mine = {k: host(v) for k, v in tensors.items() if stage.holds(k)}
    every = [None] * stage.size
    dist.all_gather_object(every, mine, group=stage.group)
    layers = {k: v for part in every for k, v in part.items()}
    for k in mine:  # this stage's own stay where they are
        layers[k] = tensors[k]
    names = list(tensors)
    order = _order(model, names, list(layers))
    return {k: tensors[k] if k in tensors else layers[k] for k in order}
