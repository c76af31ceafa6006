"""VLM finetune train step (the port of the JAX package's train/vlm.py).

Freezing follows the reference's train_VLM.py: the LLM base is frozen; the
LoRA adapters, both packers, the (tied) token embedding and the SegVol
branch train; the vision towers stay frozen. Here freezing is `requires_grad=False`, and the
trainable leaves are held as f32 masters (`to_training_dtypes`) while the
modules compute in bf16, casting them at use as the JAX modules cast their
f32 params. Frozen leaves may stay in bf16: the JAX package casts them to
bf16 at every use, which gives the same values.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hsenet_torch.models.layers import dropout_rng
from hsenet_torch.train.losses import masked_lm_loss, masked_lm_loss_global
from hsenet_torch.parallel.mesh import axis_group, axis_rank, axis_size
from hsenet_torch.parallel.sharding import fsdp_gathered
from hsenet_torch.train.train_state import (
    AdamW,
    TrainState,
    global_norm,
    reduce_gradients,
    sum_over_sp,
)
from hsenet_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]


def vlm_trainable_mask(model: nn.Module, *,
                       train_seg: bool = True) -> Dict[str, bool]:
    """Parameter name -> trainable: the JAX package's default policy over
    the port's parameter names. LoRA adapters, both packers, the tied token
    embedding and (with `train_seg`) the SegVol branch (`seg_module`,
    `seg_projector`) train; the towers, the 2D slice trunk and the LLM base
    stay frozen."""

    def decide(name: str) -> bool:
        if "lora_a" in name or "lora_b" in name or "mm_projector" in name:
            return True
        if "seg_projector" in name or "seg_module" in name:
            return train_seg
        if "vision_tower" in name or "slice_encoder" in name:
            return False
        return name == "llm.embed.weight"

    return {name: decide(name) for name, _ in model.named_parameters()}


@torch.no_grad()
def to_training_dtypes(model: nn.Module, trainable_mask: Mapping[str, bool]):
    """Hold the trainable leaves as f32 masters and mark the others frozen
    (requires_grad=False); the modules keep computing in their dtype."""
    for name, p in model.named_parameters():
        trainable = bool(trainable_mask[name])
        if trainable and p.dtype != torch.float32:
            p.data = p.data.float()
        p.requires_grad_(trainable)
    return model


def vlm_loss_fn(model: nn.Module, batch: Batch,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """LM loss of one batch; dropout on (drawing from `generator`) unless
    `generator` is None."""
    kv_lens = batch["attention_mask"].sum(dim=-1).to(torch.int32)
    with dropout_rng(generator):
        logits = model(
            batch["input_ids"], batch.get("image"), batch.get("image_2d"),
            kv_lens=kv_lens, deterministic=generator is None,
        )
    return lm_loss_terms(model, logits, batch["labels"])


def lm_loss_terms(model: nn.Module, logits: torch.Tensor, labels: torch.Tensor):
    """(loss to differentiate, {"loss", "token_acc"}) of the masked LM loss,
    the token mean over the global batch where the model has a dp axis."""
    dp_group = _dp_group(model)
    if dp_group is not None:
        grad_loss, loss, acc = masked_lm_loss_global(logits, labels, *dp_group)
        return grad_loss, {"loss": loss, "token_acc": acc}
    loss, acc = masked_lm_loss(logits, labels)
    return loss, {"loss": loss, "token_acc": acc}


def _dp_group(model: nn.Module):
    """(group, size) of the model's data-parallel axis where it has one of
    more than one rank (`parallel.sharding.shard_params` records the
    mesh), else None."""
    mesh = model.__dict__.get("mesh")
    dp = axis_size(mesh, "dp")
    return None if dp == 1 else (axis_group(mesh, "dp"), dp)


def vlm_seg_loss_fn(model: nn.Module, batch: Batch,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """LM loss plus dice + BCE on SegVol's logits for the rows whose mask
    is not empty (lamed_phi3.py:87-135; the other rows add 0), averaged over
    those rows. Dropout as in `vlm_loss_fn`."""
    from hsenet_torch.models.segvol import binary_dice_loss, masked_bce_loss

    kv_lens = batch["attention_mask"].sum(dim=-1).to(torch.int32)
    with dropout_rng(generator):
        logits, seg_logits = model.forward_with_seg(
            batch["input_ids"], batch["image"], batch.get("image_2d"),
            kv_lens=kv_lens, deterministic=generator is None,
        )
    segs = batch["seg"]  # (B, 1, D, H, W), zeros where a row has none
    has_seg = (segs.sum(dim=(1, 2, 3, 4)) > 0).float()
    per_row = torch.stack([
        binary_dice_loss(seg_logits[i:i + 1], segs[i:i + 1])
        + masked_bce_loss(seg_logits[i:i + 1], segs[i:i + 1])
        for i in range(segs.shape[0])])
    seg_sum = (per_row * has_seg).sum()
    dp_group = _dp_group(model)
    if dp_group is not None:  # both means run over the global batch
        from hsenet_torch.parallel.mesh import all_reduce

        grad_lm, lm_loss, acc = masked_lm_loss_global(
            logits, batch["labels"], *dp_group)
        totals = all_reduce(torch.stack([seg_sum.detach(), has_seg.sum()]),
                            dp_group[0])
        rows = totals[1].clamp_min(1.0)
        seg_loss = totals[0] / rows
        loss = lm_loss + seg_loss
        return grad_lm + seg_sum * dp_group[1] / rows, {
            "loss": loss, "lm_loss": lm_loss, "seg_loss": seg_loss,
            "token_acc": acc}
    lm_loss, acc = masked_lm_loss(logits, batch["labels"])
    seg_loss = seg_sum / has_seg.sum().clamp_min(1.0)
    loss = lm_loss + seg_loss
    return loss, {"loss": loss, "lm_loss": lm_loss, "seg_loss": seg_loss,
                  "token_acc": acc}


def make_vlm_eval_fn(model: nn.Module, seg: bool = False,
                     loss_fn: Optional[Callable] = None):
    """Held-out eval: `evaluate(loader) -> {"val_loss", "val_token_acc"}`
    (with `seg`, through `vlm_seg_loss_fn`, also "val_lm_loss" and
    "val_seg_loss"), means over the loader's batches, deterministic (no
    dropout). `loss_fn(model, batch)` replaces the plain loss (the
    pipeline's, whose stages hold a part of the decoder each)."""
    if loss_fn is None:
        loss_fn = vlm_seg_loss_fn if seg else vlm_loss_fn
    keys = ("input_ids", "labels", "attention_mask", "image", "image_2d") + (
        ("seg",) if seg else ())
    device = next(model.parameters()).device

    @torch.no_grad()
    def evaluate(loader):
        rows = []
        for batch in loader:
            dev = {k: torch.as_tensor(v).to(device) for k, v in batch.items()
                   if k in keys}
            with fsdp_gathered(model):
                _, metrics = loss_fn(model, dev)
            rows.append({k: float(v) for k, v in metrics.items()})
        if not rows:
            return {}
        return {f"val_{k}": float(np.mean([r[k] for r in rows]))
                for k in rows[0]}

    return evaluate


def fold_seed(seed: int, *data: int) -> int:
    """A 63-bit seed that depends on `seed` and each of `data` in order
    (the port's fold_in: per-step and per-microbatch dropout streams)."""
    for x in data:
        seed = (seed * 0x9E3779B97F4A7C15 + int(x) + 1) % (1 << 63)
    return seed


def make_masked_train_step(loss_fn: Callable, tx: AdamW, *, grad_accum: int = 1,
                           takes_step: bool = False,
                           sp_region: Tuple[str, ...] = ()):
    """`train_step(state, batch, rng=None) -> (state, metrics)`: the
    gradient of `loss_fn(batch, generator) -> (loss, metrics)` over the
    state's trainable leaves, one AdamW update, and the global norm of those
    gradients as `metrics["grad_norm"]`. With `takes_step` the loss is
    called as `loss_fn(batch, step, generator)`, the state's step count
    before the update (stage 2's relation weight reads it).

    `rng` is an int seed; the step's dropout generator is seeded from it and
    the step count (each microbatch's also from its index), on the device of
    the parameters; with `rng=None` the step is deterministic. `grad_accum
    > 1` splits the batch into that many equal microbatches along dim 0 and
    averages their gradients and metrics (the reference's
    gradient_accumulation_steps; only sound for losses that decompose per
    sample).

    With `state.mesh` the batch is this dp rank's rows, each microbatch
    the rank's share of the global microbatch; the loss function reduces
    its metrics over dp, the gradients are averaged over dp and their norm
    taken over every shard. An FSDP model (`parallel/sharding.py`) is
    gathered around the loss. Over an sp mesh (`parallel/sp.py`) the
    leaves whose names start with one of `sp_region` ran inside the ring on
    this rank's tokens: their gradients are summed over sp."""

    def grads_of(params, batch, generator, step, model):
        with fsdp_gathered(model):
            with span("train.forward"):
                loss, metrics = (loss_fn(batch, step, generator) if takes_step
                                 else loss_fn(batch, generator))
            with span("train.backward"):
                grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: Batch, rng: Optional[int] = None):
        with span("train.step"):
            return _train_step(state, batch, rng)

    def _train_step(state: TrainState, batch: Batch, rng: Optional[int]):
        params = list(state.params.values())
        names = list(state.params)
        model = state.model if state.model is not None else nn.Module()
        # dp ranks draw their own rows' dropout; tp ranks of one replica
        # draw the same masks (the replicated activations stay equal)
        dp = axis_size(state.mesh, "dp")
        rank = (axis_rank(state.mesh, "dp"),) if dp > 1 else ()

        def generator(*stream):
            if rng is None:
                return None
            return torch.Generator(device=params[0].device).manual_seed(
                fold_seed(rng, state.step, *stream, *rank)
            )

        if grad_accum > 1:
            n = next(iter(batch.values())).shape[0] // grad_accum
            grads, rows = None, []
            for i in range(grad_accum):
                micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                g, m = grads_of(params, micro, generator(i), state.step, model)
                grads = g if grads is None else [a.add_(b) for a, b in zip(grads, g)]
                rows.append(m)
            grads = [g.div_(grad_accum) for g in grads]
            metrics = {k: torch.stack([m[k].float() for m in rows]).mean()
                       for k in rows[0]}
        else:
            grads, metrics = grads_of(params, batch, generator(), state.step,
                                      model)
        if state.mesh is not None:
            grads = reduce_gradients(grads, names, model, state.mesh)
            if sp_region:
                grads = sum_over_sp(grads, names, sp_region, state.mesh)
        with span("train.optimizer"):
            metrics["grad_norm"] = global_norm(grads, names, model)
            opt_state = tx.step(params, grads, state.opt_state,
                                metrics["grad_norm"])
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt_state), metrics

    return train_step


def make_vlm_train_step(model: nn.Module, tx: AdamW, grad_accum: int = 1,
                        seg: bool = False):
    """The plain VLM finetune step (see `make_masked_train_step`), with
    `seg` over `vlm_seg_loss_fn`; the trainable leaves are those of the
    state, which `tx`'s mask picked."""
    loss_fn = vlm_seg_loss_fn if seg else vlm_loss_fn
    return make_masked_train_step(
        functools.partial(loss_fn, model), tx, grad_accum=grad_accum
    )
