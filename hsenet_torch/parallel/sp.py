"""Sequence parallelism over an "sp" mesh axis (the port of the JAX
package's parallel/sp.py).

The token axis splits over the sp ranks of a ("dp", "sp") mesh: each rank
keeps one contiguous chunk of the tokens and attention is the exact ring
(`ops/ring_attention.py`). LayerNorm, the MLP and the projections are per
token, so everything but attention stays local. The ranks of one sp group
read the same rows of the batch (the loader splits over dp only).

  * The 3D ViT (`sp_encode_tokens`): each rank embeds the whole volume
    (the patch embedding and the 2E3 scoring are a few percent of the
    tower), keeps its chunk of [CLS | tokens] padded to a multiple of sp,
    runs the tower over the ring, and the chunks are gathered back with
    the padding stripped. Each rank's gradients of the ViT's parameters
    cover its own chunk: the train steps sum them over sp (`sp_region`).
    The CLIP stages' text towers, projections and losses run outside the
    ring on every rank alike.
  * The LLM decoder (`make_sp_decoder_hidden_fn`): the towers, packers and
    the splice run outside the ring on every rank alike; the embedding
    sequence is padded, each rank keeps its chunk (`local_chunk`, whose
    gradient gathers every rank's chunk back, so what came before gets its
    whole gradient on every rank), the decoder layers and the final norm
    run over the causal ring with the rows' global kv_lens, and the hidden
    states are gathered back. The decoder's gradients are summed over sp.

Dropout inside the ring draws per-chunk masks: the ViT's generator is
seeded from the step's seed and the sp rank (`fold_seed`), as the JAX
package folds the sp index into its key. So a run with dropout is not bit
for bit the one-rank run; the parity tests pin the rates to 0, as the JAX
package's do. LoRA dropout inside the decoder ring is off, as in the JAX
package (and its pipeline).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from hsenet_torch.models.layers import dropout_rng
from hsenet_torch.parallel.mesh import (
    axis_group,
    axis_rank,
    axis_size,
    gather_from_group,
)
from hsenet_torch.train.vlm import fold_seed, lm_loss_terms, make_masked_train_step

Batch = Dict[str, torch.Tensor]


def _sp_group(mesh):
    if mesh is None or "sp" not in mesh.mesh_dim_names:
        raise ValueError("the mesh has no 'sp' axis")
    return axis_group(mesh, "sp")


def vit3d_token_count(cfg, volume_shape) -> int:
    """The tower's sequence length for a (..., D, H, W) volume: patches
    (and CLS)."""
    d, h, w = volume_shape[-3:]
    p0, p1, p2 = cfg.patch_size
    if d % p0 or h % p1 or w % p2:
        raise ValueError(f"volume {tuple(volume_shape)} does not split into "
                         f"{tuple(cfg.patch_size)} patches")
    return (d // p0) * (h // p1) * (w // p2) + (1 if cfg.classification else 0)


def chunk_generator(generator: Optional[torch.Generator], mesh):
    """A generator of this sp rank's own, seeded from `generator`'s seed
    and the rank (None stays None): the per-chunk dropout masks."""
    if generator is None:
        return None
    return torch.Generator(device=generator.device).manual_seed(
        fold_seed(generator.initial_seed(), axis_rank(mesh, "sp")))


def sp_encode_tokens(vit: nn.Module, mesh, volume: torch.Tensor,
                     slice_features: Optional[torch.Tensor] = None, *,
                     generator: Optional[torch.Generator] = None,
                     block_q: Optional[int] = None) -> torch.Tensor:
    """The `ViT3D`'s (B, S, D) tokens with the tower sequence parallel over
    the mesh's sp axis, on every rank of the group. `generator` turns the
    tower's dropout on, with this chunk's own masks; `block_q` streams the
    ring's query blocks."""
    group = _sp_group(mesh)
    s_true = vit3d_token_count(vit.config, volume.shape)
    with dropout_rng(chunk_generator(generator, mesh)):
        chunk = vit(volume, slice_features, deterministic=generator is None,
                    sp_group=group, sp_block_q=block_q)
    return gather_from_group(chunk, group, dim=1)[:, :s_true]


def make_sp_encode_fn(vit: nn.Module, mesh, block_q: Optional[int] = None):
    """encode(volume, slice_features=None) -> (B, S, D): the ViT over the
    ring, deterministic."""
    return functools.partial(sp_encode_tokens, vit, mesh, block_q=block_q)


def make_sp_decoder_hidden_fn(mesh, *, block_q: Optional[int] = None):
    """hidden_fn(decoder, inputs_embeds, kv_lens) -> (B, S, D) hidden
    states after the final norm, with the token axis split over sp and the
    causal attention a ring. kv_lens are the rows' global lengths; the
    ring's tail padding is stripped before returning. Dropout inside runs
    off."""
    from hsenet_torch.ops.ring_attention import RingArgs, local_chunk, pad_to_multiple

    group = _sp_group(mesh)
    sp = axis_size(mesh, "sp")

    def hidden_fn(decoder, embeds, kv_lens):
        s = embeds.shape[1]
        chunk = local_chunk(pad_to_multiple(embeds, sp, dim=1), group, dim=1)
        # sp_global_len is the true length: the LongRoPE short/long choice
        # must be the dense path's; the padding's rope values are never
        # read (masked as keys, dropped as queries)
        hidden, _ = decoder(chunk, kv_lens=kv_lens, deterministic=True,
                            sp=RingArgs(group, block_q=block_q),
                            sp_global_len=s)
        return gather_from_group(hidden, group, dim=1)[:, :s]

    return hidden_fn


def make_sp_causal_lm_train_step(model: nn.Module, tx, mesh, *,
                                 block_q: Optional[int] = None):
    """The causal-LM train step (input_ids / labels / attention_mask) of a
    `Phi3ForCausalLM` with the decoder sequence parallel: the embedding
    lookup and the LM head run outside the ring."""
    hidden_fn = make_sp_decoder_hidden_fn(mesh, block_q=block_q)

    def loss_fn(batch: Batch, generator=None):
        kv_lens = batch["attention_mask"].sum(dim=-1).to(torch.int32)
        embeds = model.embed_tokens(batch["input_ids"])
        hidden = hidden_fn(model.decoder, embeds, kv_lens)
        return lm_loss_terms(model, model.compute_logits(hidden), batch["labels"])

    return make_masked_train_step(loss_fn, tx, sp_region=("decoder.",))


def sp_vlm_loss_fn(model: nn.Module, hidden_fn, batch: Batch,
                   generator: Optional[torch.Generator] = None):
    """The VLM's LM loss with its decoder over the ring: towers, packers
    and splice outside it (dropout drawing from `generator`)."""
    kv_lens = batch["attention_mask"].sum(dim=-1).to(torch.int32)
    with dropout_rng(generator):
        embeds = model.multimodal_embeds(
            batch["input_ids"], batch.get("image"), batch.get("image_2d"),
            deterministic=generator is None)
    hidden = hidden_fn(model.llm.decoder, embeds, kv_lens)
    return lm_loss_terms(model, model.llm.compute_logits(hidden), batch["labels"])


def make_sp_vlm_train_step(model: nn.Module, tx, mesh, *,
                           block_q: Optional[int] = None):
    """The VLM finetune step with the LLM decoder sequence parallel (the
    batch contract of `train.vlm.make_vlm_train_step`)."""
    hidden_fn = make_sp_decoder_hidden_fn(mesh, block_q=block_q)
    return make_masked_train_step(
        functools.partial(sp_vlm_loss_fn, model, hidden_fn), tx,
        sp_region=("llm.decoder.",))


def _image_features(model: nn.Module, mesh, image, slices=None, *,
                    generator=None, block_q=None):
    """A CLIP's L2-normalised image features of the CLS token, its vision
    tower over the ring."""
    from hsenet_torch.models.clip import _l2_normalise

    tokens = sp_encode_tokens(model.vision_encoder, mesh, image, slices,
                              generator=generator, block_q=block_q)
    return _l2_normalise(model.mm_vision_proj(tokens[:, 0]))


def sp_stage1_loss_fn(model: nn.Module, mesh, batch: Batch,
                      generator: Optional[torch.Generator] = None, *,
                      block_q: Optional[int] = None):
    """`train.stage1.stage1_loss_fn` with the vision tower over the ring;
    the text tower, the projections and the global contrastive loss run
    outside it. The gradients of the `vision_encoder.` leaves are this
    rank's share (summed over sp by the train step)."""
    from hsenet_torch.train.losses import clip_contrastive_loss, retrieval_accuracy
    from hsenet_torch.train.stage1 import global_features

    with dropout_rng(generator):
        txt, _ = model.encode_text(batch["input_ids"],
                                   batch.get("attention_mask"),
                                   deterministic=generator is None)
    img = _image_features(model, mesh, batch["image"], generator=generator,
                          block_q=block_q)
    img, txt = global_features(model, img, txt)
    scale = model.scale()
    loss, logits_i, _ = clip_contrastive_loss(img, txt, scale)
    return loss, {"loss": loss, "retrieval_acc": retrieval_accuracy(logits_i),
                  "logit_scale": scale.detach().clone()}


def make_sp_stage1_train_step(model: nn.Module, tx, mesh, *,
                              block_q: Optional[int] = None):
    """The stage-1 CLIP step (`train.stage1.make_stage1_train_step`'s
    contract) with the vision tower over the ring (`sp_stage1_loss_fn`)."""
    step = make_masked_train_step(
        functools.partial(sp_stage1_loss_fn, model, mesh, block_q=block_q), tx,
        sp_region=("vision_encoder.",))

    def train_step(state, batch: Batch, rng: int):
        return step(state, batch, int(rng))

    return train_step


def make_sp_stage2_train_step(student: nn.Module, teacher: nn.Module, cfg, tx,
                              mesh, cached_teacher: bool = False, *,
                              block_q: Optional[int] = None):
    """The stage-2 (2E3) step (`train.stage2.make_stage2_train_step`'s
    contract) with both vision towers over the ring: the student's with
    per-chunk dropout (the reference's slice Dropout(0.1) stays on), the
    frozen teacher's deterministic. With `cached_teacher` the batches carry
    the teacher's features and only the student's tower rides the ring."""
    from hsenet_torch.train.losses import clip_contrastive_loss
    from hsenet_torch.train.stage1 import global_features
    from hsenet_torch.train.stage2 import student_terms

    for p in teacher.parameters():
        p.requires_grad_(False)
    teacher_scale = teacher.scale().detach().clone()

    def teacher_logits(batch):
        if cached_teacher:
            t_img, t_txt = (batch["teacher_image_features"],
                            batch["teacher_text_features"])
            scale = teacher_scale
        else:
            with torch.no_grad():
                t_txt, _ = teacher.encode_text(batch["input_ids"],
                                               batch.get("attention_mask"))
                t_img = _image_features(teacher, mesh, batch["image"],
                                        block_q=block_q)
                scale = teacher.scale()
        t_img, t_txt = global_features(student, t_img, t_txt, grad=False)
        _, t_logits_i, t_logits_t = clip_contrastive_loss(t_img, t_txt, scale)
        return t_logits_i, t_logits_t

    def loss_fn(batch: Batch, step: int, generator=None):
        t_logits_i, t_logits_t = teacher_logits(batch)
        with dropout_rng(generator):
            s_txt, _ = student.encode_text(batch["input_ids"],
                                           batch.get("attention_mask"),
                                           deterministic=generator is None)
        s_img = _image_features(student, mesh, batch["image"], batch["image_2d"],
                                generator=generator, block_q=block_q)
        s_img, s_txt = global_features(student, s_img, s_txt)
        return student_terms(cfg, s_img, s_txt, student.scale(), step,
                             t_logits_i, t_logits_t)

    step = make_masked_train_step(loss_fn, tx, takes_step=True,
                                  sp_region=("vision_encoder.",))

    def train_step(state, batch: Batch, rng: int):
        return step(state, batch, int(rng))

    return train_step


def make_sp_teacher_embed_fn(teacher: nn.Module, mesh, *,
                             block_q: Optional[int] = None):
    """`train.stage2.make_teacher_embed_fn` with the teacher's vision tower
    over the ring: the cached teacher's fill, at the token counts where one
    card's dense forward would not fit."""
    device = next(teacher.parameters()).device

    @torch.no_grad()
    def embed(batch):
        def dev(key):
            return torch.as_tensor(batch[key]).to(device)

        mask = batch.get("attention_mask")
        t_txt, _ = teacher.encode_text(
            dev("input_ids"), None if mask is None else dev("attention_mask"))
        t_img = _image_features(teacher, mesh, dev("image"), block_q=block_q)
        return {"teacher_image_features": t_img,
                "teacher_text_features": t_txt}

    return embed
