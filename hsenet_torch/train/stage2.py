"""Stage-2 (2E3) CLIP train step with a frozen stage-1 teacher (the port of
the JAX package's train/stage2.py).

The teacher is a stage-1 `CLIPModel` whose parameters do not require grad;
it runs under `torch.no_grad()` on the same batch. The student's loss is
its own contrastive loss plus the relation MSE between the teacher's and
its logit matrices, weighted by `relation_weight(step)`.

Cached-teacher mode: the teacher's features depend only on the inputs and
the frozen teacher, so `TeacherCache` computes them once per sample (host
numpy, keyed by a sha1 of the sample) and the step takes them from the
batch (`teacher_image_features`, `teacher_text_features`), with the
teacher's logit scale read once when the step is made.

The dropout stream is drawn from (rng, step) in every step, as in stage 1.
Over a data-parallel mesh both logit matrices are the global (B, B) ones,
as in stage 1: the student's features are gathered with a gradient, the
teacher's (recomputed or cached) without. The sequence-parallel step,
with both towers over the ring, is `parallel.sp.make_sp_stage2_train_step`.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from hsenet_torch.configs import CLIPConfig
from hsenet_torch.models.layers import dropout_rng
from hsenet_torch.train.losses import (
    clip_contrastive_loss,
    relation_regulation_loss,
    relation_weight,
    retrieval_accuracy,
)
from hsenet_torch.train.stage1 import global_features
from hsenet_torch.train.train_state import AdamW
from hsenet_torch.train.vlm import make_masked_train_step

Batch = Dict[str, torch.Tensor]


def _student_loss(student: nn.Module, cfg: CLIPConfig, batch: Batch,
                  step: int, generator, t_logits_i, t_logits_t):
    with dropout_rng(generator):
        s_img, s_txt, s_scale = student(
            batch["image"], batch["input_ids"], batch.get("attention_mask"),
            batch["image_2d"], deterministic=generator is None,
        )
    s_img, s_txt = global_features(student, s_img, s_txt)
    return student_terms(cfg, s_img, s_txt, s_scale, step, t_logits_i,
                         t_logits_t)


def student_terms(cfg: CLIPConfig, s_img, s_txt, s_scale, step: int,
                  t_logits_i, t_logits_t):
    """The student's loss and metrics from its global features and the
    teacher's logits: contrastive loss plus the weighted relation MSE."""
    loss_cl, s_logits_i, s_logits_t = clip_contrastive_loss(s_img, s_txt,
                                                             s_scale)
    loss_rel = relation_regulation_loss(t_logits_i, t_logits_t, s_logits_i,
                                        s_logits_t)
    w = relation_weight(step, cfg.relation_max_weighted_step,
                        cfg.relation_base_weight).to(loss_cl.device)
    loss = loss_cl + w * loss_rel
    metrics = {
        "loss": loss,
        "loss_cl": loss_cl,
        "loss_relation": loss_rel,
        "relation_weight": w,
        "retrieval_acc": retrieval_accuracy(s_logits_i),
    }
    return loss, metrics


def stage2_loss_fn(student: nn.Module, teacher: nn.Module, cfg: CLIPConfig,
                   batch: Batch, step: int,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The teacher's forward (frozen, deterministic, no slice features),
    then the student's loss against its logits."""
    with torch.no_grad():
        t_img, t_txt, t_scale = teacher(
            batch["image"], batch["input_ids"], batch.get("attention_mask"),
            deterministic=True,
        )
        t_img, t_txt = global_features(student, t_img, t_txt, grad=False)
        _, t_logits_i, t_logits_t = clip_contrastive_loss(t_img, t_txt, t_scale)
    return _student_loss(student, cfg, batch, step, generator, t_logits_i,
                         t_logits_t)


def stage2_loss_fn_cached(student: nn.Module, cfg: CLIPConfig,
                          teacher_scale: torch.Tensor, batch: Batch, step: int,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Like `stage2_loss_fn`, with the teacher's features taken from the
    batch: no teacher forward in the step."""
    t_img, t_txt = global_features(student, batch["teacher_image_features"],
                                   batch["teacher_text_features"], grad=False)
    _, t_logits_i, t_logits_t = clip_contrastive_loss(t_img, t_txt,
                                                      teacher_scale)
    return _student_loss(student, cfg, batch, step, generator, t_logits_i,
                         t_logits_t)


def make_teacher_embed_fn(teacher: nn.Module) -> Callable:
    """`embed(batch) -> {teacher_image_features, teacher_text_features}`:
    the frozen teacher's features of a host batch (numpy), as device
    tensors in the teacher's compute dtype."""
    device = next(teacher.parameters()).device

    @torch.no_grad()
    def embed(batch):
        def dev(key):
            return torch.as_tensor(batch[key]).to(device)

        mask = batch.get("attention_mask")
        t_img, t_txt, _ = teacher(
            dev("image"), dev("input_ids"),
            None if mask is None else dev("attention_mask"),
            deterministic=True,
        )
        return {"teacher_image_features": t_img,
                "teacher_text_features": t_txt}

    return embed


class TeacherCache:
    """Host-memory cache of frozen-teacher features, keyed PER SAMPLE.

    A sample's first sight pays the teacher forward (one forward for its
    whole batch); every later sight is served from the store. The key is a
    sha1 of the sample's input_ids, attention_mask and image bytes and
    their shapes, so shuffled epochs that recombine samples still hit."""

    def __init__(self, embed_fn: Callable):
        self._embed_fn = embed_fn
        self._store: Dict[bytes, Dict[str, np.ndarray]] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _keys(batch):
        ids = np.asarray(batch["input_ids"])
        img = np.asarray(batch["image"])
        mask = batch.get("attention_mask")
        mask = np.asarray(mask) if mask is not None else None
        keys = []
        for i in range(len(ids)):
            h = hashlib.sha1()
            h.update(repr((ids[i].shape, img[i].shape)).encode())
            h.update(ids[i].tobytes())
            if mask is not None:
                h.update(mask[i].tobytes())
            h.update(img[i].tobytes())
            keys.append(h.digest())
        return keys

    def attach(self, batch):
        """`batch` merged with its teacher features, as f32 numpy arrays
        (exact copies of the teacher's bf16 or f32 values)."""
        keys = self._keys(batch)
        missing = [k for k in keys if k not in self._store]
        if missing:
            self.misses += len(missing)
            self.hits += len(keys) - len(missing)
            feats = {name: v.float().cpu().numpy()
                     for name, v in self._embed_fn(batch).items()}
            for i, k in enumerate(keys):
                self._store[k] = {name: v[i] for name, v in feats.items()}
            return {**batch, **feats}
        self.hits += len(keys)
        rows = [self._store[k] for k in keys]
        return {**batch, **{name: np.stack([r[name] for r in rows])
                            for name in rows[0]}}


def make_stage2_train_step(student: nn.Module, teacher: nn.Module,
                           cfg: CLIPConfig, tx: AdamW,
                           cached_teacher: bool = False):
    """`train_step(state, batch, rng) -> (state, metrics)` of the student
    (`rng` an int seed, required). The teacher's parameters are frozen
    here. With `cached_teacher` the batches must carry the teacher's
    features (`TeacherCache.attach`), and the teacher's logit scale is read
    now."""
    for p in teacher.parameters():
        p.requires_grad_(False)
    if cached_teacher:
        teacher_scale = teacher.scale().detach().clone()
        loss_fn = functools.partial(stage2_loss_fn_cached, student, cfg,
                                    teacher_scale)
    else:
        loss_fn = functools.partial(stage2_loss_fn, student, teacher, cfg)
    step = make_masked_train_step(loss_fn, tx, takes_step=True)

    def train_step(state, batch: Batch, rng: int):
        return step(state, batch, int(rng))

    return train_step
