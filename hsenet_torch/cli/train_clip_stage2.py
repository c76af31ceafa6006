"""Stage-2 (2E3) CLIP pretraining with the frozen stage-1 teacher (the port
of the JAX package's cli/train_clip_stage2.py).

Counterpart of the reference `train_CLIP_stage2.py` (teacher loaded from the
stage-1 checkpoint, strict; relation loss with the 5000-step ramp), with
the JAX CLI's flags and defaults:

    python -m hsenet_torch.cli.train_clip_stage2 --manifest m.json \
        --data-root /data --stage1-checkpoint out1/clip_params \
        --output-dir out2

(on a host without a card, `main([...], device="cpu")` as in
`train_clip_stage1`). The student is the slice-guided CLIP, drawn from
--seed (or given as `main(model=...)`); the teacher is the stage-1 CLIP
restored strictly from --stage1-checkpoint, and the student's
`language_encoder`, `mm_vision_proj` and `mm_language_proj` start as copies
of the teacher's (reference :185-190). --cached-teacher serves the teacher's
features from a `TeacherCache`. The exports are stage 1's: `<out>/clip_params`
and `<out>/tower_params`. `--dp`, `--tp` and `--zero1` run as in stage 1:
the teacher is replicated on every rank, each dp rank recomputes (or
caches) the teacher's features of its own rows, and both the contrastive
and the relation loss run over the global (B, B) logits. `--sp N` splits
both vision towers' tokens over N ranks of a (dp, sp) mesh, attention a
ring (`parallel/sp.py`), the cached teacher's fill included.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from hsenet_torch.cli.common import (
    add_train_args,
    dump_config,
    load_tokenizer,
    loader_shard,
    maybe_zero1,
    mesh_from_args,
    restore_or_fresh,
    train_config_from_args,
)
from hsenet_torch.cli.train_clip_stage1 import (
    add_clip_args,
    build_clip_model,
    clip_config_from_args,
    retrieval_eval_hook,
    train_and_export,
)

# the student's submodules that start as copies of the teacher's
WARM_STARTED = ("language_encoder", "mm_vision_proj", "mm_language_proj")


class CachedTeacherLoader:
    """`loader`'s batches with the teacher's features attached by `cache`.
    It passes the loader's length and epoch through, so the trainer sets
    the epoch and fast-forwards a resumed run as it does for the loader
    itself: the cached run takes the uncached run's batches. (The JAX CLI
    wraps the loader in a generator, which has neither: its first epoch
    shuffles with the epoch the init batch left, and a resumed run starts
    the epoch over; ROADMAP §C.)"""

    def __init__(self, loader, cache):
        self.loader, self.cache = loader, cache

    def __len__(self):
        return len(self.loader)

    @property
    def epoch(self):
        return self.loader.epoch

    @epoch.setter
    def epoch(self, value):
        self.loader.epoch = value

    def __iter__(self):
        return (self.cache.attach(b) for b in self.loader)


def main(argv=None, *, device="cuda", model=None):
    """Train stage 2 as `argv` says; returns the final `TrainState`. Runs on
    the CUDA card unless the caller passes `device="cpu"`. `model`, where
    given, is the slice-guided student `CLIPModel` (on `device`) in place
    of one drawn from --seed."""
    from hsenet_torch import resolve_device
    from hsenet_torch.data.datasets import DataArgs, DataLoader
    from hsenet_torch.parallel.mesh import is_main_process
    from hsenet_torch.parallel.sharding import shard_params
    from hsenet_torch.train.stage2 import (
        TeacherCache,
        make_stage2_train_step,
        make_teacher_embed_fn,
    )
    from hsenet_torch.train.train_state import TrainState, make_optimizer
    from hsenet_torch.train.vlm import to_training_dtypes
    from hsenet_torch.utils.checkpoint import CheckpointManager, restore_params

    p = argparse.ArgumentParser()
    add_train_args(p)
    add_clip_args(p)
    p.add_argument("--tokenizer", default="")
    p.add_argument("--stage1-checkpoint", default="",
                   help="params path of the pretrained stage-1 CLIP (teacher)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence parallelism: shard both towers' token "
                        "axes over an 'sp' mesh axis (ring attention, "
                        "parallel/sp.py::make_sp_stage2_train_step); the "
                        "student's dropout inside the ring draws each "
                        "chunk's own masks")
    p.add_argument("--cached-teacher", action="store_true",
                   help="precompute/cache frozen-teacher embeddings per "
                        "sample instead of re-running the teacher forward "
                        "every step (the reference recomputes, "
                        "CLIP_stage2.py:124-128)")
    args = p.parse_args(argv)
    device = resolve_device(device)
    mesh = mesh_from_args(args, device)

    teacher_cfg = clip_config_from_args(args)
    student_cfg = dataclasses.replace(
        teacher_cfg,
        vision=dataclasses.replace(teacher_cfg.vision, slice_guided=True),
    )
    train_cfg = train_config_from_args(args)
    tokenizer = load_tokenizer(args, teacher_cfg.text.vocab_size)
    data_args = DataArgs(data_root=args.data_root,
                         max_text_len=student_cfg.max_text_len)
    if args.synthetic:
        from hsenet_torch.data.datasets import SyntheticCTDataset

        dataset = SyntheticCTDataset(
            n=max(args.batch_size * 2, 16),
            shape=(1, *student_cfg.vision.image_size), tokenizer=tokenizer,
            mode="clip2", args=data_args,
            num_slices=student_cfg.vision.num_slices,
            slice_dim=student_cfg.vision.slice_feature_dim,
        )
    else:
        from hsenet_torch.data.datasets import CTRateCLIPStage2Dataset

        dataset = CTRateCLIPStage2Dataset(data_args, tokenizer, args.manifest,
                                          "train")
    rows, shards, index = loader_shard(mesh, args.batch_size)
    loader = DataLoader(dataset, rows, shuffle=True, seed=args.seed,
                        num_shards=shards, shard_index=index)
    next(iter(loader))  # the JAX CLI's init batch (see train_clip_stage1)

    if model is None:
        model = build_clip_model(student_cfg, args, device=device,
                                 seed=train_cfg.seed)
    model.train()
    to_training_dtypes(model, {n: True for n, _ in model.named_parameters()})
    teacher = build_clip_model(teacher_cfg, args, device=device,
                               seed=train_cfg.seed)
    if args.stage1_checkpoint:
        # read at f32 (the export's dtype): the student's copies keep every
        # bit, the teacher holds its weights in the compute dtype
        template = {k: v.float() if v.is_floating_point() else v
                    for k, v in teacher.state_dict().items()}
        saved = restore_params(args.stage1_checkpoint, template)
        teacher.load_state_dict(saved, strict=True)
        student = dict(model.named_parameters())
        with torch.no_grad():
            for name, value in saved.items():
                if name.split(".", 1)[0] in WARM_STARTED:
                    student[name].copy_(value)
        del saved, template
    teacher.eval()

    if mesh is not None:
        shard_params(model, mesh)
    tx = make_optimizer(train_cfg)
    ckpt = CheckpointManager(args.output_dir, async_save=args.async_save)
    state = maybe_zero1(TrainState.create(model, tx, mesh=mesh), args, mesh)
    state = restore_or_fresh(state, args, ckpt)
    if is_main_process():
        dump_config(args.output_dir, student_cfg, train_cfg)
    if args.sp > 1:
        from hsenet_torch.parallel.sp import (
            make_sp_stage2_train_step,
            make_sp_teacher_embed_fn,
        )

        step_fn = make_sp_stage2_train_step(model, teacher, student_cfg, tx,
                                            mesh, args.cached_teacher)
        # the cache's fill rides the ring too: at the token counts --sp is
        # for, one rank's dense teacher forward would not fit. Its ring
        # collectives must not interleave with the step's, so the batches
        # are drawn on the training thread (no device prefetch)
        embed_fn = make_sp_teacher_embed_fn(teacher, mesh)
        if args.cached_teacher:
            train_cfg = dataclasses.replace(train_cfg, device_prefetch=0)
    else:
        step_fn = make_stage2_train_step(model, teacher, student_cfg, tx,
                                         cached_teacher=args.cached_teacher)
        embed_fn = make_teacher_embed_fn(teacher)
    batches = (CachedTeacherLoader(loader, TeacherCache(embed_fn))
               if args.cached_teacher else loader)

    def val_dataset():
        from hsenet_torch.data.datasets import CTRateCLIPStage2Dataset

        return CTRateCLIPStage2Dataset(data_args, tokenizer, args.manifest,
                                       "validation")

    on_eval = retrieval_eval_hook(model, args, loader, val_dataset)
    return train_and_export(model, step_fn, state, lambda: batches, args,
                            train_cfg, ckpt, on_eval, mesh)


if __name__ == "__main__":
    main()
