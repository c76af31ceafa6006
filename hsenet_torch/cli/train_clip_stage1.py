"""Stage-1 CLIP pretraining entry point (the port of the JAX package's
cli/train_clip_stage1.py).

Counterpart of the reference `train_CLIP_stage1.py` +
`script/train_clip_stage1.sh` (50 epochs, bs 3/GPU x8, lr 1e-4, cosine,
warmup 0.03, bf16), with the JAX CLI's flags and defaults:

    # on the card
    python -m hsenet_torch.cli.train_clip_stage1 --manifest m.json \
        --data-root /data --output-dir out1
    # a smoke run on a host without a card: `main` takes `device="cpu"`
    python -c "from hsenet_torch.cli.train_clip_stage1 import main; \
        main(['--synthetic', '--total-steps', '4', '--text-hidden', '32', \
              '--image-size', '8', '32', '32', '--patch-size', '2', '8', '8', \
              '--hidden-size', '32', '--mlp-dim', '64', '--num-layers', '2', \
              '--num-heads', '4', '--max-text-len', '16', '--dtype', \
              'float32', '--batch-size', '4'], device='cpu')"

The weights are drawn from --seed on the device (or `main(model=...)`
trains a given `CLIPModel`). At the end the run exports `<out>/clip_params`
(the whole CLIP: stage 2's teacher) and `<out>/tower_params` (the vision
encoder: the VLM's `tower_stage1` graft) with `utils.checkpoint.save_params`.
`--dp`, `--tp` and `--zero1` run over the processes of `torchrun
--nproc-per-node N -m hsenet_torch.cli.train_clip_stage1 ...`: each dp rank
loads its rows of the --batch-size global batch and the contrastive loss
is the global one (`train/stage1.py`); the CLIP has no LLM, so tp ranks
hold replicas. `--sp N` splits the vision tower's tokens over N ranks of a
(dp, sp) mesh, attention a ring (`parallel/sp.py`); the ranks of one sp
group read the same rows.
"""

from __future__ import annotations

import argparse
import functools

from hsenet_torch.cli.common import (
    add_train_args,
    dtype_from_args,
    dump_config,
    load_tokenizer,
    loader_shard,
    maybe_zero1,
    mesh_from_args,
    random_model,
    restore_or_fresh,
    train_config_from_args,
)
from hsenet_torch.configs import BertConfig, CLIPConfig, ViT3DConfig


def add_clip_args(p: argparse.ArgumentParser) -> None:
    """The model and text flags both CLIP stages take."""
    p.add_argument("--image-size", type=int, nargs=3, default=[32, 256, 256])
    p.add_argument("--patch-size", type=int, nargs=3, default=[4, 16, 16])
    p.add_argument("--hidden-size", type=int, default=768)
    p.add_argument("--mlp-dim", type=int, default=3072)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--num-heads", type=int, default=12)
    p.add_argument("--num-slices", type=int, default=32)
    p.add_argument("--slice-dim", type=int, default=768)
    p.add_argument("--text-hidden", type=int, default=0,
                   help="0 = BERT-base; nonzero builds a tiny text encoder")
    p.add_argument("--max-text-len", type=int, default=128)


def clip_config_from_args(args) -> CLIPConfig:
    """The stage-1 (teacher) CLIP of the flags: the 3D ViT and BERT-base, or
    a 2-layer text encoder of width --text-hidden."""
    vision = ViT3DConfig(
        image_size=tuple(args.image_size),
        patch_size=tuple(args.patch_size),
        hidden_size=args.hidden_size,
        mlp_dim=args.mlp_dim,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
        num_slices=args.num_slices,
        slice_feature_dim=args.slice_dim,
    )
    text = (
        BertConfig()
        if args.text_hidden == 0
        else BertConfig(
            vocab_size=512, hidden_size=args.text_hidden, num_layers=2,
            num_heads=args.num_heads, intermediate_size=2 * args.text_hidden,
            max_position_embeddings=64,
        )
    )
    return CLIPConfig(vision=vision, text=text, projection_dim=args.hidden_size,
                      max_text_len=args.max_text_len)


def build_clip_model(cfg: CLIPConfig, args, *, device, seed: int):
    """`CLIPModel(cfg)` in the run's dtype with weights drawn from `seed` on
    `device`, remat as the flags set it (default: on unless --synthetic)."""
    from hsenet_torch.models.clip import CLIPModel

    remat = args.remat if args.remat is not None else not args.synthetic
    return random_model(functools.partial(CLIPModel, remat=remat), cfg,
                        dtype=dtype_from_args(args), device=device, seed=seed)


def retrieval_eval_hook(model, args, loader, val_dataset):
    """The trainer's `on_eval`: retrieval recall@5/10 of the model's current
    weights over the validation split (for --synthetic the training data,
    the whole global batch on every rank), its loader built on the first
    eval and kept. An eval that fails prints and returns {}: it must not
    end the run."""
    from hsenet_torch.data.datasets import DataLoader
    from hsenet_torch.eval.retrieval import make_clip_retrieval_eval_fn

    evaluate = make_clip_retrieval_eval_fn(model, ks=(5, 10))
    val_cache = {}

    def on_eval(step, state):
        try:
            if args.synthetic and loader.num_shards == 1:
                val = loader
            elif args.synthetic:
                val = val_cache.setdefault("val", DataLoader(
                    loader.dataset, args.batch_size, shuffle=True,
                    seed=args.seed))
            elif "val" in val_cache:
                val = val_cache["val"]
            else:
                val = val_cache["val"] = DataLoader(
                    val_dataset(), args.batch_size, shuffle=False)
            return evaluate(val)
        except Exception as e:  # eval must never kill training
            print(f"eval failed: {e}")
            return {}

    return on_eval


def train_and_export(model, step_fn, state, loader_fn, args, train_cfg, ckpt,
                     on_eval, mesh=None):
    """Fit with the CLIs' hooks (TensorBoard at <out>/tb, the eval hook),
    then export <out>/clip_params and <out>/tower_params; over a mesh rank
    0 alone logs and writes."""
    from hsenet_torch.parallel.mesh import is_main_process
    from hsenet_torch.parallel.sharding import full_state_dict
    from hsenet_torch.train.trainer import TensorBoardLogger, Trainer, TrainerHooks
    from hsenet_torch.utils.checkpoint import save_params
    from hsenet_torch.utils.convert import extract_subtree

    main_rank = is_main_process()
    hooks = TrainerHooks(
        on_log=TensorBoardLogger(f"{args.output_dir}/tb") if main_rank else None,
        on_eval=on_eval if train_cfg.eval_every else None,
    )
    trainer = Trainer(step_fn, state, loader_fn, train_cfg,
                      checkpoint_manager=ckpt, hooks=hooks, mesh=mesh)
    state = trainer.fit()
    final = full_state_dict(model)
    if main_rank:
        hooks.on_log.close()
        save_params(f"{args.output_dir}/clip_params", final, overwrite=True)
        save_params(f"{args.output_dir}/tower_params",
                    extract_subtree(final, "vision_encoder."), overwrite=True)
        print(f"done: step {state.step}")
    return state


def main(argv=None, *, device="cuda", model=None):
    """Train stage 1 as `argv` says; returns the final `TrainState`. Runs on
    the CUDA card unless the caller passes `device="cpu"`, where every kernel
    is replaced by its plain version. `model`, where given, is the
    `CLIPModel` to train (on `device`) in place of one drawn from --seed."""
    from hsenet_torch import resolve_device
    from hsenet_torch.data.datasets import DataArgs, DataLoader
    from hsenet_torch.parallel.mesh import is_main_process
    from hsenet_torch.parallel.sharding import shard_params
    from hsenet_torch.train.stage1 import make_stage1_train_step
    from hsenet_torch.train.train_state import TrainState, make_optimizer
    from hsenet_torch.train.vlm import to_training_dtypes
    from hsenet_torch.utils.checkpoint import CheckpointManager

    p = argparse.ArgumentParser()
    add_train_args(p)
    p.add_argument("--sp", type=int, default=1,
                   help="sequence parallelism: shard the ViT's token axis "
                        "over an 'sp' mesh axis (ring attention, "
                        "parallel/sp.py); tower dropout inside the ring "
                        "draws each chunk's own masks")
    add_clip_args(p)
    p.add_argument("--tokenizer", default="", help="HF tokenizer path")
    args = p.parse_args(argv)
    device = resolve_device(device)
    mesh = mesh_from_args(args, device)

    clip_cfg = clip_config_from_args(args)
    train_cfg = train_config_from_args(args)
    tokenizer = load_tokenizer(args, clip_cfg.text.vocab_size)
    data_args = DataArgs(data_root=args.data_root,
                         max_text_len=clip_cfg.max_text_len)
    if args.synthetic:
        from hsenet_torch.data.datasets import SyntheticCTDataset

        dataset = SyntheticCTDataset(
            n=max(args.batch_size * 2, 16), shape=(1, *clip_cfg.vision.image_size),
            tokenizer=tokenizer, mode="clip", args=data_args,
        )
    else:
        from hsenet_torch.data.datasets import CTRateCLIPDataset

        dataset = CTRateCLIPDataset(data_args, tokenizer, args.manifest, "train")
    rows, shards, index = loader_shard(mesh, args.batch_size)
    loader = DataLoader(dataset, rows, shuffle=True, seed=args.seed,
                        num_shards=shards, shard_index=index)
    # the JAX CLI draws its init batch here: the CT-RATE set's sentence
    # sampling then continues from the same draw
    next(iter(loader))
    if model is None:
        model = build_clip_model(clip_cfg, args, device=device, seed=train_cfg.seed)
    model.train()
    to_training_dtypes(model, {n: True for n, _ in model.named_parameters()})
    if mesh is not None:
        shard_params(model, mesh)
    tx = make_optimizer(train_cfg)
    ckpt = CheckpointManager(args.output_dir, async_save=args.async_save)
    state = maybe_zero1(TrainState.create(model, tx, mesh=mesh), args, mesh)
    state = restore_or_fresh(state, args, ckpt)
    if is_main_process():
        dump_config(args.output_dir, clip_cfg, train_cfg)

    def val_dataset():
        from hsenet_torch.data.datasets import CTRateCLIPDataset

        return CTRateCLIPDataset(data_args, tokenizer, args.manifest, "validation")

    on_eval = retrieval_eval_hook(model, args, loader, val_dataset)
    if args.sp > 1:
        from hsenet_torch.parallel.sp import make_sp_stage1_train_step

        step_fn = make_sp_stage1_train_step(model, tx, mesh)
    else:
        step_fn = make_stage1_train_step(model, tx)
    return train_and_export(model, step_fn, state, lambda: loader, args,
                            train_cfg, ckpt, on_eval, mesh)


if __name__ == "__main__":
    main()
