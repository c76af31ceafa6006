"""VLM finetune entry point, MRG, VQA or SEG (the port of the JAX
package's cli/train_vlm.py).

Counterpart of the reference `train_VLM.py` + `script/train_vlm_{mrg,vqa}.sh`
(LoRA r16/a32, projectors + embeddings trainable, towers/LLM base frozen;
MRG: 6 epochs bs 2/GPU lr 1e-4 max_len 800; VQA: 4 epochs bs 5/GPU lr 5e-5
max_len 330), with the JAX CLI's flags and defaults:

    python -m hsenet_torch.cli.train_vlm --task mrg --manifest m.json \
        --data-root /data --batch-size 2 --remat \
        --clip-stage1-checkpoint out1/tower_params \
        --clip-stage2-checkpoint out2/tower_params --output-dir out3
    # a smoke run on a host without a card
    python -c "from hsenet_torch.cli.train_vlm import main; \
        main(['--task', 'mrg', '--synthetic', '--total-steps', '4', \
              '--batch-size', '2', '--dtype', 'float32'], device='cpu')"

The VLM is `build_vlm_config`'s, its weights drawn from --seed (or given as
`main(model=...)`), then grafted from --llm-checkpoint (the `llm.` subtree),
the two CLIP stages' `tower_params` exports (`vision_tower.tower_stage1.`
and `vision_tower.tower_stage2.`) and --resume-mllm's deltas. --int8-base
then stores the LLM's projections as int8 codes and trains the adapters,
packers and token table over them. The run ends with
`save_vlm_deltas(<out>/vlm_deltas)`. --online-slice-features computes the
2E3 tower's slice features in-graph from the volume with the frozen
BiomedCLIP trunk (`models.vit.OnlineSliceFeatures`), so the manifest needs
no `biomedclip_features`. --task seg also trains the [SEG]-routed SegVol
branch (`seg_enable`, dice + BCE added to the LM loss, `SegQADataset`);
seg manifests carry no slice features, so it pairs with
--online-slice-features.

`--dp`, `--tp`, `--zero1` and `--fsdp` run over the processes of `torchrun
--nproc-per-node N -m hsenet_torch.cli.train_vlm ...`: each dp rank loads its
rows of the --batch-size global batch (its share of each --grad-accum
microbatch), the LM loss is the token mean over the global microbatch,
the LLM is split over tp by the Megatron rules and, with --fsdp, every
large parameter over dp as well (`parallel/sharding.py`). `--pp N
--n-micro M` splits the decoder's layers into N GPipe stages over M
microbatches (`parallel/pipeline.py`; the layers must divide by N; each
layer is recomputed in the backward whatever --remat says); `--sp
N` splits the decoder's tokens over N ranks, attention a causal ring
(`parallel/sp.py`; --task mrg and vqa). Both compose with --dp, and LoRA
dropout runs off inside them. The JAX CLI's refusals of bad combinations
come first.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools

from hsenet_torch.cli.common import (
    add_train_args,
    build_vlm_config,
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

# where each CLIP stage's `tower_params` export lands in the VLM
TOWER_PREFIX = {"stage1": "vision_tower.tower_stage1.",
                "stage2": "vision_tower.tower_stage2."}


def graft_subtree(state, prefix: str, path: str):
    """`state` with the `save_params` file at `path` loaded under `prefix`:
    the file's keys must be exactly the subtree's (strict), its leaves of the
    subtree's shapes; float leaves take the subtree's dtypes."""
    from hsenet_torch.utils.checkpoint import restore_params
    from hsenet_torch.utils.convert import extract_subtree, graft_params

    loaded = restore_params(path, extract_subtree(state, prefix))
    return graft_params(state, {prefix + k: v for k, v in loaded.items()})


def main(argv=None, *, device="cuda", model=None):
    """Finetune as `argv` says; returns the final `TrainState` (its `model`
    is the trained VLM). Runs on the CUDA card unless the caller passes
    `device="cpu"`. `model`, where given, is the float `HSENetVLM` of
    `build_vlm_config` (with the seg branch under --task seg; on `device`)
    in place of one drawn from --seed; the grafts and --int8-base apply to
    it."""
    from hsenet_torch import resolve_device
    from hsenet_torch.data.datasets import SPECIAL_TOKENS, DataArgs, DataLoader
    from hsenet_torch.models.lora import quantize_kernels_int8
    from hsenet_torch.models.mllm import HSENetVLM
    from hsenet_torch.parallel.mesh import is_main_process
    from hsenet_torch.parallel.sharding import (
        full_state_dict,
        shard_params,
        shard_params_fsdp,
    )
    from hsenet_torch.train.train_state import TrainState, make_optimizer
    from hsenet_torch.train.trainer import TensorBoardLogger, Trainer, TrainerHooks
    from hsenet_torch.train.vlm import (
        make_vlm_eval_fn,
        make_vlm_train_step,
        to_training_dtypes,
        vlm_trainable_mask,
    )
    from hsenet_torch.utils.checkpoint import (
        CheckpointManager,
        is_vlm_delta,
        load_vlm_deltas,
        save_vlm_deltas,
    )

    p = argparse.ArgumentParser()
    add_train_args(p)
    p.add_argument("--task", choices=["mrg", "vqa", "seg"], default="mrg",
                   help="seg trains the [SEG]-routed SegVol branch "
                        "(dice+BCE added to the LM loss)")
    p.add_argument("--online-slice-features", action="store_true",
                   help="compute the 2E3 tower's 2D-slice features "
                        "in-graph from the volume (reference ViT4LLM_v3) "
                        "instead of reading image_2d from the dataset")
    p.add_argument("--max-length", type=int, default=0,
                   help="0 = task default (mrg 800 / vqa 330)")
    p.add_argument("--tokenizer", default="")
    p.add_argument("--llm-checkpoint", default="",
                   help="converted Phi params path")
    p.add_argument("--clip-stage1-checkpoint", default="")
    p.add_argument("--clip-stage2-checkpoint", default="")
    p.add_argument("--resume-mllm", default="",
                   help="projector+LoRA deltas to restore")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches accumulated inside one step (the "
                        "reference's HF gradient_accumulation_steps); "
                        "batch-size must divide evenly")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages for the LLM decoder "
                        "(GPipe over a 'pp' mesh axis, parallel/pipeline.py;"
                        " requires --tp 1, composes with --dp)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence parallelism for the LLM decoder: shard "
                        "the token axis over an 'sp' mesh axis (causal "
                        "ring attention, parallel/sp.py). LoRA dropout "
                        "runs off inside the ring (as with --pp)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters (and thus optimizer moments) over "
                        "the dp axis, composed with --tp "
                        "(parallel/sharding.py::shard_params_fsdp)")
    p.add_argument("--n-micro", type=int, default=2,
                   help="microbatches per pipeline tick group (per dp "
                        "replica); bubble = (pp-1)/(n_micro+pp-1)")
    p.add_argument("--int8-base", action="store_true",
                   help="store the FROZEN LLM base projections int8 "
                        "(per-output-channel scales) and train LoRA on top "
                        "(the reference's load_in_4bit QLoRA analog, "
                        "train_VLM.py:372)")
    args = p.parse_args(argv)
    if args.pp > 1 and args.zero1:
        p.error("--zero1 with --pp is unsupported: ZeRO-1's dp placement "
                "would override the pipeline's pp-sharded moments")
    if args.pp > 1 and args.sp > 1:
        p.error("--sp composes with dp only (pick one of --pp / --sp)")
    if args.fsdp and (args.pp > 1 or args.sp > 1):
        p.error("--fsdp shards params over dp on the (dp, tp) mesh; it "
                "doesn't compose with --pp / --sp placements")
    if args.fsdp and args.zero1:
        p.error("--fsdp already shards optimizer moments (they inherit "
                "the param placement); drop --zero1")
    if args.task == "seg" and (args.pp > 1 or args.sp > 1):
        p.error("--task seg uses the plain train step (no --pp / --sp)")
    device = resolve_device(device)
    mesh = mesh_from_args(args, device)

    max_length = args.max_length or (800 if args.task == "mrg" else 330)
    cfg = build_vlm_config(args)
    train_cfg = train_config_from_args(args)
    dtype = dtype_from_args(args)
    tokenizer = load_tokenizer(args, cfg.llm.vocab_size, SPECIAL_TOKENS)
    seg = args.task == "seg"
    if seg:
        cfg = dataclasses.replace(
            cfg, seg_enable=True,
            seg_token_id=int(tokenizer.convert_tokens_to_ids("[SEG]")))
    data_args = DataArgs(data_root=args.data_root, max_length=max_length,
                         proj_out_num=cfg.num_image_tokens)
    if args.synthetic:
        from hsenet_torch.data.datasets import SyntheticCTDataset

        data_args = dataclasses.replace(data_args,
                                        max_length=min(max_length, 96))
        dataset = SyntheticCTDataset(
            n=max(args.batch_size * 2, 8), shape=(1, *cfg.vision.image_size),
            tokenizer=tokenizer, mode="seg" if seg else "caption",
            args=data_args,
            num_slices=cfg.vision.num_slices,
            slice_dim=cfg.vision.slice_feature_dim,
        )
    elif args.task == "mrg":
        from hsenet_torch.data.datasets import CaptionDataset

        dataset = CaptionDataset(data_args, tokenizer, args.manifest, "train")
    elif seg:
        from hsenet_torch.data.datasets import SegQADataset

        dataset = SegQADataset(data_args, tokenizer, args.manifest, "train")
    else:
        from hsenet_torch.data.datasets import VQALocationDataset

        dataset = VQALocationDataset(data_args, tokenizer, args.manifest, "train")
    rows, shards, index = loader_shard(mesh, args.batch_size)
    loader = DataLoader(dataset, rows, shuffle=True, seed=args.seed,
                        num_shards=shards, shard_index=index)
    remat = args.remat if args.remat is not None else not args.synthetic
    batch = next(iter(loader))  # the JAX CLI's init batch
    if batch.get("image_2d") is None and not cfg.online_slice_features:
        p.error(
            "this dataset provides no 2D slice features (image_2d); pass "
            "--online-slice-features to compute them in-graph from the "
            "volume (reference ViT4LLM_v3), or use a manifest that "
            "carries image_2d npys"
        )
    build = functools.partial(HSENetVLM, remat=remat)
    if model is None:
        model = random_model(build, cfg, dtype=dtype, device=device,
                             seed=train_cfg.seed)

    state = model.state_dict()
    if args.llm_checkpoint:
        state = graft_subtree(state, "llm.", args.llm_checkpoint)
    for path, stage in ((args.clip_stage1_checkpoint, "stage1"),
                        (args.clip_stage2_checkpoint, "stage2")):
        if path:
            state = graft_subtree(state, TOWER_PREFIX[stage], path)
    if args.resume_mllm:
        state = load_vlm_deltas(args.resume_mllm, state)
    if args.int8_base and not remat:
        # without remat every block's converted bf16 copy of its frozen int8
        # weights stays alive for the backward: memory goes up, not down
        print(
            "warning: --int8-base without --remat materializes dequantized "
            "weight copies in the backward; pass --remat to get the memory win"
        )
    if args.int8_base:
        # the frozen LLM base projections int8 after every graft; the token
        # table stays float (it trains: the new special tokens)
        llm = {k: v for k, v in state.items() if k.startswith("llm.")}
        state = {k: v for k, v in state.items() if k not in llm}
        state.update(quantize_kernels_int8(llm))
        del llm
        # the model's own config: a caller's model may differ from the flags'
        cfg = dataclasses.replace(
            model.config, llm=dataclasses.replace(model.config.llm, quant_int8=True))
        del model
        model = build(cfg, dtype=dtype, device=device)
    model.load_state_dict(state, strict=True)
    del state
    model.train()
    mask = vlm_trainable_mask(model)
    to_training_dtypes(model, mask)
    if mesh is not None:
        (shard_params_fsdp if args.fsdp else shard_params)(model, mesh)
    if args.pp > 1:
        from hsenet_torch.parallel.pipeline import shard_params_pp

        # the decoder's layers staged over pp; the JAX CLI's assert is a
        # ValueError here
        shard_params_pp(model, mesh)

    tx = make_optimizer(train_cfg, trainable_mask=mask)
    ckpt = CheckpointManager(args.output_dir, async_save=args.async_save)
    train_state = maybe_zero1(TrainState.create(model, tx, mesh=mesh), args,
                              mesh)
    train_state = restore_or_fresh(train_state, args, ckpt)
    main_rank = is_main_process()
    if main_rank:
        dump_config(args.output_dir, cfg, train_cfg)
    eval_loss = None
    if args.pp > 1:
        from hsenet_torch.parallel.pipeline import make_pp_vlm_train_step, pp_vlm_loss_fn

        step_fn = make_pp_vlm_train_step(model, tx, mesh, n_micro=args.n_micro)
        eval_loss = functools.partial(pp_vlm_loss_fn, n_micro=args.n_micro)
    elif args.sp > 1:
        from hsenet_torch.parallel.sp import make_sp_vlm_train_step

        step_fn = make_sp_vlm_train_step(model, tx, mesh)
    else:
        step_fn = make_vlm_train_step(model, tx, grad_accum=args.grad_accum,
                                      seg=seg)

    evaluate = make_vlm_eval_fn(model, seg=seg, loss_fn=eval_loss)
    val_cache = {}  # the validation loader is built once

    def on_eval(step, eval_state):
        try:
            if args.synthetic:
                val = loader
            elif "val" in val_cache:
                val = val_cache["val"]
            else:
                val_ds = type(dataset)(data_args, tokenizer, args.manifest,
                                       "validation")
                val = val_cache["val"] = DataLoader(val_ds, args.batch_size,
                                                    shuffle=False)
            return evaluate(val)
        except Exception as e:  # eval must never kill training
            print(f"eval failed: {e}")
            return {}

    hooks = TrainerHooks(
        on_log=TensorBoardLogger(f"{args.output_dir}/tb") if main_rank else None,
        on_eval=on_eval if train_cfg.eval_every else None,
    )
    trainer = Trainer(step_fn, train_state, lambda: loader, train_cfg,
                      checkpoint_manager=ckpt, hooks=hooks, mesh=mesh)
    train_state = trainer.fit()
    # the deltas of the whole model (every pipeline stage's layers too)
    final = full_state_dict(model, keep=is_vlm_delta)
    if main_rank:
        hooks.on_log.close()
        save_vlm_deltas(f"{args.output_dir}/vlm_deltas", final)
        print(f"done: step {train_state.step}")
    return train_state


if __name__ == "__main__":
    main()
