"""What the port's entry points share: the training CLIs' arguments and
their run configuration (`add_train_args`, `train_config_from_args`,
`dtype_from_args`, `dump_config`, `resolve_resume_dir`,
`restore_or_fresh`, `load_tokenizer`), the process mesh of `--dp`,
`--tp`, `--pp` and `--sp` (`mesh_from_args`, `loader_shard`,
`maybe_zero1`), the VLM configurations of a run, models with random
weights for runs that need no checkpoint, and the restore of a
`--checkpoint` into such a model.

Launched by `torchrun --nproc-per-node N -m hsenet_torch.cli.<cli>`, a CLI
joins the process group and builds the (dp, tp), (dp, pp) or (dp, sp) mesh
of its flags; run as one plain process with `--dp`, `--tp`, `--pp` and
`--sp` at 1 it takes the single-card path."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from hsenet_torch.configs import (
    LoRAConfig,
    MeshConfig,
    PackerConfig,
    Phi3Config,
    TrainConfig,
    ViT3DConfig,
    VLMConfig,
)
from hsenet_torch.models import init_random_
from hsenet_torch.models.lora import quantize_embed_int8, quantize_kernels_int8


def add_train_args(p: argparse.ArgumentParser) -> None:
    """The flags every training CLI takes, with the JAX CLIs' defaults."""
    p.add_argument("--data-root", default="")
    p.add_argument("--manifest", default="", help="dataset manifest JSON")
    p.add_argument("--synthetic", action="store_true",
                   help="run on in-memory synthetic data (smoke test)")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--total-steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=24)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dp", type=int, default=-1,
                   help="data-parallel replicas; -1 = every process left "
                        "(world // tp)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel shards of the LLM")
    p.add_argument("--async-save", action="store_true",
                   help="checkpoint saves return once the state is copied "
                        "to the host; the write runs on a background thread "
                        "(utils/checkpoint.py)")
    p.add_argument("--zero1", action="store_true",
                   help="shard optimizer state over the dp axis (ZeRO-1)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--remat", action="store_true", default=None,
                   help="rematerialize transformer blocks (default: on for "
                        "production-size configs, off for --synthetic)")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--eval-every", type=int, default=500,
                   help="run the entry point's held-out eval every N "
                        "steps (retrieval accuracy for the CLIP "
                        "stages, token accuracy for the VLM — the "
                        "reference evaluates every 4%% of steps); 0 "
                        "disables")
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--resume", default="",
                   help="checkpoint dir to resume; 'auto' resumes from "
                        "this run's own --output-dir if it already holds "
                        "a checkpoint (preemption restart: relaunch the "
                        "same command), else starts fresh")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler trace (CPU and CUDA) of "
                        "steps [--profile-start, --profile-stop) to this dir "
                        "(Chrome/Perfetto-viewable)")
    p.add_argument("--profile-start", type=int, default=2)
    p.add_argument("--profile-stop", type=int, default=4)


def mesh_from_args(args, device):
    """The `DeviceMesh` of `--dp` with `--tp`, `--pp` or `--sp`
    (`parallel/mesh.py`): joins the process group that torchrun's
    environment names, if any. None for one process at --dp -1 or 1 and the
    others at 1; a mesh larger than the group, or pp / sp with another
    inner axis, raises ValueError."""
    from hsenet_torch.parallel.mesh import create_mesh, init_distributed

    init_distributed(device)
    return create_mesh(MeshConfig(dp=args.dp, tp=args.tp,
                                  pp=getattr(args, "pp", 1),
                                  sp=getattr(args, "sp", 1)), device=device)


def loader_shard(mesh, batch_size: int):
    """(per-rank batch size, num_shards, shard_index) of a global batch of
    `batch_size` over the mesh's dp ranks: the `DataLoader` arguments that
    give each dp rank its rows (the ranks of one tp group read the same)."""
    from hsenet_torch.parallel.mesh import axis_rank, axis_size

    dp = axis_size(mesh, "dp")
    if batch_size % dp:
        raise ValueError(f"--batch-size {batch_size} does not divide by "
                         f"dp ({dp})")
    return batch_size // dp, dp, axis_rank(mesh, "dp")


def maybe_zero1(state, args, mesh):
    """`state` with ZeRO-1 optimizer moments (`parallel/zero.py`) when
    --zero1 is set over a mesh whose dp is above 1; else unchanged."""
    if not getattr(args, "zero1", False) or mesh is None:
        return state
    from hsenet_torch.parallel.zero import shard_opt_state

    return dataclasses.replace(state, opt_state=shard_opt_state(
        state.opt_state, list(state.params.values()), mesh))


def train_config_from_args(args) -> TrainConfig:
    return TrainConfig(
        learning_rate=args.learning_rate,
        warmup_ratio=args.warmup_ratio,
        total_steps=args.total_steps,
        batch_size=args.batch_size,
        dtype=args.dtype,
        seed=args.seed,
        log_every=args.log_every,
        eval_every=getattr(args, "eval_every", 500),
        checkpoint_every=args.checkpoint_every,
        profile_dir=getattr(args, "profile", ""),
        profile_start=getattr(args, "profile_start", 2),
        profile_stop=getattr(args, "profile_stop", 4),
    )


def dtype_from_args(args) -> torch.dtype:
    return torch.bfloat16 if args.dtype == "bfloat16" else torch.float32


def dump_config(path: str, *cfgs) -> None:
    """`<path>/run_config.json`: each config dataclass's fields under its
    class name, as the JAX CLIs write it."""
    os.makedirs(path, exist_ok=True)
    blob = {type(cfg).__name__: dataclasses.asdict(cfg) for cfg in cfgs}
    with open(f"{path}/run_config.json", "w") as f:
        json.dump(blob, f, indent=2, default=str)


def resolve_resume_dir(args, ckpt=None) -> str:
    """--resume, with the preemption-restart idiom 'auto': the run's own
    --output-dir when it already holds a checkpoint, else '' (a fresh
    start). Relaunching the same command after a preemption continues from
    the last completed save; with the trainer's (seed, step) dropout streams
    and its fast-forward of the loader, the restarted run reproduces an
    unbroken one. `ckpt`: the CLI's CheckpointManager on --output-dir.
    Rank 0 decides and every rank takes its answer."""
    from hsenet_torch.parallel.mesh import broadcast_object

    if args.resume != "auto":
        return args.resume
    if ckpt is None:
        from hsenet_torch.utils.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.output_dir)
    return broadcast_object(
        args.output_dir if ckpt.latest_step() is not None else "")


def restore_or_fresh(state, args, ckpt):
    """The train state restored from --resume (see `resolve_resume_dir`),
    else `state`. `ckpt`: the CLI's CheckpointManager on --output-dir."""
    from hsenet_torch.utils.checkpoint import CheckpointManager

    resume_dir = resolve_resume_dir(args, ckpt)
    if not resume_dir:
        return state
    mgr = ckpt if resume_dir == args.output_dir else CheckpointManager(resume_dir)
    return mgr.restore(state)


def load_tokenizer(args, vocab_size: int, special_tokens=()):
    """The CLI's tokenizer: HF's `AutoTokenizer` from --tokenizer
    (`transformers` is imported only then), else the word-level
    `SimpleTokenizer` of `vocab_size`; `special_tokens` are added."""
    if args.tokenizer:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)
    else:
        from hsenet_torch.data.datasets import SimpleTokenizer

        tokenizer = SimpleTokenizer(vocab_size=vocab_size)
    if special_tokens:
        tokenizer.add_special_tokens(
            {"additional_special_tokens": list(special_tokens)})
    return tokenizer


def build_vlm_config(args) -> VLMConfig:
    """The VLM configuration of a run, as the JAX package's
    `cli/train_vlm.py::build_vlm_config` makes it: a tiny VLM for
    `args.synthetic`, else `VLMConfig()` with LoRA (rank 16, alpha 32) on
    the Phi-4-mini LLM; `args.online_slice_features` (where the namespace
    has it) turns on the in-graph 2D slice trunk."""
    online = getattr(args, "online_slice_features", False)
    if args.synthetic:
        return VLMConfig(
            online_slice_features=online,
            vision=ViT3DConfig(
                image_size=(8, 32, 32), patch_size=(2, 8, 8), hidden_size=32,
                mlp_dim=64, num_layers=2, num_heads=4, num_slices=4,
                slice_feature_dim=32,
            ),
            packer=PackerConfig(
                grid=(4, 4, 4), kernel=(1, 2, 2), in_dim=32, out_dim=64,
                dropout_rate=0.0,
            ),
            llm=Phi3Config(
                vocab_size=512, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                tie_word_embeddings=True,
                lora=LoRAConfig(rank=4, alpha=8, dropout_rate=0.05),
            ),
        )
    return VLMConfig(llm=dataclasses.replace(Phi3Config(), lora=LoRAConfig()),
                     online_slice_features=online)


def int8_serving_config(cfg: VLMConfig) -> VLMConfig:
    """`cfg` as the serving CLI runs it under `--quant-int8`: int8
    projections and embedding in the LLM, no LoRA."""
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, quant_int8=True, quant_int8_embed=True, lora=None))


def random_model(build, config, *, dtype, device, seed: int):
    """`build(config, dtype=, device=)` with weights drawn from `seed` on
    `device`, in eval mode. A config with `quant_int8` / `quant_int8_embed`
    (on it or on its `llm`) gets the float weights of the same seed,
    quantised on the device by the port's converters; any other config (a
    `CLIPConfig`) is built as it is."""
    llm = getattr(config, "llm", config)
    quantised = (getattr(llm, "quant_int8", False)
                 or getattr(llm, "quant_int8_embed", False))
    float_cfg = config
    if quantised:
        float_llm = dataclasses.replace(llm, quant_int8=False,
                                        quant_int8_embed=False)
        float_cfg = (float_llm if llm is config
                     else dataclasses.replace(config, llm=float_llm))
    model = build(float_cfg, dtype=dtype, device=device)
    init_random_(model, torch.Generator(device=device).manual_seed(seed))
    if quantised:
        state = model.state_dict()
        del model
        if llm.quant_int8:
            state = quantize_kernels_int8(state)
        if llm.quant_int8_embed:
            state = quantize_embed_int8(state)
        model = build(config, dtype=dtype, device=device)
        model.load_state_dict(state, strict=True)
    return model.eval()


def restore_checkpoint(model, path: str):
    """Load the `utils.checkpoint.save_params` file at `path` into `model`
    (strictly: its keys and shapes must be the model's), in place; float
    leaves take the model's dtypes."""
    from hsenet_torch.utils.checkpoint import restore_params

    model.load_state_dict(restore_params(path, model.state_dict()), strict=True)
    return model
