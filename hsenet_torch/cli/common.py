"""What the port's entry points share: the VLM configurations of a run,
models with random weights for runs that need no checkpoint, and the
restore of a `--checkpoint` into such a model."""

from __future__ import annotations

import dataclasses

import torch

from hsenet_torch.configs import (
    LoRAConfig,
    PackerConfig,
    Phi3Config,
    ViT3DConfig,
    VLMConfig,
)
from hsenet_torch.models import init_random_
from hsenet_torch.models.lora import quantize_embed_int8, quantize_kernels_int8


def build_vlm_config(args) -> VLMConfig:
    """The VLM configuration of a run, as the JAX package's
    `cli/train_vlm.py::build_vlm_config` makes it: a tiny VLM for
    `args.synthetic`, else `VLMConfig()` with LoRA (rank 16, alpha 32) on
    the Phi-4-mini LLM."""
    if args.synthetic:
        return VLMConfig(
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
    return VLMConfig(llm=dataclasses.replace(Phi3Config(), lora=LoRAConfig()))


def int8_serving_config(cfg: VLMConfig) -> VLMConfig:
    """`cfg` as the serving CLI runs it under `--quant-int8`: int8
    projections and embedding in the LLM, no LoRA."""
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, quant_int8=True, quant_int8_embed=True, lora=None))


def random_model(build, config, *, dtype, device, seed: int):
    """`build(config, dtype=, device=)` with weights drawn from `seed` on
    `device`, in eval mode. A config with `quant_int8` / `quant_int8_embed`
    (on it or on its `llm`) gets the float weights of the same seed,
    quantised on the device by the port's converters."""
    llm = getattr(config, "llm", config)
    float_llm = dataclasses.replace(llm, quant_int8=False,
                                    quant_int8_embed=False)
    float_cfg = (float_llm if llm is config
                 else dataclasses.replace(config, llm=float_llm))
    model = build(float_cfg, dtype=dtype, device=device)
    init_random_(model, torch.Generator(device=device).manual_seed(seed))
    if llm.quant_int8 or llm.quant_int8_embed:
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
