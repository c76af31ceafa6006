"""The VLM finetune step as `hsenet_torch.cli.train_vlm` builds it:
`HSENetVLM` computing in the configuration's dtype with remat, LoRA on the
decoder's projections; with the traffic's `int8_base` the frozen
projections stored as int8 codes by the port's converter (as `--int8-base`
does); the trainable leaves (`train/vlm.vlm_trainable_mask`) as f32
masters; `train/vlm.make_vlm_train_step` over the traffic's microbatches."""

from __future__ import annotations

import dataclasses

import torch

from benchmark.program import fill_weights

# where the train step finds its loss function (a fault is planted there)
LOSS = ('hsenet_torch.train.vlm', 'masked_lm_loss')


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def port_config(config: dict):
    from hsenet_torch.configs import (
        LoRAConfig,
        PackerConfig,
        Phi3Config,
        ViT3DConfig,
        VLMConfig,
    )

    lora = LoRAConfig(**_tuples(config["lora"]),
                      dropout_rate=config["lora_dropout_rate"])
    return VLMConfig(
        vision=ViT3DConfig(**_tuples(config["vision"]),
                           slice_dropout_rate=config["slice_dropout_rate"]),
        packer=PackerConfig(**_tuples(config["packer"]),
                            dropout_rate=config["packer_dropout_rate"]),
        llm=Phi3Config(**_tuples(config["llm"]), lora=lora,
                       remat_policy=config["remat_policy"]),
        tower_mode=config["tower_mode"],
        use_parallel_projector=config["use_parallel_projector"],
        select_feature=config["select_feature"])


def build(config: dict, traffic: dict, seed: int, device):
    """(model, trainable mask)."""
    from hsenet_torch.models.lora import quantize_kernels_int8
    from hsenet_torch.models.mllm import HSENetVLM
    from hsenet_torch.train.vlm import to_training_dtypes, vlm_trainable_mask

    cfg = port_config(config)
    dtype = getattr(torch, config["dtype"])
    model = HSENetVLM(cfg, dtype=dtype, device=device, remat=config["remat"])
    fill_weights(model, seed, config.get("qk_gain"))
    if traffic.get("int8_base"):
        state = model.state_dict()
        llm = {k: v for k, v in state.items() if k.startswith("llm.")}
        state = {k: v for k, v in state.items() if k not in llm}
        state.update(quantize_kernels_int8(llm))
        del llm, model
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, quant_int8=True))
        model = HSENetVLM(cfg, dtype=dtype, device=device, remat=config["remat"])
        model.load_state_dict(state, strict=True)
        del state
    model.train()
    mask = vlm_trainable_mask(model)
    to_training_dtypes(model, mask)
    return model, mask


def make_step(model, tx, traffic: dict):
    from hsenet_torch.train.vlm import make_vlm_train_step

    return make_vlm_train_step(model, tx, grad_accum=traffic["grad_accum"])
