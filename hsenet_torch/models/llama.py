"""Llama-3-style decoder (the port of the JAX package's models/llama.py),
the reference's alternative LLM backbone (`LamedLlamaForCausalLM`).

Llama differs from Phi3 only in its configuration: separate q/k/v and
gate/up projections (already the port's layout), no attention bias, the
full head dim rotated, no LongRoPE factors and an untied LM head by
default. So `LlamaForCausalLM` is the port's `Phi3ForCausalLM` under
`llama_as_phi3_config`, and `convert_hf_llama` renames an HF state dict
into its keys.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from hsenet_torch.configs import LlamaConfig, Phi3Config
from hsenet_torch.models.phi3 import Phi3ForCausalLM


def llama_as_phi3_config(cfg: LlamaConfig) -> Phi3Config:
    """The Phi3 decoder configuration that computes Llama: rotary factor
    1.0, no attention bias, no LongRoPE factors (so no attention scaling)."""
    return Phi3Config(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_layers=cfg.num_layers,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta,
        partial_rotary_factor=1.0,  # Llama rotates the full head dim
        rms_norm_eps=cfg.rms_norm_eps,
        tie_word_embeddings=cfg.tie_word_embeddings,
        attention_bias=False,
        lora=cfg.lora,
        quant_int8=cfg.quant_int8,
        quant_int8_embed=cfg.quant_int8_embed,
    )


def LlamaForCausalLM(config: LlamaConfig, *, dtype=torch.bfloat16,
                     device="cuda", remat: bool = False) -> Phi3ForCausalLM:
    """The shared decoder configured for Llama."""
    return Phi3ForCausalLM(llama_as_phi3_config(config), dtype=dtype,
                           device=device, remat=remat)


# the port's module name -> HF's, in each decoder layer
_LAYER_NAMES = {"input_norm": "input_layernorm",
                "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
                "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
                "post_attn_norm": "post_attention_layernorm",
                "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
                "down_proj": "mlp.down_proj"}


def convert_hf_llama_layer(state_dict: Mapping[str, torch.Tensor],
                           i: int) -> Dict[str, torch.Tensor]:
    """Decoder layer i of an HF Llama state dict under the port's keys (a
    full-width model can be converted, and quantised, one layer at a
    time)."""
    return {f"decoder.layers.{i}.{dst}.weight":
            state_dict[f"model.layers.{i}.{src}.weight"]
            for dst, src in _LAYER_NAMES.items()}


def convert_hf_llama(state_dict: Mapping[str, torch.Tensor],
                     config: LlamaConfig) -> Dict[str, torch.Tensor]:
    """HF torch `LlamaForCausalLM.state_dict()` -> the state dict of the
    port's `LlamaForCausalLM`. HF keeps q/k/v and gate/up separate and in
    the port's (out, in) layout, so every tensor is renamed, not copied:
    it stays on its device and in its dtype (at Llama-3-8B width an f32
    host copy would take 32 GB). The LM head is taken only for untied
    configs."""
    out = {"embed.weight": state_dict["model.embed_tokens.weight"]}
    for i in range(config.num_layers):
        out.update(convert_hf_llama_layer(state_dict, i))
    out["decoder.norm.weight"] = state_dict["model.norm.weight"]
    if not config.tie_word_embeddings and "lm_head.weight" in state_dict:
        out["lm_head.weight"] = state_dict["lm_head.weight"]
    return out
