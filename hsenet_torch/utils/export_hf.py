"""Reverse checkpoint conversion: the port's state dicts -> reference
PyTorch state dicts (the port of the JAX package's utils/export_hf.py).

The inverse of `utils/convert.py` and the per-model `convert_hf_*`
functions: weights trained here go back into the key layouts the reference
stack reads (HF `from_pretrained`-style loading, the reference's eval
scripts, serving without peft), so the round trip convert -> finetune ->
export closes.

Every function takes a state dict of the port (dotted names, per-layer
modules, Linear weights (out, in)) on any device and returns a plain
`{name: np.ndarray}` of f32 arrays; `to_torch_state_dict` makes torch
tensors of them for `torch.save` / `load_state_dict`.

LoRA adapters are folded into the base weights before export
(`models.lora.merge_lora`): the exported model is the merged full model,
loadable without peft. int8 weights (`weight_q` (out, in) codes with
`weight_scale` (out,), a `QuantEmbed`'s `embedding_q` with its per-row
`scale`) are dequantised exactly, codes x scale in f32, the product the
quantised layers compute; then the adapters are merged, as the JAX
exporter orders the two. The merge runs on the state's device in f32,
without TF32 on the card: a bf16 base with f32 adapters (the port's
training layout) merges as the JAX exporter's type promotion merges it,
and no merged weight is rounded to bf16.

Reference layouts:
  * HF Phi3: fused qkv_proj / gate_up_proj per layer (inverse of
    `models.phi3.convert_hf_phi3`);
  * HF Llama: separate q/k/v/gate/up (inverse of
    `models.llama.convert_hf_llama`);
  * MONAI-style ViT tower + VisualPacker: the stage-1/2 CLIP checkpoint keys
    (inverse of `convert_reference_vit` / `convert_reference_packer`; key
    facts in utils/convert.py's module docstring);
  * the reference's VLM-delta file (`export_reference_vlm_deltas`).
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Mapping

import numpy as np
import torch

from hsenet_torch.models.lora import merge_lora


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


@contextlib.contextmanager
def _exact_f32():
    """f32 products on the card without TF32 for the duration."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def _dequant(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`<m>.weight_q` int8 (out, in) and `<m>.weight_scale` (out,) ->
    `<m>.weight` f32 = codes x scale (exact); float leaves in f32."""
    out = {}
    for name, value in state.items():
        if name.endswith(".weight_scale"):
            continue
        if name.endswith(".weight_q"):
            prefix = name[: -len("weight_q")]
            scale = state[prefix + "weight_scale"].float()
            out[prefix + "weight"] = value.float() * scale[:, None]
        else:
            out[name] = value.float() if value.is_floating_point() else value
    return out


def _merge_and_dequant(state: Mapping[str, torch.Tensor], lora_scale
                       ) -> Dict[str, torch.Tensor]:
    """Dequantise the int8 weights, then fold the LoRA adapters through
    `models.lora.merge_lora` (one source of the merge's arithmetic)."""
    with _exact_f32():
        return merge_lora(_dequant(state), scale_map=lora_scale)


def _embed_table(state: Mapping[str, torch.Tensor]) -> np.ndarray:
    """The embedding table, dequantised where it is a `QuantEmbed`."""
    if "embed.embedding_q" in state:
        return _np(state["embed.embedding_q"]) * _np(state["embed.scale"])[:, None]
    return _np(state["embed.weight"])


def _layers(state: Mapping, prefix: str) -> List[int]:
    """The indices of the layers `<prefix><i>.` that `state` holds."""
    rx = re.compile(re.escape(prefix) + r"(\d+)\.")
    return sorted({int(m.group(1)) for k in state for m in [rx.match(k)] if m})


def _lin(sd: Dict, name: str, state: Mapping, src: str) -> None:
    sd[f"{name}.weight"] = _np(state[f"{src}.weight"])
    if f"{src}.bias" in state:
        sd[f"{name}.bias"] = _np(state[f"{src}.bias"])


def _lora_scale(config) -> float:
    return config.lora.scale if config.lora is not None else 2.0


def export_hf_phi3(state: Mapping[str, torch.Tensor], config
                   ) -> Dict[str, np.ndarray]:
    """The port's `Phi3ForCausalLM` state -> HF Phi3 state-dict arrays
    (fused qkv_proj / gate_up_proj, per-layer keys). LoRA folded, int8
    dequantised."""
    state = _merge_and_dequant(state, _lora_scale(config))
    sd: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": _embed_table(state),
        "model.norm.weight": _np(state["decoder.norm.weight"]),
    }
    for i in _layers(state, "decoder.layers."):
        src, p = f"decoder.layers.{i}", f"model.layers.{i}"

        def w(name):
            return state[f"{src}.{name}.weight"]

        sd[f"{p}.self_attn.qkv_proj.weight"] = _np(
            torch.cat([w("q_proj"), w("k_proj"), w("v_proj")], dim=0))
        _lin(sd, f"{p}.self_attn.o_proj", state, f"{src}.o_proj")
        sd[f"{p}.mlp.gate_up_proj.weight"] = _np(
            torch.cat([w("gate_proj"), w("up_proj")], dim=0))
        _lin(sd, f"{p}.mlp.down_proj", state, f"{src}.down_proj")
        sd[f"{p}.input_layernorm.weight"] = _np(w("input_norm"))
        sd[f"{p}.post_attention_layernorm.weight"] = _np(w("post_attn_norm"))
    if "lm_head.weight" in state:  # untied checkpoints only
        _lin(sd, "lm_head", state, "lm_head")
    return sd


# the port's module name -> HF Llama's, in each decoder layer
_LLAMA_NAMES = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
                "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
                "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
                "down_proj": "mlp.down_proj"}


def export_hf_llama(state: Mapping[str, torch.Tensor], config
                    ) -> Dict[str, np.ndarray]:
    """The port's `LlamaForCausalLM` state -> HF Llama state-dict arrays
    (separate q/k/v/gate/up). LoRA folded, int8 dequantised."""
    state = _merge_and_dequant(state, _lora_scale(config))
    sd: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": _embed_table(state),
        "model.norm.weight": _np(state["decoder.norm.weight"]),
    }
    for i in _layers(state, "decoder.layers."):
        src, p = f"decoder.layers.{i}", f"model.layers.{i}"
        for ours, theirs in _LLAMA_NAMES.items():
            _lin(sd, f"{p}.{theirs}", state, f"{src}.{ours}")
        sd[f"{p}.input_layernorm.weight"] = _np(state[f"{src}.input_norm.weight"])
        sd[f"{p}.post_attention_layernorm.weight"] = _np(
            state[f"{src}.post_attn_norm.weight"])
    if "lm_head.weight" in state:  # untied checkpoints only
        _lin(sd, "lm_head", state, "lm_head")
    return sd


def _cross_attention(sd: Dict, dst: str, state: Mapping, src: str) -> None:
    """The reference's single-head attention: Wq, Wk, Wv, output_linear and
    a LayerNorm."""
    for theirs, ours in (("Wq", "wq"), ("Wk", "wk"), ("Wv", "wv"),
                         ("output_linear", "out_proj")):
        _lin(sd, f"{dst}.{theirs}", state, f"{src}.{ours}")
    _lin(sd, f"{dst}.norm", state, f"{src}.norm")


def export_reference_vit(state: Mapping[str, torch.Tensor], prefix: str = "",
                         slice_guided: bool = False) -> Dict[str, np.ndarray]:
    """The port's `ViT3D` state -> MONAI-style tower state-dict arrays (the
    stage-1/2 CLIP checkpoint's vision keys; inverse of
    `convert_reference_vit`)."""

    def k(name):
        return f"{prefix}{name}"

    sd: Dict[str, np.ndarray] = {}
    _lin(sd, k("patch_embedding.patch_embeddings.1"), state, "patch_embed.proj")
    sd[k("patch_embedding.position_embeddings")] = _np(
        state["patch_embed.pos_embed"])
    sd[k("cls_token")] = _np(state["cls_token"])
    for i in _layers(state, "tower.blocks."):
        b, t = k(f"blocks.{i}"), f"tower.blocks.{i}"
        _lin(sd, f"{b}.norm1", state, f"{t}.norm1")
        _lin(sd, f"{b}.attn.qkv", state, f"{t}.attn.qkv")
        _lin(sd, f"{b}.attn.out_proj", state, f"{t}.attn.out_proj")
        _lin(sd, f"{b}.norm2", state, f"{t}.norm2")
        _lin(sd, f"{b}.mlp.linear1", state, f"{t}.mlp.fc1")
        _lin(sd, f"{b}.mlp.linear2", state, f"{t}.mlp.fc2")
    _lin(sd, k("norm"), state, "tower.norm")
    if slice_guided:
        _cross_attention(sd, k("slice_guided_attention"), state,
                         "slice_guided_attention")
        _lin(sd, k("patch_score_proj"), state, "patch_score_proj")
    return sd


def export_reference_packer(state: Mapping[str, torch.Tensor],
                            prefix: str = "mm_projector."
                            ) -> Dict[str, np.ndarray]:
    """The port's `VisualPacker` state -> `VisualPacker_3d_phi_v3`
    state-dict arrays (inverse of `convert_reference_packer`)."""
    sd: Dict[str, np.ndarray] = {}
    _cross_attention(sd, f"{prefix}resolution_attention", state,
                     "resolution_attention")
    _lin(sd, f"{prefix}proj_mpls.0", state, "proj_fc1")
    _lin(sd, f"{prefix}proj_mpls.2", state, "proj_fc2")
    return sd


def to_torch_state_dict(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """numpy export -> {name: torch.Tensor} for torch.save /
    load_state_dict."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _subtree(state: Mapping, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def _blockdiag(mats: List[np.ndarray]) -> np.ndarray:
    out = np.zeros((sum(m.shape[0] for m in mats), sum(m.shape[1] for m in mats)),
                   np.float32)
    r0 = c0 = 0
    for m in mats:
        out[r0:r0 + m.shape[0], c0:c0 + m.shape[1]] = m
        r0 += m.shape[0]
        c0 += m.shape[1]
    return out


def export_reference_vlm_deltas(
    state: Mapping[str, torch.Tensor],
    prefix: str = "base_model.model.model.",
) -> Dict[str, np.ndarray]:
    """`HSENetVLM` state (whole, or the `save_vlm_deltas` subset) -> the
    reference's VLM-delta file contents (`LaMedTrainer._save`,
    lamed_trainer.py:20-24: every named parameter containing 'mm_projector'
    or 'lora', peft naming).

    The reference applies peft to the FUSED HF modules (qkv_proj,
    gate_up_proj; find_all_linear_names, eval_HSENet_CT_Rate_MRG.py:198),
    while the port adapts q/k/v separately. The export fuses them exactly
    by block-diagonal composition: for qkv,
        lora_A' = [A_q; A_k; A_v]            (3r, hidden)
        lora_B' = blockdiag(B_q, B_k, B_v)   (q + 2kv, 3r)
    so B'A'x == concat(B_q A_q x, B_k A_k x, B_v A_v x), the same delta at
    rank 3r (2r for gate_up). peft's per-module scale alpha / rank would
    shrink by the rank ratio, so that ratio is baked into lora_B'; load with
        LoraConfig(r=R, lora_alpha=ALPHA,
                   rank_pattern={"qkv_proj": 3*R, "gate_up_proj": 2*R})
    and `model.load_state_dict(deltas, strict=False)` reproduces this
    model's LoRA deltas exactly."""
    sd: Dict[str, np.ndarray] = {}
    sd.update(export_reference_packer(_subtree(state, "mm_projector."),
                                      prefix=f"{prefix}mm_projector."))
    if any(k.startswith("mm_projector2.") for k in state):
        sd.update(export_reference_packer(_subtree(state, "mm_projector2."),
                                          prefix=f"{prefix}mm_projector2."))

    def a_t(src, name):  # peft lora_A.weight layout: (r, in)
        return _np(state[f"{src}.{name}.lora_a"]).T

    def b_t(src, name):  # peft lora_B.weight layout: (out, r)
        return _np(state[f"{src}.{name}.lora_b"]).T

    for i in _layers(state, "llm.decoder.layers."):
        src = f"llm.decoder.layers.{i}"
        if f"{src}.q_proj.lora_a" not in state:
            continue  # a base LLM trained without adapters
        p = f"{prefix}layers.{i}"
        # qkv: rank 3r, the rank ratio 3 baked into B'
        sd[f"{p}.self_attn.qkv_proj.lora_A.default.weight"] = np.concatenate(
            [a_t(src, n) for n in ("q_proj", "k_proj", "v_proj")], axis=0)
        sd[f"{p}.self_attn.qkv_proj.lora_B.default.weight"] = 3.0 * _blockdiag(
            [b_t(src, n) for n in ("q_proj", "k_proj", "v_proj")])
        # gate_up: rank 2r, ratio 2
        sd[f"{p}.mlp.gate_up_proj.lora_A.default.weight"] = np.concatenate(
            [a_t(src, n) for n in ("gate_proj", "up_proj")], axis=0)
        sd[f"{p}.mlp.gate_up_proj.lora_B.default.weight"] = 2.0 * _blockdiag(
            [b_t(src, n) for n in ("gate_proj", "up_proj")])
        # 1:1 modules
        for name, module in (("o_proj", "self_attn.o_proj"),
                             ("down_proj", "mlp.down_proj")):
            sd[f"{p}.{module}.lora_A.default.weight"] = a_t(src, name)
            sd[f"{p}.{module}.lora_B.default.weight"] = b_t(src, name)
    return sd
