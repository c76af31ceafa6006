"""Weight converters of the port (the port of the JAX package's
utils/convert.py): reference PyTorch state dicts -> the port's state dicts,
and the one-call serving prep of the W8A8 encode mode.

Covers the reference's persisted artifacts:
  * stage-1/stage-2 CLIP checkpoints (`M3DCLIP_stage{1,2}` HF
    save_pretrained): MONAI-block ViT towers + HF BERT + projections +
    logit_scale;
  * VLM deltas (`LaMedTrainer._save` keeps only mm_projector* + lora*,
    lamed_trainer.py:20-24);
  * Phi/BERT base weights (`models.phi3.convert_hf_phi3`,
    `models.bert.convert_hf_bert`);
  * the BiomedCLIP 2D trunk (open_clip's `visual.trunk`, timm ViT-B/16
    names), `convert_biomedclip_vit2d`.

The port's modules keep the reference's (out, in) Linear layout, so a
converter renames keys and casts to f32; nothing is transposed (the 2D
trunk's patch conv is flattened into its matmul weight). Every
output equals the JAX converter's tree carried over by
`hsenet_torch.bridge.flax_to_torch`, key for key and bit for bit.

MONAI key facts (monai 1.3 blocks, as instantiated at vit.py:287-306):
  patch_embedding.patch_embeddings.1.{weight,bias}   (Sequential: Rearrange, Linear)
  patch_embedding.position_embeddings
  cls_token
  blocks.{i}.norm1/norm2.{weight,bias}
  blocks.{i}.attn.qkv.weight            (3h, h), qkv-major packing
  blocks.{i}.attn.out_proj.{weight,bias}
  blocks.{i}.mlp.linear1/linear2.{weight,bias}
  norm.{weight,bias}
The port's fused qkv projection splits its output features qkv-major,
head-major, as MONAI packs them, and its patch embedding flattens each
patch's pixels in MONAI's (p1 p2 p3 c) order, so both weights carry over
as they are.
Stage-2 extras (vit.py:330-340): slice_guided_attention.{Wq,Wk,Wv,
  output_linear,norm}, patch_score_proj.
Packer keys (spatial_pooling_projector.py:121-153): resolution_attention.
  {Wq,Wk,Wv,output_linear,norm}, proj_mpls.{0,2}.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from hsenet_torch.models.clip import CLIPModel
from hsenet_torch.models.lora import (
    calibrate_w8a8_act_scales,
    quantize_towers_w8a8,
)


def as_f32(w) -> torch.Tensor:
    """A reference leaf (torch tensor or array) as an f32 host tensor."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(w, dtype=np.float32))


def _lin(sd: Mapping, src: str, dst: str) -> Dict[str, torch.Tensor]:
    """A Linear's weight (and its bias where the source has one)."""
    out = {f"{dst}.weight": as_f32(sd[f"{src}.weight"])}
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = as_f32(sd[f"{src}.bias"])
    return out


def _ln(sd: Mapping, src: str, dst: str) -> Dict[str, torch.Tensor]:
    return {f"{dst}.weight": as_f32(sd[f"{src}.weight"]),
            f"{dst}.bias": as_f32(sd[f"{src}.bias"])}


def _cross_attention(sd: Mapping, src: str, dst: str) -> Dict[str, torch.Tensor]:
    """The reference's single-head `regular_attention` / resolution
    attention: Wq, Wk, Wv, output_linear and a LayerNorm."""
    out = {}
    for a, b in (("Wq", "wq"), ("Wk", "wk"), ("Wv", "wv"),
                 ("output_linear", "out_proj")):
        out.update(_lin(sd, f"{src}.{a}", f"{dst}.{b}"))
    out.update(_ln(sd, f"{src}.norm", f"{dst}.norm"))
    return out


def convert_reference_vit(sd: Mapping, num_layers: int = 12, prefix: str = "",
                          slice_guided: bool = False) -> Dict[str, torch.Tensor]:
    """MONAI-style ViT tower state dict -> the port's `ViT3D` state dict."""

    def k(name):
        return f"{prefix}{name}"

    out = {}
    out.update(_lin(sd, k("patch_embedding.patch_embeddings.1"),
                    "patch_embed.proj"))
    out["patch_embed.pos_embed"] = as_f32(
        sd[k("patch_embedding.position_embeddings")])
    out["cls_token"] = as_f32(sd[k("cls_token")])
    for i in range(num_layers):
        b, t = k(f"blocks.{i}"), f"tower.blocks.{i}"
        out.update(_ln(sd, f"{b}.norm1", f"{t}.norm1"))
        out.update(_lin(sd, f"{b}.attn.qkv", f"{t}.attn.qkv"))
        out.update(_lin(sd, f"{b}.attn.out_proj", f"{t}.attn.out_proj"))
        out.update(_ln(sd, f"{b}.norm2", f"{t}.norm2"))
        out.update(_lin(sd, f"{b}.mlp.linear1", f"{t}.mlp.fc1"))
        out.update(_lin(sd, f"{b}.mlp.linear2", f"{t}.mlp.fc2"))
    out.update(_ln(sd, k("norm"), "tower.norm"))
    if slice_guided:
        out.update(_cross_attention(sd, k("slice_guided_attention"),
                                    "slice_guided_attention"))
        out.update(_lin(sd, k("patch_score_proj"), "patch_score_proj"))
    return out


def convert_reference_clip(sd: Mapping, num_layers: int = 12,
                           slice_guided: bool = False) -> Dict[str, torch.Tensor]:
    """`M3DCLIP_stage{1,2}` state dict -> the port's `CLIPModel` state dict.

    For stage-2 checkpoints pass slice_guided=True; the frozen
    stage1_pretrained_CLIP teacher entries are converted separately by
    calling this again on the `stage1_pretrained_CLIP.`-prefixed subset
    (`extract_subtree`)."""
    from hsenet_torch.configs import BertConfig
    from hsenet_torch.models.bert import convert_hf_bert

    out = {f"vision_encoder.{k}": v for k, v in convert_reference_vit(
        sd, num_layers, prefix="vision_encoder.",
        slice_guided=slice_guided).items()}
    bert = convert_hf_bert(extract_subtree(sd, "language_encoder."),
                           BertConfig(num_layers=num_layers))
    out.update({f"language_encoder.{k}": v for k, v in bert.items()})
    out.update(_lin(sd, "mm_vision_proj", "mm_vision_proj"))
    out.update(_lin(sd, "mm_language_proj", "mm_language_proj"))
    out["logit_scale"] = as_f32(sd["logit_scale"]).reshape(())
    return out


def convert_reference_packer(sd: Mapping, prefix: str = "mm_projector."
                             ) -> Dict[str, torch.Tensor]:
    """`VisualPacker_3d_phi_v3` weights -> the port's `VisualPacker` state
    dict."""
    out = _cross_attention(sd, f"{prefix}resolution_attention",
                           "resolution_attention")
    out.update(_lin(sd, f"{prefix}proj_mpls.0", "proj_fc1"))
    out.update(_lin(sd, f"{prefix}proj_mpls.2", "proj_fc2"))
    return out


def convert_biomedclip_vit2d(sd: Mapping, num_layers: int = 12
                             ) -> Dict[str, torch.Tensor]:
    """timm/open_clip ViT-B/16 trunk state dict (`visual.trunk.` taken off)
    -> the port's `ViT2D` state dict.

    The reference extracts slice features with open_clip BiomedCLIP's
    `model.visual.trunk` (CT-RATE_2D_to_npy_file.py:88). Trunk keys:
    patch_embed.proj (a 16x16 conv), cls_token, pos_embed, norm_pre,
    blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}, norm. The
    conv's (out, c, p1, p2) weight becomes the (out, p1 p2 c) matmul weight
    of `PatchEmbed2D` (patch pixels row-major, channel last); timm's
    norm_pre is Identity for ViT-B/16 (BiomedCLIP included), so an absent
    one becomes the identity LayerNorm (weight 1, bias 0)."""
    conv = as_f32(sd["patch_embed.proj.weight"])  # (768, 3, 16, 16)
    hidden = conv.shape[0]
    out = {"patch_embed.proj.weight": conv.permute(0, 2, 3, 1).reshape(hidden, -1),
           "patch_embed.proj.bias": as_f32(sd["patch_embed.proj.bias"]),
           "cls_token": as_f32(sd["cls_token"]),
           "pos_embed": as_f32(sd["pos_embed"])}
    if "norm_pre.weight" in sd:
        out.update(_ln(sd, "norm_pre", "norm_pre"))
    else:
        out.update({"norm_pre.weight": torch.ones(hidden),
                    "norm_pre.bias": torch.zeros(hidden)})
    for i in range(num_layers):
        b, t = f"blocks.{i}", f"tower.blocks.{i}"
        out.update(_ln(sd, f"{b}.norm1", f"{t}.norm1"))
        out.update(_lin(sd, f"{b}.attn.qkv", f"{t}.attn.qkv"))
        out.update(_lin(sd, f"{b}.attn.proj", f"{t}.attn.out_proj"))
        out.update(_ln(sd, f"{b}.norm2", f"{t}.norm2"))
        out.update(_lin(sd, f"{b}.mlp.fc1", f"{t}.mlp.fc1"))
        out.update(_lin(sd, f"{b}.mlp.fc2", f"{t}.mlp.fc2"))
    out.update(_ln(sd, "norm", "tower.norm"))
    return out


def extract_subtree(sd: Mapping, prefix: str) -> Dict:
    """The entries of `sd` under `prefix`, with the prefix taken off."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def graft_params(dst: Dict, src: Mapping, path: str = "") -> Dict:
    """Copy the entries of `src` into the state dict `dst` (in place, and
    returned), each over an existing entry of the same shape: loads
    converted reference weights into a freshly initialised model's state,
    name-addressed and shape-checked (the reference copies in key order,
    train_VLM.py:477-503)."""
    for key, val in src.items():
        if key not in dst:
            raise KeyError(f"graft: {path}{key} missing in destination")
        if tuple(np.shape(dst[key])) != tuple(np.shape(val)):
            raise ValueError(f"graft: {path}{key} shape {tuple(np.shape(val))} "
                             f"!= dest {tuple(np.shape(dst[key]))}")
        dst[key] = val
    return dst


def quantize_clip_w8a8(state: Dict[str, torch.Tensor], config, *,
                       volumes: Optional[np.ndarray] = None,
                       slice_features: Optional[np.ndarray] = None,
                       batch_size: int = 2, seed: int = 0
                       ) -> Dict[str, torch.Tensor]:
    """A float CLIP state_dict -> the state of the W8A8 serving encode mode:
    the vision tower's block kernels int8 with per-output-channel scales,
    and each block dense's static activation scale calibrated by one bf16
    `encode_image` pass. Text and projection weights are returned as given.

    `volumes` default to unit-range noise from `seed` (preprocessed CT is
    min-max normalised to [0, 1], so noise bounds the input range); the
    2E3 tower's slice features likewise. The result loads strictly into
    `CLIPModel` with `vision=ViT3DConfig(quant_w8a8=True,
    quant_w8a8_static=True)`, on the device the state's tensors lie on.

    Unlike the JAX converter, the slice-guided cross-attention's `out_proj`
    stays float (there `quantize_kernels_int8` converts it by name, and the
    calibration pass then draws it anew)."""
    quantized = quantize_towers_w8a8(state, static=True)
    device = next(iter(state.values())).device
    vision = dataclasses.replace(config.vision, quant_w8a8=True,
                                 quant_w8a8_static=True)
    model = CLIPModel(dataclasses.replace(config, vision=vision),
                      dtype=torch.bfloat16, device=device)
    model.load_state_dict(quantized, strict=True)
    model.eval()
    rng = np.random.default_rng(seed)
    if volumes is None:
        volumes = rng.random(
            (batch_size, vision.in_channels, *vision.image_size), np.float32)
    batch = (torch.as_tensor(np.asarray(volumes, np.float32), device=device)
             .to(torch.bfloat16),)
    if vision.slice_guided:
        if slice_features is None:
            slice_features = rng.random(
                (batch[0].shape[0], vision.num_slices,
                 vision.slice_feature_dim), np.float32)
        batch += (torch.as_tensor(np.asarray(slice_features, np.float32),
                                  device=device),)
    calibrate_w8a8_act_scales(model, [batch], fn=model.encode_image)
    scales = {name: value.detach().clone()
              for name, value in model.state_dict().items()
              if name.endswith(".act_scale")}
    return {**quantized, **scales}
