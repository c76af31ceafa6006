"""Dual-encoder CLIP of the pretraining stages (the port of the JAX
package's models/clip.py): stage 1 pairs the 3D ViT with BERT, stage 2
(`config.vision.slice_guided=True`) the 2E3 tower with BERT.

Each encoder takes its CLS token, projects it (`mm_vision_proj`,
`mm_language_proj`) and L2-normalises it, in the compute dtype as the JAX
package does. `logit_scale` is an f32 parameter initialised to log(1/0.07)
and, unless `scale_is_log`, multiplied in raw form (the reference's quirk).

In stage 2 the frozen stage-1 teacher is a second `CLIPModel` whose
parameters do not require grad (`train/stage2.py`). `MaskedCLIPModel` is
the legacy masked-contrastive CLIP (`train/legacy_clip.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.configs import CLIPConfig
from hsenet_torch.models.bert import BertEncoder
from hsenet_torch.models.layers import Dense
from hsenet_torch.models.vit import MaskedViT3D, ViT3D
from hsenet_torch.utils.profiling import span


def _l2_normalise(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class CLIPModel(nn.Module):
    """Stage-1 or stage-2 CLIP depending on `config.vision.slice_guided`;
    `remat` recomputes each vision block in the backward pass."""

    def __init__(self, config: CLIPConfig, *, dtype=torch.float32,
                 remat: bool = False, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.vision_encoder = ViT3D(cfg.vision, dtype=dtype, device=device,
                                    remat=remat)
        self.language_encoder = BertEncoder(cfg.text, dtype=dtype,
                                            device=device)
        self.mm_vision_proj = Dense(cfg.vision.hidden_size, cfg.projection_dim,
                                    dtype=dtype, device=device)
        self.mm_language_proj = Dense(cfg.text.hidden_size, cfg.projection_dim,
                                      dtype=dtype, device=device)
        self.logit_scale = nn.Parameter(torch.tensor(
            cfg.logit_scale_init, dtype=torch.float32, device=device))

    def encode_image(self, volume: torch.Tensor,
                     slice_features: Optional[torch.Tensor] = None, *,
                     deterministic: bool = True,
                     pooled: bool = True) -> torch.Tensor:
        """(B, projection_dim) L2-normalised image features (every token's
        with `pooled=False`)."""
        with span("model.vision"):
            feats = self.vision_encoder(volume, slice_features,
                                        deterministic=deterministic)
            if pooled:
                feats = feats[:, 0]  # CLS
            return _l2_normalise(self.mm_vision_proj(feats))

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None, *,
                    deterministic: bool = True, pooled: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(projected + normalised features, raw last_hidden_state)."""
        with span("model.text"):
            hidden = self.language_encoder(input_ids, attention_mask,
                                           deterministic=deterministic)
            feats = hidden[:, 0] if pooled else hidden
            return _l2_normalise(self.mm_language_proj(feats)), hidden

    def scale(self) -> torch.Tensor:
        s = self.logit_scale
        return torch.exp(s) if self.config.scale_is_log else s

    def forward(self, volume: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                slice_features: Optional[torch.Tensor] = None, *,
                deterministic: bool = True):
        """(image_features, text_features, logit_scale)."""
        text_features, _ = self.encode_text(input_ids, attention_mask,
                                            deterministic=deterministic)
        image_features = self.encode_image(volume, slice_features,
                                           deterministic=deterministic)
        return image_features, text_features, self.scale()


class MaskedCLIPModel(nn.Module):
    """The legacy masked-contrastive CLIP (the reference's `M3DCLIP`,
    model/CLIP.py): `MaskedViT3D` gives the full and the masked stream, each
    projected from its CLS token by the shared `mm_vision_proj`, beside BERT
    and `mm_language_proj`. Returns (img_f, img_f_masked, txt_f, scale),
    or (img_f, txt_f, scale) without `unmasked_tokens`."""

    def __init__(self, config: CLIPConfig, *, dtype=torch.float32,
                 remat: bool = False, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.vision_encoder = MaskedViT3D(cfg.vision, dtype=dtype,
                                          device=device, remat=remat)
        self.language_encoder = BertEncoder(cfg.text, dtype=dtype,
                                            device=device)
        self.mm_vision_proj = Dense(cfg.vision.hidden_size, cfg.projection_dim,
                                    dtype=dtype, device=device)
        self.mm_language_proj = Dense(cfg.text.hidden_size, cfg.projection_dim,
                                      dtype=dtype, device=device)
        self.logit_scale = nn.Parameter(torch.tensor(
            cfg.logit_scale_init, dtype=torch.float32, device=device))

    def _proj_norm(self, feats: torch.Tensor) -> torch.Tensor:
        return _l2_normalise(self.mm_vision_proj(feats[:, 0]))

    def scale(self) -> torch.Tensor:
        s = self.logit_scale
        return torch.exp(s) if self.config.scale_is_log else s

    def forward(self, volume: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                slice_features: Optional[torch.Tensor] = None,
                unmasked_tokens: Optional[int] = None, *,
                deterministic: bool = True):
        hidden = self.language_encoder(input_ids, attention_mask,
                                       deterministic=deterministic)
        txt = _l2_normalise(self.mm_language_proj(hidden[:, 0]))
        if unmasked_tokens is None:
            full = self.vision_encoder(volume, slice_features,
                                       deterministic=deterministic)
            return self._proj_norm(full), txt, self.scale()
        full, masked = self.vision_encoder(volume, slice_features,
                                           unmasked_tokens,
                                           deterministic=deterministic)
        return (self._proj_norm(full), self._proj_norm(masked), txt,
                self.scale())
