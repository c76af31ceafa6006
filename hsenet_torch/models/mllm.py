"""HSENet VLM (the port of the JAX package's models/mllm.py): dual vision towers +
dual spatial packers + Phi LLM.

  * `encode_images`: dual tower -> per-stream packer (`mm_projector`,
    `mm_projector2`) -> concat = 256 image tokens. With
    `online_slice_features` and no slice features given, the frozen 2D
    trunk (`slice_encoder`, `models.vit.OnlineSliceFeatures`) computes them
    from the volume first, without gradients.
  * `multimodal_embeds`: embed the token ids, then splice the image
    features over the placeholder block right after BOS.
  * `forward`: the training/eval forward, logits over the whole sequence;
    with `stop_tower_gradients` the towers run under `torch.no_grad()`
    (the JAX package's `stop_gradient` on their features).
  * `prefill` / `decode_step`: generation through `Phi3ForCausalLM` and a
    KV cache.
  * `encode_images_only` / `prefill_with_features` / `prefill_continue`:
    the serving engine's split admission: the towers once per volume, the
    splice and LLM prefill per question, or only the question chunk over a
    cache row that already holds the BOS + image-block keys and values.

  * `forward_with_seg` (with `seg_enable`): the LM logits and SegVol's
    logits prompted by the hidden states before the [SEG] tokens, through
    `seg_projector` (`seg_module` is SegVol on `seg_vision`, or on the
    vision config without CLS).

tower_mode 'med2e3' runs the plain 3D tower; its projector
(`Med2E3Projector`) takes the tower's tokens, the raw slice features and
the prompt's token embeddings, so its image features depend on the prompt
and `encode_images_only` refuses it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.configs import ViT2DConfig, VLMConfig
from hsenet_torch.models.layers import Dense, dropout
from hsenet_torch.models.phi3 import KVCache, Phi3ForCausalLM
from hsenet_torch.models.projector import Med2E3Projector, build_projector
from hsenet_torch.models.segvol import SegVol
from hsenet_torch.models.vit import DualVisionTower, OnlineSliceFeatures
from hsenet_torch.utils.profiling import span


def splice_image_embeds(token_embeds: torch.Tensor,
                        image_feats: torch.Tensor) -> torch.Tensor:
    """Overwrite the placeholder block right after BOS with image features
    (the datasets place the image tokens at positions 1..n_img)."""
    n_img = image_feats.shape[1]
    return torch.cat(
        [token_embeds[:, :1], image_feats.to(token_embeds.dtype),
         token_embeds[:, 1 + n_img:]],
        dim=1,
    )


class SegProjector(nn.Module):
    """Linear-ReLU-Linear from the LLM width to the vision width
    (lamed_arch.py:91-96; the trailing Dropout(0.1) is applied by
    `HSENetVLM.forward_with_seg`). The layers keep the names flax's
    `nn.Sequential` gives them."""

    def __init__(self, in_dim: int, out_dim: int, *, dtype, device):
        super().__init__()
        self.layers_0 = Dense(in_dim, in_dim, dtype=dtype, device=device)
        self.layers_2 = Dense(in_dim, out_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_2(F.relu(self.layers_0(x)))


class HSENetVLM(nn.Module):
    def __init__(self, config: VLMConfig, *, dtype=torch.bfloat16,
                 device="cuda", remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        med2e3 = config.tower_mode == "med2e3"
        self.vision_tower = DualVisionTower(
            config.vision, tower_mode="3d_vit" if med2e3 else config.tower_mode,
            select_feature=config.select_feature, dtype=dtype, device=device,
        )
        if med2e3:
            self.mm_projector = Med2E3Projector(
                config.packer, num_slices=config.vision.num_slices,
                slice_dim=config.vision.slice_feature_dim, dtype=dtype,
                device=device)
        else:
            self.mm_projector = build_projector(config.packer, dtype=dtype,
                                                device=device)
        self.mm_projector2 = None
        if config.tower_mode == "dual_vits" and config.use_parallel_projector:
            self.mm_projector2 = build_projector(config.packer, dtype=dtype,
                                                 device=device)
        self.llm = Phi3ForCausalLM(config.llm, dtype=dtype, device=device,
                                   remat=remat)
        self.slice_encoder = None
        if config.online_slice_features:
            self.slice_encoder = OnlineSliceFeatures(
                config.vit2d or ViT2DConfig(),
                num_slices=config.vision.num_slices, dtype=dtype, device=device,
            )
        if config.seg_enable:
            seg_cfg = config.seg_vision or dataclasses.replace(
                config.vision, classification=False)
            self.seg_module = SegVol(seg_cfg, dtype=dtype, device=device)
            self.seg_projector = SegProjector(
                config.llm.hidden_size, config.vision.hidden_size, dtype=dtype,
                device=device)
            self.seg_dropout_rate = 0.1  # the reference's fixed Dropout(0.1)

    def encode_images(self, volume: torch.Tensor,
                      slice_features: Optional[torch.Tensor] = None, *,
                      text_embeds: Optional[torch.Tensor] = None,
                      deterministic: bool = True) -> torch.Tensor:
        """Towers + projectors -> (B, n_img, llm_hidden). med2e3 also reads
        `text_embeds`, the prompt's token embeddings."""
        if slice_features is None and self.slice_encoder is not None:
            width = self.slice_encoder.config.hidden_size
            if width != self.config.vision.hidden_size:
                raise ValueError(
                    f"the 2D trunk's features ({width} wide) do not fit the "
                    f"2E3 tower's cross-attention ({self.config.vision.hidden_size})")
            with span("model.vision"), torch.no_grad():  # the frozen trunk
                slice_features = self.slice_encoder(volume,
                                                    deterministic=deterministic)
        with span("model.vision"), torch.set_grad_enabled(
            torch.is_grad_enabled() and not self.config.stop_tower_gradients
        ):
            feats = self.vision_tower(volume, slice_features,
                                      deterministic=deterministic)
        with span("model.projector"):
            if self.config.tower_mode == "dual_vits":
                f1, f2 = feats
                proj2 = self.mm_projector2 or self.mm_projector
                return torch.cat([
                    self.mm_projector(f1, deterministic=deterministic),
                    proj2(f2, deterministic=deterministic),
                ], dim=1)
            if self.config.tower_mode == "med2e3":
                return self.mm_projector(feats, slice_features, text_embeds,
                                         deterministic=deterministic)
            return self.mm_projector(feats, deterministic=deterministic)

    def multimodal_embeds(self, input_ids: torch.Tensor,
                          volume: Optional[torch.Tensor],
                          slice_features: Optional[torch.Tensor] = None, *,
                          deterministic: bool = True) -> torch.Tensor:
        embeds = self.llm.embed_tokens(input_ids)
        if volume is None:
            return embeds
        return splice_image_embeds(
            embeds, self.encode_images(volume, slice_features,
                                       text_embeds=embeds,
                                       deterministic=deterministic)
        )

    def forward(self, input_ids: torch.Tensor,
                volume: Optional[torch.Tensor] = None,
                slice_features: Optional[torch.Tensor] = None, *,
                kv_lens: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        """Training/eval forward: logits (B, S, V). Dropout (deterministic
        False) draws from the generator of `models.layers.dropout_rng`."""
        embeds = self.multimodal_embeds(input_ids, volume, slice_features,
                                        deterministic=deterministic)
        logits, _ = self.llm.decode_embeds(embeds, kv_lens=kv_lens,
                                           deterministic=deterministic)
        return logits

    def prefill(self, input_ids: torch.Tensor, volume: Optional[torch.Tensor],
                slice_features: Optional[torch.Tensor], cache: KVCache,
                kv_lens: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """Generation prefill: (last-valid-token logits (B, V), cache)."""
        embeds = self.multimodal_embeds(input_ids, volume, slice_features)
        logits, cache = self.llm.decode_embeds(
            embeds, kv_lens=kv_lens, cache=cache, last_token_only=True
        )
        return logits[:, 0], cache

    def encode_images_only(self, volume: torch.Tensor,
                           slice_features: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """Vision side alone: towers + packers -> (B, n_img, llm_hidden),
        the prompt-independent part of a multimodal prefill that the
        serving engine keeps per volume. Not for tower_mode 'med2e3',
        whose projector reads the prompt."""
        if self.config.tower_mode == "med2e3":
            raise ValueError(
                "med2e3 image features depend on the prompt; they cannot "
                "be cached per volume"
            )
        return self.encode_images(volume, slice_features, deterministic=True)

    def prefill_with_features(self, input_ids: torch.Tensor,
                              image_feats: torch.Tensor, cache: KVCache,
                              kv_lens: torch.Tensor
                              ) -> Tuple[torch.Tensor, KVCache]:
        """Prefill from precomputed image features: splice + LLM only.
        Composes with `encode_images_only` to what `prefill` computes."""
        embeds = splice_image_embeds(self.llm.embed_tokens(input_ids),
                                     image_feats)
        logits, cache = self.llm.decode_embeds(
            embeds, kv_lens=kv_lens, cache=cache, last_token_only=True
        )
        return logits[:, 0], cache

    def prefill_continue(self, input_ids: torch.Tensor, cache: KVCache,
                         kv_lens: torch.Tensor
                         ) -> Tuple[torch.Tensor, KVCache]:
        """Text-only continuation prefill: append a question chunk to a
        cache row that already holds the prompt prefix. `kv_lens` counts
        the new valid tokens of `input_ids`; positions and the causal mask
        continue from `cache.lengths`. No splice: the chunk lies past the
        image block."""
        logits, cache = self.llm.decode_embeds(
            self.llm.embed_tokens(input_ids), kv_lens=kv_lens, cache=cache,
            last_token_only=True,
        )
        return logits[:, 0], cache

    def decode_step(self, token: torch.Tensor,
                    cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
        """One decode step: token (B, 1) -> (logits (B, V), cache)."""
        embeds = self.llm.embed_tokens(token)
        logits, cache = self.llm.decode_embeds(embeds, cache=cache)
        return logits[:, 0], cache

    def forward_with_seg(self, input_ids: torch.Tensor, volume: torch.Tensor,
                         slice_features: Optional[torch.Tensor] = None, *,
                         kv_lens: Optional[torch.Tensor] = None,
                         deterministic: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(LM logits (B, S, V), SegVol logits (B, 1, D, H, W) f32), SegVol
        prompted by the [SEG] tokens (lamed_phi3.py:87-135): the hidden
        states at the positions just before each [SEG] token, mean-pooled
        per row, through `seg_projector` and dropout (`seg_dropout_rate`,
        0.1). A row without
        [SEG] prompts with zeros (its seg loss is gated by the caller)."""
        if not self.config.seg_enable:
            raise ValueError("the seg branch is disabled in the config")
        embeds = self.multimodal_embeds(input_ids, volume, slice_features,
                                        deterministic=deterministic)
        logits, _, hidden = self.llm.decode_embeds(
            embeds, kv_lens=kv_lens, deterministic=deterministic,
            return_hidden=True)
        # position t where token t + 1 is [SEG] (shifted left, zero tail)
        is_seg = input_ids == self.config.seg_token_id
        mask = torch.cat([is_seg[:, 1:], torch.zeros_like(is_seg[:, :1])],
                         dim=1).to(hidden.dtype)
        denom = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
        pooled = torch.einsum("bs,bsh->bh", mask / denom, hidden)
        prompt = dropout(self.seg_projector(pooled), self.seg_dropout_rate,
                         deterministic)
        prompt = torch.where((mask.sum(dim=1) > 0)[:, None], prompt,
                             torch.zeros((), dtype=prompt.dtype,
                                         device=prompt.device))
        return logits, self.seg_module(volume, text_embedding=prompt)

    def verify_step(self, tokens: torch.Tensor, cache: KVCache,
                    kv_lens: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """Multi-token decode for speculative verification: tokens (B, K)
        -> (logits (B, K, V), cache), through the chunked-prefill path
        (per-row causal offsets over the cache), so that one forward
        scores K draft positions (`eval/speculative.py`)."""
        embeds = self.llm.embed_tokens(tokens)
        return self.llm.decode_embeds(embeds, kv_lens=kv_lens, cache=cache)
