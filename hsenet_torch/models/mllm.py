"""HSENet VLM (the port of the JAX package's models/mllm.py): dual vision towers +
dual spatial packers + Phi LLM.

  * `encode_images`: dual tower -> per-stream packer (`mm_projector`,
    `mm_projector2`) -> concat = 256 image tokens.
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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.configs import VLMConfig
from hsenet_torch.models.phi3 import KVCache, Phi3ForCausalLM
from hsenet_torch.models.projector import build_projector
from hsenet_torch.models.vit import DualVisionTower


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


class HSENetVLM(nn.Module):
    def __init__(self, config: VLMConfig, *, dtype=torch.bfloat16,
                 device="cuda", remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        for flag, what in (
            (config.tower_mode == "med2e3", "tower_mode 'med2e3'"),
            (config.seg_enable, "the SegVol branch"),
            (config.online_slice_features, "in-graph slice features"),
        ):
            if flag:
                raise NotImplementedError(f"{what} comes with a later slice of the port")
        self.config = config
        self.vision_tower = DualVisionTower(
            config.vision, tower_mode=config.tower_mode,
            select_feature=config.select_feature, dtype=dtype, device=device,
        )
        self.mm_projector = build_projector(config.packer, dtype=dtype,
                                            device=device)
        self.mm_projector2 = None
        if config.tower_mode == "dual_vits" and config.use_parallel_projector:
            self.mm_projector2 = build_projector(config.packer, dtype=dtype,
                                                 device=device)
        self.llm = Phi3ForCausalLM(config.llm, dtype=dtype, device=device,
                                   remat=remat)

    def encode_images(self, volume: torch.Tensor,
                      slice_features: Optional[torch.Tensor] = None, *,
                      deterministic: bool = True) -> torch.Tensor:
        with torch.set_grad_enabled(
            torch.is_grad_enabled() and not self.config.stop_tower_gradients
        ):
            feats = self.vision_tower(volume, slice_features,
                                      deterministic=deterministic)
        if self.config.tower_mode == "dual_vits":
            f1, f2 = feats
            proj2 = self.mm_projector2 or self.mm_projector
            return torch.cat([
                self.mm_projector(f1, deterministic=deterministic),
                proj2(f2, deterministic=deterministic),
            ], dim=1)
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
        serving engine keeps per volume."""
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

    def verify_step(self, tokens: torch.Tensor, cache: KVCache,
                    kv_lens: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
        """Multi-token decode for speculative verification: tokens (B, K)
        -> (logits (B, K, V), cache), through the chunked-prefill path
        (per-row causal offsets over the cache), so that one forward
        scores K draft positions (`eval/speculative.py`)."""
        embeds = self.llm.embed_tokens(tokens)
        return self.llm.decode_embeds(embeds, kv_lens=kv_lens, cache=cache)
