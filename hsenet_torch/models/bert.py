"""BERT text encoder of the CLIP stages (the port of the JAX package's
models/bert.py): bert-base-uncased's architecture, post-LN, exact erf GELU.

The right-padded attention mask is reduced to per-row valid lengths and
handed to `multi_head_attention` as `kv_lens`, so on the card BERT's
attention runs through the flash kernels and no (S, S) mask is built.

The JAX package runs the layers as an `nn.scan` over stacked weights; here
they are an `nn.ModuleList` (`hsenet_torch.bridge` unstacks
`language_encoder/layers`). `convert_hf_bert` carries HF `BertModel`
weights over.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.configs import BertConfig
from hsenet_torch.models.layers import Dense, Embed, LayerNorm
from hsenet_torch.ops.attention import multi_head_attention


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings in `dtype`, then an f32
    LayerNorm."""

    def __init__(self, config: BertConfig, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        self.word = Embed(cfg.vocab_size, cfg.hidden_size, dtype=dtype,
                          device=device)
        self.position = Embed(cfg.max_position_embeddings, cfg.hidden_size,
                              dtype=dtype, device=device)
        self.token_type = Embed(cfg.type_vocab_size, cfg.hidden_size,
                                dtype=dtype, device=device)
        self.norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                              device=device)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        pos_ids = torch.arange(input_ids.shape[1], device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word(input_ids) + self.position(pos_ids)[None]
             + self.token_type(token_type_ids))
        return self.norm(x)


class BertLayer(nn.Module):
    """Post-LN encoder layer: x = LN(x + Attn(x)); x = LN(x + FFN(x))."""

    def __init__(self, config: BertConfig, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        h = cfg.hidden_size
        for name in ("q", "k", "v", "attn_out"):
            setattr(self, name, Dense(h, h, dtype=dtype, device=device))
        self.attn_norm = LayerNorm(h, eps=cfg.layer_norm_eps, device=device)
        self.ffn_in = Dense(h, cfg.intermediate_size, dtype=dtype, device=device)
        self.ffn_out = Dense(cfg.intermediate_size, h, dtype=dtype, device=device)
        self.ffn_norm = LayerNorm(h, eps=cfg.layer_norm_eps, device=device)

    def forward(self, x: torch.Tensor, kv_lens: torch.Tensor) -> torch.Tensor:
        def heads(t):
            return rearrange(t, "b s (n d) -> b n s d", n=self.config.num_heads)

        attn = multi_head_attention(heads(self.q(x)), heads(self.k(x)),
                                    heads(self.v(x)), kv_lens=kv_lens)
        attn = self.attn_out(rearrange(attn, "b n s d -> b s (n d)"))
        x = self.attn_norm(x + attn)
        y = self.ffn_out(F.gelu(self.ffn_in(x)))
        return self.ffn_norm(x + y)


class BertEncoder(nn.Module):
    """Returns last_hidden_state (B, S, H) in f32, as HF `BertModel`."""

    def __init__(self, config: BertConfig, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embeddings = BertEmbeddings(config, dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            BertLayer(config, dtype=dtype, device=device)
            for _ in range(config.num_layers)
        )

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None, *,
                deterministic: bool = True) -> torch.Tensor:
        """`attention_mask` is right-padded (1 on the valid prefix of each
        row). BERT has no dropout here, so `deterministic` changes nothing;
        it is taken for the callers' uniform signature."""
        b, s = input_ids.shape
        if attention_mask is None:
            kv_lens = torch.full((b,), s, dtype=torch.int32,
                                 device=input_ids.device)
        else:
            kv_lens = attention_mask.sum(dim=-1).to(torch.int32)
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.layers:
            x = layer(x, kv_lens)
        return x


def convert_hf_bert(state_dict, config: BertConfig):
    """HF torch `BertModel.state_dict()` -> the state dict of the port's
    `BertEncoder` (f32 host tensors; HF's (out, in) Linear layout is the
    port's)."""
    from hsenet_torch.utils.convert import as_f32

    out = {}

    def copy(src, dst, bias=True):
        out[f"{dst}.weight"] = as_f32(state_dict[f"{src}.weight"])
        if bias:
            out[f"{dst}.bias"] = as_f32(state_dict[f"{src}.bias"])

    for src, dst in (("word_embeddings", "word"), ("position_embeddings", "position"),
                     ("token_type_embeddings", "token_type")):
        copy(f"embeddings.{src}", f"embeddings.{dst}", bias=False)
    copy("embeddings.LayerNorm", "embeddings.norm")
    for i in range(config.num_layers):
        src, dst = f"encoder.layer.{i}", f"layers.{i}"
        for a, b in (("attention.self.query", "q"), ("attention.self.key", "k"),
                     ("attention.self.value", "v"),
                     ("attention.output.dense", "attn_out"),
                     ("attention.output.LayerNorm", "attn_norm"),
                     ("intermediate.dense", "ffn_in"), ("output.dense", "ffn_out"),
                     ("output.LayerNorm", "ffn_norm")):
            copy(f"{src}.{a}", f"{dst}.{b}")
    return out
