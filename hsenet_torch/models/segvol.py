"""SegVol: text-promptable volumetric segmentation (the port of the JAX
package's models/segvol.py), the VLM's optional [SEG] branch.

A 3D-adapted SAM after the reference's `model/segmentation_module/`: a
ViT-B image encoder without CLS (or the 3D Swin encoder) gives an (8, 16,
16) feature grid; the prompt encoder embeds text (and points and boxes)
with a random Fourier positional encoding; a depth-2 two-way transformer
decodes the mask tokens; hypernetwork MLPs dot the 4x-upscaled grid, a
text-similarity map is added, and the logits are resized trilinearly to
the input shape.

As in the JAX package the layouts are channel last (B, D, H, W, C), the
upscaling LayerNorm normalises over channels, and the decoder's attentions
(`_DownsampledAttention`, 8 heads of 96 or 48 over 4-2048 tokens) are plain
products with an f32 softmax. The image encoder's attention is the port's
flash kernel (B1, 2048 tokens with no CLS at head dim 64). The two
transposed convolutions (kernel 2, stride 2) are `nn.ConvTranspose3d`;
`hsenet_torch.bridge` carries a flax (kd, kh, kw, in, out) kernel over with
its spatial axes flipped, since flax's `ConvTranspose` (no kernel
transpose) puts K[1 - a] where PyTorch puts W[a]. The upsample is the JAX
package's antialiased linear resize (`data.preprocess.resize`), and the
Fourier matrix `gaussian_matrix` is a parameter the bridge carries across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.configs import SwinConfig, ViT3DConfig
from hsenet_torch.data.preprocess import resize
from hsenet_torch.models.layers import Dense, LayerNorm
from hsenet_torch.models.vit import ViT3D


class PositionEmbeddingRandom3D(nn.Module):
    """Random Fourier-feature encoding of [0, 1]^3 coordinates (SAM's
    pe_layer); the Gaussian matrix takes no gradient."""

    def __init__(self, num_pos_feats: int = 384, *, device="cuda"):
        super().__init__()
        self.gaussian_matrix = nn.Parameter(
            torch.zeros(3, num_pos_feats, device=resolve_device(device)))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        """coords (..., 3) in [0, 1] -> (..., 2 * num_pos_feats) f32."""
        c = (2.0 * coords.float() - 1.0) @ self.gaussian_matrix.detach()
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    @staticmethod
    def grid_coords(shape: Tuple[int, int, int], device) -> torch.Tensor:
        """Normalised voxel-centre coordinates of a (D, H, W) grid."""
        axes = [(torch.arange(n, device=device, dtype=torch.float32) + 0.5) / n
                for n in shape]
        return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


class PromptEncoder3D(nn.Module):
    """Sparse (text, points, boxes) and dense prompt embeddings."""

    def __init__(self, embed_dim: int = 768, grid=(8, 16, 16), *,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim, self.grid, self.dtype = embed_dim, tuple(grid), dtype
        self.pe_layer = PositionEmbeddingRandom3D(embed_dim // 2, device=device)
        # positive / negative point and the two box corners
        self.point_embeddings = nn.Parameter(torch.zeros(4, embed_dim,
                                                         device=device))
        self.not_a_point_embed = nn.Parameter(torch.zeros(1, embed_dim,
                                                          device=device))
        self.no_mask_embed = nn.Parameter(torch.zeros(1, embed_dim,
                                                      device=device))

    def dense_pe(self) -> torch.Tensor:
        """(1, D, H, W, C) positional encoding of the feature grid."""
        coords = PositionEmbeddingRandom3D.grid_coords(
            self.grid, self.point_embeddings.device)
        return self.pe_layer(coords)[None]

    def forward(self, text_embedding: Optional[torch.Tensor] = None,
                points=None, boxes: Optional[torch.Tensor] = None):
        """(sparse (B, T, C), dense (B, D, H, W, C)) in the compute dtype;
        points are ((B, N, 3) coords, (B, N) labels: 1 positive, 0
        negative, -1 padding), boxes (B, 6) normalised corners."""
        parts, batch = [], None
        if points is not None:
            coords, labels = points
            pe = self.pe_layer(coords)
            pe = torch.where((labels == -1)[..., None],
                             self.not_a_point_embed[0], pe)
            pe = pe + torch.where((labels == 1)[..., None],
                                  self.point_embeddings[1],
                                  self.point_embeddings[0]
                                  ) * (labels != -1)[..., None]
            parts.append(pe)
            batch = coords.shape[0]
        if boxes is not None:
            pe = self.pe_layer(boxes.reshape(-1, 2, 3))
            parts.append(pe + self.point_embeddings[2:4][None])
            batch = boxes.shape[0]
        if text_embedding is not None:
            parts.append(text_embedding[:, None, :])
            batch = text_embedding.shape[0]
        if batch is None:
            raise ValueError("SegVol needs at least one prompt")
        sparse = torch.cat([p.to(self.dtype) for p in parts], dim=1)
        dense = self.no_mask_embed[0].to(self.dtype).expand(
            batch, *self.grid, self.embed_dim)
        return sparse, dense


class _DownsampledAttention(nn.Module):
    """SAM's decoder attention at inner width embed_dim // downsample_rate:
    plain products, the scores and softmax in f32."""

    def __init__(self, embed_dim: int, num_heads: int,
                 downsample_rate: int = 1, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        inner = embed_dim // downsample_rate
        self.num_heads, self.head_dim = num_heads, inner // num_heads
        for name, (i, o) in (("q_proj", (embed_dim, inner)),
                             ("k_proj", (embed_dim, inner)),
                             ("v_proj", (embed_dim, inner)),
                             ("out_proj", (inner, embed_dim))):
            setattr(self, name, Dense(i, o, dtype=dtype, device=device))

    def forward(self, q, k, v):
        def heads(t):
            return rearrange(t, "b s (n d) -> b n s d", n=self.num_heads)

        qp, kp, vp = (heads(self.q_proj(q)), heads(self.k_proj(k)),
                      heads(self.v_proj(v)))
        s = torch.matmul(qp.float(), kp.float().transpose(-1, -2))
        attn = torch.softmax(s / math.sqrt(self.head_dim), dim=-1).to(vp.dtype)
        out = rearrange(torch.matmul(attn, vp), "b n s d -> b s (n d)")
        return self.out_proj(out)


class TwoWayBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int, *,
                 skip_first_layer_pe: bool = False, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = _DownsampledAttention(embed_dim, num_heads, 1, **kw)
        self.cross_attn_token_to_image = _DownsampledAttention(
            embed_dim, num_heads, 2, **kw)
        self.cross_attn_image_to_token = _DownsampledAttention(
            embed_dim, num_heads, 2, **kw)
        self.mlp_fc1 = Dense(embed_dim, mlp_dim, **kw)
        self.mlp_fc2 = Dense(mlp_dim, embed_dim, **kw)
        for i in range(1, 5):
            setattr(self, f"norm{i}", LayerNorm(embed_dim, device=device))

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        mlp = self.mlp_fc2(F.relu(self.mlp_fc1(queries)))
        queries = self.norm3(queries + mlp)
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int = 2, embed_dim: int = 768,
                 num_heads: int = 8, mlp_dim: int = 2048, *,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.depth = depth
        for i in range(depth):
            setattr(self, f"block{i}", TwoWayBlock(
                embed_dim, num_heads, mlp_dim, skip_first_layer_pe=(i == 0),
                dtype=dtype, device=device))
        self.final_attn_token_to_image = _DownsampledAttention(
            embed_dim, num_heads, 2, dtype=dtype, device=device)
        self.norm_final = LayerNorm(embed_dim, device=device)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding, image_pe (B, N, C); point_embedding (B, T, C)."""
        queries, keys = point_embedding, image_embedding
        for i in range(self.depth):
            queries, keys = getattr(self, f"block{i}")(
                queries, keys, point_embedding, image_pe)
        q, k = queries + point_embedding, keys + image_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final(queries), keys


class _HyperMLP(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out: int, depth: int = 3, *,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.depth = depth
        dims = [in_dim] + [hidden] * (depth - 1) + [out]
        for i in range(depth):
            setattr(self, f"fc{i + 1}", Dense(dims[i], dims[i + 1], dtype=dtype,
                                              device=device))

    def forward(self, x):
        for i in range(1, self.depth):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self.depth}")(x)


class _UpConv(nn.ConvTranspose3d):
    """Kernel 2, stride 2 transposed convolution over a channel-last
    (B, D, H, W, C) grid, computing in `dtype` as flax's
    `ConvTranspose(dtype=...)` does."""

    def __init__(self, in_dim: int, out_dim: int, *, dtype, device):
        super().__init__(in_dim, out_dim, kernel_size=2, stride=2,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv_transpose3d(x.to(dt).permute(0, 4, 1, 2, 3),
                               self.weight.to(dt), self.bias.to(dt), stride=2)
        return y.permute(0, 2, 3, 4, 1)


class MaskDecoder3D(nn.Module):
    """SAM's mask decoder with the text-similarity fusion."""

    def __init__(self, embed_dim: int = 768, num_multimask_outputs: int = 3,
                 iou_head_hidden: int = 256, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Parameter(torch.zeros(1, embed_dim, device=device))
        self.mask_tokens = nn.Parameter(
            torch.zeros(self.num_mask_tokens, embed_dim, device=device))
        self.transformer = TwoWayTransformer(embed_dim=embed_dim, **kw)
        self.upscale1 = _UpConv(embed_dim, embed_dim // 4, **kw)
        self.upscale_norm = LayerNorm(embed_dim // 4, device=device)
        self.upscale2 = _UpConv(embed_dim // 4, embed_dim // 8, **kw)
        for i in range(self.num_mask_tokens):
            setattr(self, f"hyper_mlp{i}", _HyperMLP(
                embed_dim, embed_dim, embed_dim // 8, **kw))
        self.txt_align_upscaled_embedding = Dense(embed_dim, embed_dim // 8,
                                                  **kw)
        self.iou_prediction_head = _HyperMLP(
            embed_dim, iou_head_hidden, self.num_mask_tokens, **kw)

    def forward(self, image_embeddings, image_pe, sparse_prompts,
                dense_prompts, text_embedding=None):
        """image_embeddings, dense_prompts (B, D, H, W, C); image_pe (1, D,
        H, W, C); sparse_prompts (B, T, C); text_embedding (B, C) ->
        (masks (B, M, 4D, 4H, 4W), iou_pred (B, M))."""
        m = self.num_mask_tokens
        b = sparse_prompts.shape[0]
        output_tokens = torch.cat([self.iou_token, self.mask_tokens]).to(
            self.dtype).expand(b, -1, -1)
        tokens = torch.cat([output_tokens, sparse_prompts], dim=1)
        src = image_embeddings + dense_prompts
        _, d, h, w, c = src.shape
        src_flat = src.reshape(b, d * h * w, c)
        pe_flat = image_pe.reshape(1, d * h * w, c).expand(b, -1, -1).to(
            self.dtype)
        hs, src_out = self.transformer(src_flat, pe_flat, tokens)
        iou_out, mask_tokens_out = hs[:, 0], hs[:, 1:1 + m]

        up = self.upscale1(src_out.reshape(b, d, h, w, c))
        up = F.gelu(self.upscale_norm(up))
        up = F.gelu(self.upscale2(up))  # (B, 4d, 4h, 4w, C/8)
        hyper = torch.stack([getattr(self, f"hyper_mlp{i}")(mask_tokens_out[:, i])
                             for i in range(m)], dim=1)  # (B, M, C/8)
        bu, du, hu, wu, cu = up.shape
        up_flat = up.reshape(bu, du * hu * wu, cu)
        masks = torch.matmul(hyper, up_flat.transpose(1, 2))
        if text_embedding is not None:
            txt = self.txt_align_upscaled_embedding(text_embedding.to(self.dtype))
            masks = masks + torch.matmul(up_flat, txt[:, :, None])[:, None, :, 0]
        masks = masks.reshape(bu, -1, du, hu, wu)
        return masks, self.iou_prediction_head(iou_out)


class SegVol(nn.Module):
    """Encoder -> prompt encoder -> mask decoder -> logits at the input's
    resolution. `swin` selects the 3D Swin encoder; the default `SwinConfig`
    gives a (4, 16, 16) x 768 grid, the ViT path's decoder width."""

    def __init__(self, vision: ViT3DConfig, swin: Optional[SwinConfig] = None,
                 *, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.vision = vision
        if swin is not None:
            from hsenet_torch.models.swin import SwinTransformer3D

            self.image_encoder = SwinTransformer3D(swin, dtype=dtype,
                                                   device=device)
            self.grid, self.embed_dim = swin.grid, swin.out_dim
        else:
            cfg = dataclasses.replace(vision, classification=False)
            self.image_encoder = ViT3D(cfg, dtype=dtype, device=device)
            self.grid, self.embed_dim = cfg.grid, cfg.hidden_size
        self.prompt_encoder = PromptEncoder3D(self.embed_dim, self.grid,
                                              dtype=dtype, device=device)
        self.mask_decoder = MaskDecoder3D(self.embed_dim, dtype=dtype,
                                          device=device)

    def encode_image(self, volume: torch.Tensor) -> torch.Tensor:
        """(B, 1, D, H, W) -> (B, gd, gh, gw, C) feature grid, the half of
        inference a predictor caches per volume."""
        feats = self.image_encoder(volume)
        if feats.dim() == 3:  # the ViT's token stream; Swin gives a grid
            feats = feats.reshape(feats.shape[0], *self.grid, self.embed_dim)
        return feats

    def decode(self, grid_feats: torch.Tensor, out_shape: Tuple[int, int, int],
               text_embedding: Optional[torch.Tensor] = None,
               boxes: Optional[torch.Tensor] = None, points=None,
               multimask_output: bool = False) -> torch.Tensor:
        """Prompt encode, mask decode and resize to `out_shape`: f32 logits
        (B, 1, D, H, W), or (B, 3, D, H, W) with `multimask_output`."""
        sparse, dense = self.prompt_encoder(text_embedding=text_embedding,
                                            boxes=boxes, points=points)
        masks, _ = self.mask_decoder(grid_feats, self.prompt_encoder.dense_pe(),
                                     sparse, dense, text_embedding)
        masks = masks[:, 1:] if multimask_output else masks[:, :1]
        return resize(masks, (*masks.shape[:2], *out_shape), "linear")

    def forward(self, volume: torch.Tensor,
                text_embedding: Optional[torch.Tensor] = None,
                boxes: Optional[torch.Tensor] = None, points=None,
                multimask_output: bool = False) -> torch.Tensor:
        return self.decode(self.encode_image(volume), tuple(volume.shape[2:]),
                           text_embedding=text_embedding, boxes=boxes,
                           points=points, multimask_output=multimask_output)


def binary_dice_loss(logits: torch.Tensor, targets: torch.Tensor,
                     smooth: float = 1.0) -> torch.Tensor:
    """The reference's `BinaryDiceLoss` (model/loss.py:5-24): sigmoid and a
    soft dice per row, 1 - dice averaged."""
    p = torch.sigmoid(logits.float()).reshape(logits.shape[0], -1)
    t = targets.float().reshape(targets.shape[0], -1)
    inter = (p * t).sum(dim=1)
    dice = (2 * inter + smooth) / (p.sum(dim=1) + t.sum(dim=1) + smooth)
    return (1.0 - dice).mean()


def masked_bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The reference's `BCELoss` (model/loss.py:27-43): BCE with logits over
    the voxels not labelled -1."""
    t = targets.float()
    valid = t >= 0
    x = logits.float()
    bce = (x.clamp_min(0) - x * torch.where(valid, t, 0.0)
           + torch.log1p(torch.exp(-x.abs())))
    return torch.where(valid, bce, 0.0).sum() / valid.sum().clamp_min(1)
