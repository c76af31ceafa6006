"""The plain reference of the CLIP stage-1 step, and its operation counts.

HSENet's stage-1 CLIP (github.com/YanzhaoShi/HSENet, the reference's
`train_CLIP_stage1.py`): a 3D ViT over the volume's (4, 16, 16) patches
(pre-LN blocks, exact GELU, a class token, a final LayerNorm) and BERT-base
over the report (post-LN, exact GELU, right padding left out as keys); each
class token is projected and L2-normalised, the logits are the features'
products times the raw learnable scale, and the loss is the mean of the
image-to-text and text-to-image cross-entropies over the batch.

The reference computes in float32 (or the fp8 control), sample by sample:
the features of the whole batch without a gradient, the loss and its
gradient by the features, then each sample's features again with the
gradient by them fed back (the loss couples the samples only through the
features, so this is the batch's gradient exactly).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.common import (
    Numerics,
    Readings,
    attention,
    heads,
    layer_norm,
    load_weights,
    merge_heads,
    plain_float32,
    train_steps,
)

VIT_EPS = 1e-6
ROWS_PER_BLOCK = 4  # samples a backward pass holds at once


def grid(vision: dict):
    return [i // p for i, p in zip(vision["image_size"], vision["patch_size"])]


def vit_table(prefix: str, vision: dict) -> Dict[str, tuple]:
    """Names and shapes of a 3D ViT's leaves (stage 1: no slice guidance)."""
    h, m = vision["hidden_size"], vision["mlp_dim"]
    patch = math.prod(vision["patch_size"]) * vision["in_channels"]
    n = math.prod(grid(vision))
    t = {f"{prefix}patch_embed.proj.weight": (h, patch),
         f"{prefix}patch_embed.proj.bias": (h,),
         f"{prefix}patch_embed.pos_embed": (1, n, h),
         f"{prefix}cls_token": (1, 1, h)}
    for i in range(vision["num_layers"]):
        b = f"{prefix}tower.blocks.{i}."
        t.update({b + "norm1.weight": (h,), b + "norm1.bias": (h,),
                  b + "attn.qkv.weight": (3 * h, h)})
        if vision["qkv_bias"]:
            t[b + "attn.qkv.bias"] = (3 * h,)
        t.update({b + "attn.out_proj.weight": (h, h), b + "attn.out_proj.bias": (h,),
                  b + "norm2.weight": (h,), b + "norm2.bias": (h,),
                  b + "mlp.fc1.weight": (m, h), b + "mlp.fc1.bias": (m,),
                  b + "mlp.fc2.weight": (h, m), b + "mlp.fc2.bias": (h,)})
    t.update({f"{prefix}tower.norm.weight": (h,), f"{prefix}tower.norm.bias": (h,)})
    return t


def bert_table(prefix: str, text: dict) -> Dict[str, tuple]:
    h, m = text["hidden_size"], text["intermediate_size"]
    e = f"{prefix}embeddings."
    t = {e + "word.weight": (text["vocab_size"], h),
         e + "position.weight": (text["max_position_embeddings"], h),
         e + "token_type.weight": (text["type_vocab_size"], h),
         e + "norm.weight": (h,), e + "norm.bias": (h,)}
    for i in range(text["num_layers"]):
        b = f"{prefix}layers.{i}."
        for name, shape in (("q", (h, h)), ("k", (h, h)), ("v", (h, h)),
                            ("attn_out", (h, h)), ("ffn_in", (m, h)),
                            ("ffn_out", (h, m))):
            t[b + name + ".weight"] = shape
            t[b + name + ".bias"] = shape[:1]
        for name in ("attn_norm", "ffn_norm"):
            t[b + name + ".weight"] = (h,)
            t[b + name + ".bias"] = (h,)
    return t


def table(config: dict) -> Dict[str, tuple]:
    """Every leaf of the CLIP by the program's name, with its shape."""
    v, tx, p = config["vision"], config["text"], config["projection_dim"]
    t = {**vit_table("vision_encoder.", v), **bert_table("language_encoder.", tx)}
    t.update({"mm_vision_proj.weight": (p, v["hidden_size"]),
              "mm_vision_proj.bias": (p,),
              "mm_language_proj.weight": (p, tx["hidden_size"]),
              "mm_language_proj.bias": (p,), "logit_scale": ()})
    return t


def trainable(name: str) -> bool:
    """Stage 1 trains every leaf."""
    return True


def vit_block(num, w, b, x, n_heads, eps=VIT_EPS):
    y = layer_norm(x, w[b + "norm1.weight"], w[b + "norm1.bias"], eps)
    qkv = num.linear(y, w[b + "attn.qkv.weight"], w.get(b + "attn.qkv.bias"))
    q, k, v = (heads(t, n_heads) for t in qkv.chunk(3, dim=-1))
    a = num.linear(merge_heads(attention(num, q, k, v)),
                   w[b + "attn.out_proj.weight"], w[b + "attn.out_proj.bias"])
    x = x + a
    y = layer_norm(x, w[b + "norm2.weight"], w[b + "norm2.bias"], eps)
    y = F.gelu(num.linear(y, w[b + "mlp.fc1.weight"], w[b + "mlp.fc1.bias"]))
    return x + num.linear(y, w[b + "mlp.fc2.weight"], w[b + "mlp.fc2.bias"])


def patch_tokens(num, w, prefix, vision, volume):
    """(B, C, D, H, W) -> (B, N, hidden): each patch's voxels in (p0, p1,
    p2, c) order through the patch projection, plus position embeddings."""
    p0, p1, p2 = vision["patch_size"]
    b, c, d, h, ww = volume.shape
    x = volume.reshape(b, c, d // p0, p0, h // p1, p1, ww // p2, p2)
    x = x.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(b, -1, p0 * p1 * p2 * c)
    x = num.linear(x, w[prefix + "patch_embed.proj.weight"],
                   w[prefix + "patch_embed.proj.bias"])
    return x + w[prefix + "patch_embed.pos_embed"]


def vit_tower(num, w, prefix, vision, x):
    """[CLS | tokens] through the blocks and the final LayerNorm."""
    cls = w[prefix + "cls_token"].expand(x.shape[0], -1, -1)
    x = torch.cat([cls, x], dim=1)
    for i in range(vision["num_layers"]):
        x = vit_block(num, w, f"{prefix}tower.blocks.{i}.", x, vision["num_heads"])
    return layer_norm(x, w[prefix + "tower.norm.weight"],
                      w[prefix + "tower.norm.bias"], VIT_EPS)


def bert(num, w, text, ids, mask):
    e = "language_encoder.embeddings."
    pos = torch.arange(ids.shape[1], device=ids.device)
    x = (w[e + "word.weight"][ids] + w[e + "position.weight"][pos][None]
         + w[e + "token_type.weight"][0])
    eps = text["layer_norm_eps"]
    x = layer_norm(x, w[e + "norm.weight"], w[e + "norm.bias"], eps)
    lens = mask.sum(dim=-1)
    for i in range(text["num_layers"]):
        b = f"language_encoder.layers.{i}."

        def lin(name, t):
            return num.linear(t, w[b + name + ".weight"], w[b + name + ".bias"])

        n = text["num_heads"]
        a = attention(num, heads(lin("q", x), n), heads(lin("k", x), n),
                      heads(lin("v", x), n), kv_lens=lens)
        x = layer_norm(x + lin("attn_out", merge_heads(a)),
                       w[b + "attn_norm.weight"], w[b + "attn_norm.bias"], eps)
        y = lin("ffn_out", F.gelu(lin("ffn_in", x)))
        x = layer_norm(x + y, w[b + "ffn_norm.weight"], w[b + "ffn_norm.bias"], eps)
    return x


def normalise(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def features(num, w, config, image, ids, mask):
    """(image features, text features) of some samples."""
    v = config["vision"]
    img = vit_tower(num, w, "vision_encoder.", v,
                    patch_tokens(num, w, "vision_encoder.", v, image))
    img = normalise(num.linear(img[:, 0], w["mm_vision_proj.weight"],
                               w["mm_vision_proj.bias"]))
    txt = bert(num, w, config["text"], ids, mask)
    txt = normalise(num.linear(txt[:, 0], w["mm_language_proj.weight"],
                               w["mm_language_proj.bias"]))
    return img, txt


def contrastive_loss(num, img, txt, scale):
    logits = scale * num.matmul(img, txt.t())
    labels = torch.arange(img.shape[0], device=img.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)) / 2


def loss_backward(num, w, config, batch) -> float:
    """The batch's loss; each trainable leaf's `.grad` holds its gradient."""
    image, ids, mask = batch["image"], batch["input_ids"], batch["attention_mask"]
    n = image.shape[0]
    blocks = [slice(i, min(i + ROWS_PER_BLOCK, n)) for i in range(0, n, ROWS_PER_BLOCK)]
    with torch.no_grad():
        parts = [features(num, w, config, image[s], ids[s], mask[s]) for s in blocks]
    img = torch.cat([p[0] for p in parts]).requires_grad_(True)
    txt = torch.cat([p[1] for p in parts]).requires_grad_(True)
    loss = contrastive_loss(num, img, txt, w["logit_scale"])
    loss.backward()
    for s in blocks:
        i, t = features(num, w, config, image[s], ids[s], mask[s])
        torch.autograd.backward([i, t], [img.grad[s], txt.grad[s]])
    return loss.item()


def train_readings(config: dict, traffic: dict, seed: int, batches: List[dict],
                   device, precision: str = "f32") -> Readings:
    """The reference's readings of the run's first steps over `batches`
    (host arrays), from the run's weights."""
    plain_float32()
    num = Numerics(precision)
    w = load_weights(seed, table(config), device, trainable,
                     config.get("qk_gain"))
    dev = [{k: torch.as_tensor(v).to(device) for k, v in b.items()} for b in batches]
    dev = [{**b, "image": b["image"].float()} for b in dev]
    return train_steps(w, dev, config["optimizer"],
                       lambda b: loss_backward(num, w, config, b))


# ---- operation counts ----------------------------------------------------


def dense(tokens, n_in, n_out, *, grad_in: bool):
    """(forward, backward) FLOPs of a trained dense layer over `tokens`:
    the weight gradient always, the input's gradient where something
    trained lies upstream."""
    f = 2 * tokens * n_in * n_out
    return f, f * (2 if grad_in else 1)


def vit_flops(vision: dict, batch: int, *, trained: bool):
    """(forward, backward) FLOPs of a 3D ViT over `batch` volumes; without
    `trained` only the forward (a frozen tower under no gradient)."""
    h, m, layers = vision["hidden_size"], vision["mlp_dim"], vision["num_layers"]
    n = math.prod(grid(vision))
    s = n + 1
    patch = math.prod(vision["patch_size"]) * vision["in_channels"]
    fwd = bwd = 0
    f, b = dense(batch * n, patch, h, grad_in=False)  # the input is data
    fwd, bwd = fwd + f, bwd + b
    pairs = batch * vision["num_heads"] * s * s
    d = h // vision["num_heads"]
    for _ in range(layers):
        for n_in, n_out in ((h, 3 * h), (h, h), (h, m), (m, h)):
            f, b = dense(batch * s, n_in, n_out, grad_in=True)
            fwd, bwd = fwd + f, bwd + b
        fwd += 2 * 2 * d * pairs  # S and PV
        bwd += 4 * 2 * d * pairs  # dV, dP, dQ, dK
    return (fwd, bwd) if trained else (fwd, 0)


def bert_flops(text: dict, lens):
    """(forward, backward) FLOPs of BERT over the valid tokens of each row:
    every activation has the trained embeddings upstream."""
    h, m = text["hidden_size"], text["intermediate_size"]
    tokens = int(sum(lens))
    pairs = int(sum(int(n) * int(n) for n in lens)) * text["num_heads"]
    d = h // text["num_heads"]
    fwd = bwd = 0
    for _ in range(text["num_layers"]):
        for n_in, n_out in ((h, h), (h, h), (h, h), (h, h), (h, m), (m, h)):
            f, b = dense(tokens, n_in, n_out, grad_in=True)
            fwd, bwd = fwd + f, bwd + b
        fwd += 2 * 2 * d * pairs
        bwd += 4 * 2 * d * pairs
    return fwd, bwd


def step_flops(config: dict, traffic: dict, host_batch: dict) -> float:
    """Model FLOPs of one training step over `host_batch`: the forward,
    activation gradients wherever a trained leaf lies upstream and weight
    gradients of the trained leaves; dense work over the valid tokens,
    attention over the valid (query, key) pairs; nothing recomputed."""
    n = host_batch["input_ids"].shape[0]
    lens = host_batch["attention_mask"].sum(axis=1)
    v, t, p = config["vision"], config["text"], config["projection_dim"]
    fv, bv = vit_flops(v, n, trained=True)
    ft, bt = bert_flops(t, lens)
    fp, bp = dense(n, v["hidden_size"], p, grad_in=True)
    fq, bq = dense(n, t["hidden_size"], p, grad_in=True)
    logits = 2 * n * n * p
    return fv + bv + ft + bt + fp + bp + fq + bq + 3 * logits


def attention_launches(config: dict, traffic: dict, host_batch: dict):
    """The flash launches one step needs, as (count, kind, b, h, sq, skv, d,
    kv_lens, q_off, causal): each block's forward with its log-sum-exp and
    its backward, in the tower and in BERT."""
    v, t = config["vision"], config["text"]
    n = host_batch["input_ids"].shape[0]
    s = math.prod(grid(v)) + 1
    lens = [int(x) for x in host_batch["attention_mask"].sum(axis=1)]
    tower = (n, v["num_heads"], s, s, v["hidden_size"] // v["num_heads"],
             [s] * n, [0] * n, False)
    width = host_batch["input_ids"].shape[1]
    text = (n, t["num_heads"], width, width, t["hidden_size"] // t["num_heads"],
            lens, [0] * n, False)
    return [(v["num_layers"], "flash_fwd_lse", *tower),
            (v["num_layers"], "flash_bwd", *tower),
            (t["num_layers"], "flash_fwd_lse", *text),
            (t["num_layers"], "flash_bwd", *text)]
