"""The plain reference of the HSENet VLM finetune step, and its operation
counts.

HSENet's VLM (github.com/YanzhaoShi/HSENet, `train_VLM.py`): the volume
through two frozen 3D ViT towers, the plain stage-1 tower and the 2E3 tower
(its patches weighted by a sigmoid score from a single-head cross-attention
onto the 32 slice features); each tower's 2048 patch tokens (class token
dropped) through its own `VisualPacker_3d_phi_v3` (the (8, 16, 16) grid
pooled in (1, 4, 4) windows into 128 queries, each attending its window's
16 tokens, residual on the projected query, LayerNorm, then
Linear-GELU-Linear into 3072); the 256 image features overwrite the
placeholders after BOS, and Phi-4-mini (microsoft/Phi-4-mini-instruct:
RMSNorm, 24 query and 8 key/value heads of 128, rotary embedding on the
first 96 channels, SiLU-gated MLP, the tied token table as LM head) with
LoRA (rank 16, alpha 32) on its seven projections gives the logits; the
loss is the next-token cross-entropy over the labelled tokens, the mean
over each microbatch's tokens, averaged over the microbatches. LoRA
adapters, both packers and the token table train.

With an int8 base, the reference quantises the drawn projection weights
itself (one scale per output channel, the largest |value| over 127, codes
rounded half to even and clipped at 127) and computes with the codes times
their scales.

It computes in float32 (or the fp8 control), a few rows at a time, each
row's gradient summed into the leaves.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.clip import patch_tokens, vit_flops, vit_table, vit_tower
from benchmark.reference.common import (
    Numerics,
    Readings,
    attention,
    heads,
    layer_norm,
    load_weights,
    merge_heads,
    plain_float32,
    rms_norm,
    train_steps,
)

IGNORE_INDEX = -100
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
               "down_proj")
EPS = 1e-6  # the towers' and packers' LayerNorms
TOKENS_PER_BLOCK = 1600  # sequence positions a backward pass holds at once


def projection_shapes(llm: dict) -> Dict[str, tuple]:
    """(out, in) of each decoder projection."""
    h, f = llm["hidden_size"], llm["intermediate_size"]
    q, kv = llm["num_heads"] * llm["head_dim"], llm["num_kv_heads"] * llm["head_dim"]
    return {"q_proj": (q, h), "k_proj": (kv, h), "v_proj": (kv, h),
            "o_proj": (h, q), "gate_proj": (f, h), "up_proj": (f, h),
            "down_proj": (h, f)}


def packer_table(prefix: str, packer: dict) -> Dict[str, tuple]:
    d, o = packer["in_dim"], packer["out_dim"]
    r = f"{prefix}resolution_attention."
    t = {}
    for name in ("wq", "wk", "wv", "out_proj"):
        t[f"{r}{name}.weight"], t[f"{r}{name}.bias"] = (d, d), (d,)
    t.update({r + "norm.weight": (d,), r + "norm.bias": (d,),
              prefix + "proj_fc1.weight": (o, d), prefix + "proj_fc1.bias": (o,),
              prefix + "proj_fc2.weight": (o, o), prefix + "proj_fc2.bias": (o,)})
    return t


def table(config: dict) -> Dict[str, tuple]:
    """Every float leaf of the VLM by the program's name, with its shape."""
    v, llm, rank = config["vision"], config["llm"], config["lora"]["rank"]
    h = v["hidden_size"]
    t = {**vit_table("vision_tower.tower_stage1.", v),
         **vit_table("vision_tower.tower_stage2.", v)}
    s = "vision_tower.tower_stage2.slice_guided_attention."
    for name in ("wq", "wk", "wv", "out_proj"):
        t[f"{s}{name}.weight"], t[f"{s}{name}.bias"] = (h, h), (h,)
    t.update({s + "norm.weight": (h,), s + "norm.bias": (h,),
              "vision_tower.tower_stage2.patch_score_proj.weight": (1, h),
              "vision_tower.tower_stage2.patch_score_proj.bias": (1,)})
    t.update(packer_table("mm_projector.", config["packer"]))
    t.update(packer_table("mm_projector2.", config["packer"]))
    t["llm.embed.weight"] = (llm["vocab_size"], llm["hidden_size"])
    for i in range(llm["num_layers"]):
        b = f"llm.decoder.layers.{i}."
        t[b + "input_norm.weight"] = (llm["hidden_size"],)
        t[b + "post_attn_norm.weight"] = (llm["hidden_size"],)
        for name, (n_out, n_in) in projection_shapes(llm).items():
            t[f"{b}{name}.weight"] = (n_out, n_in)
            t[f"{b}{name}.lora_a"] = (n_in, rank)
            t[f"{b}{name}.lora_b"] = (rank, n_out)
    t["llm.decoder.norm.weight"] = (llm["hidden_size"],)
    return t


def trainable(name: str) -> bool:
    """LoRA adapters, both packers and the tied token table train."""
    return ("lora_a" in name or "lora_b" in name or "mm_projector" in name
            or name == "llm.embed.weight")


def quantised(w: torch.Tensor) -> torch.Tensor:
    """A weight as its int8 codes times their per-output-channel scales."""
    scale = (w.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(w / scale).clamp(-127, 127) * scale


def load(config: dict, seed: int, device, int8_base: bool):
    w = load_weights(seed, table(config), device, trainable,
                     config.get("qk_gain"))
    if int8_base:
        for name in list(w):
            if name.rsplit(".", 2)[-2:][0] in PROJECTIONS and name.endswith(".weight"):
                w[name] = quantised(w[name])
    return w


def towers(num, w, config, image, slices):
    """Both towers' patch tokens (B, 2048, hidden) each, without a gradient."""
    v = config["vision"]
    one = "vision_tower.tower_stage1."
    x1 = vit_tower(num, w, one, v, patch_tokens(num, w, one, v, image))[:, 1:]
    two = "vision_tower.tower_stage2."
    x = patch_tokens(num, w, two, v, image)
    s = two + "slice_guided_attention."

    def lin(name, t):
        return num.linear(t, w[s + name + ".weight"], w[s + name + ".bias"])

    q, k, val = lin("wq", x), lin("wk", slices), lin("wv", slices)
    p = torch.softmax(num.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1]), -1)
    guided = layer_norm(q + lin("out_proj", num.matmul(p, val)),
                        w[s + "norm.weight"], w[s + "norm.bias"], EPS)
    score = torch.sigmoid(num.linear(guided, w[two + "patch_score_proj.weight"],
                                     w[two + "patch_score_proj.bias"]))
    x2 = vit_tower(num, w, two, v, x * score)[:, 1:]
    return x1, x2


def packer(num, w, prefix, cfg, tokens):
    """(B, 2048, in_dim) -> (B, 128, out_dim)."""
    gd, gh, gw = cfg["grid"]
    kd, kh, kw = cfg["kernel"]
    b, _, c = tokens.shape
    hr = tokens.reshape(b, gd // kd, kd, gh // kh, kh, gw // kw, kw, c)
    hr = hr.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, -1, kd * kh * kw, c)
    r = prefix + "resolution_attention."

    def lin(name, t):
        return num.linear(t, w[name + ".weight"], w[name + ".bias"])

    q = lin(r + "wq", hr.mean(dim=2))
    k, v = lin(r + "wk", hr), lin(r + "wv", hr)
    s = num.matmul(q.unsqueeze(2), k.transpose(-1, -2)).squeeze(2) / math.sqrt(c)
    out = num.matmul(torch.softmax(s, dim=-1).unsqueeze(2), v).squeeze(2)
    packed = layer_norm(q + lin(r + "out_proj", out), w[r + "norm.weight"],
                        w[r + "norm.bias"], EPS)
    return lin(prefix + "proj_fc2", F.gelu(lin(prefix + "proj_fc1", packed)))


def rope(llm: dict, seq: int, device):
    rd = int(llm["head_dim"] * llm["partial_rotary_factor"])
    inv = 1.0 / llm["rope_theta"] ** (torch.arange(0, rd, 2, device=device,
                                                   dtype=torch.float32) / rd)
    freqs = torch.arange(seq, device=device, dtype=torch.float32)[:, None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin(), rd


def rotate(x, cos, sin, rd):
    rot, rest = x[..., :rd], x[..., rd:]
    a, b = rot.chunk(2, dim=-1)
    return torch.cat([rot * cos + torch.cat([-b, a], dim=-1) * sin, rest], dim=-1)


def decoder(num, w, config, x, kv_lens):
    """Phi-4-mini with LoRA over embeddings (B, S, hidden) -> the final
    norm's output; the tied table is the head."""
    llm, lora = config["llm"], config["lora"]
    scale = lora["alpha"] / lora["rank"]
    cos, sin, rd = rope(llm, x.shape[1], x.device)
    eps = llm["rms_norm_eps"]
    rep = llm["num_heads"] // llm["num_kv_heads"]
    for i in range(llm["num_layers"]):
        b = f"llm.decoder.layers.{i}."

        def proj(name, t):
            p = b + name
            return (num.linear(t, w[p + ".weight"])
                    + num.matmul(num.matmul(t, w[p + ".lora_a"]), w[p + ".lora_b"]) * scale)

        y = rms_norm(x, w[b + "input_norm.weight"], eps)
        q = rotate(heads(proj("q_proj", y), llm["num_heads"]), cos, sin, rd)
        k = rotate(heads(proj("k_proj", y), llm["num_kv_heads"]), cos, sin, rd)
        v = heads(proj("v_proj", y), llm["num_kv_heads"])
        a = attention(num, q, k.repeat_interleave(rep, dim=1),
                      v.repeat_interleave(rep, dim=1), kv_lens=kv_lens, causal=True)
        x = x + proj("o_proj", merge_heads(a))
        y = rms_norm(x, w[b + "post_attn_norm.weight"], eps)
        x = x + proj("down_proj", F.silu(proj("gate_proj", y)) * proj("up_proj", y))
    return rms_norm(x, w["llm.decoder.norm.weight"], eps)


def rows_loss(num, w, config, rows: dict, feats) -> torch.Tensor:
    """Summed next-token cross-entropy of some rows. The rows are cut after
    their longest valid length (the padding after it reaches no valid
    position), and the head runs at the labelled positions alone."""
    lens = rows["attention_mask"].sum(dim=-1)
    width = int(lens.max())
    ids, labels = rows["input_ids"][:, :width], rows["labels"][:, 1:width]
    n_img = feats.shape[1]
    tok = w["llm.embed.weight"][ids]
    x = torch.cat([tok[:, :1], feats, tok[:, 1 + n_img:]], dim=1)
    hidden = decoder(num, w, config, x, lens)[:, :-1]
    keep = labels != IGNORE_INDEX
    logits = num.linear(hidden[keep], w["llm.embed.weight"])
    return F.cross_entropy(logits, labels[keep], reduction="sum")


def loss_backward(num, w, config, traffic, batch) -> float:
    """The step's loss; each trainable leaf's `.grad` holds its gradient."""
    accum = traffic["grad_accum"]
    n = batch["input_ids"].shape[0] // accum
    block = max(1, TOKENS_PER_BLOCK // batch["input_ids"].shape[1])
    total = 0.0
    for m in range(accum):
        rows = {k: v[m * n:(m + 1) * n] for k, v in batch.items()}
        count = int((rows["labels"][:, 1:] != IGNORE_INDEX).sum())
        for s in range(0, n, block):
            part = {k: v[s:s + block] for k, v in rows.items()}
            with torch.no_grad():
                x1, x2 = towers(num, w, config, part["image"], part["image_2d"])
            feats = torch.cat([packer(num, w, "mm_projector.", config["packer"], x1),
                               packer(num, w, "mm_projector2.", config["packer"], x2)],
                              dim=1)
            loss = rows_loss(num, w, config, part, feats) / (max(count, 1) * accum)
            loss.backward()
            total += loss.item()
    return total


def train_readings(config: dict, traffic: dict, seed: int, batches: List[dict],
                   device, precision: str = "f32") -> Readings:
    """The reference's readings of the run's first steps over `batches`
    (host arrays), from the run's weights."""
    plain_float32()
    num = Numerics(precision)
    w = load(config, seed, device, traffic.get("int8_base", False))
    dev = [{k: torch.as_tensor(v).to(device) for k, v in b.items()} for b in batches]
    dev = [{**b, "image": b["image"].float(), "image_2d": b["image_2d"].float()}
           for b in dev]
    return train_steps(w, dev, config["optimizer"],
                       lambda b: loss_backward(num, w, config, traffic, b))


# ---- operation counts ----------------------------------------------------


def tower_flops(config: dict, batch: int) -> float:
    """Forward FLOPs of both frozen towers over `batch` volumes."""
    v = config["vision"]
    h, slices = v["hidden_size"], v["num_slices"]
    n = math.prod(g // p for g, p in zip(v["image_size"], v["patch_size"]))
    guide = (2 * n * h * h * 2  # wq, out_proj over the patches
             + 2 * 2 * slices * v["slice_feature_dim"] * h  # wk, wv
             + 2 * 2 * n * slices * h  # scores and the weighted sum
             + 2 * n * h)  # the patch score
    return 2 * vit_flops(v, batch, trained=False)[0] + batch * guide


def packer_flops(cfg: dict, batch: int) -> float:
    """Forward and backward FLOPs of one trained packer: weight gradients
    throughout, input gradients past the first products (their inputs are
    the frozen towers')."""
    d, o = cfg["in_dim"], cfg["out_dim"]
    win = math.prod(cfg["kernel"])
    windows = math.prod(g // k for g, k in zip(cfg["grid"], cfg["kernel"]))
    q = 2 * windows * d * d
    kv = 2 * 2 * windows * win * d * d
    attn = 2 * 2 * windows * win * d
    rest = 2 * windows * (d * d + d * o + o * o)
    return batch * (2 * (q + kv) + 3 * (attn + rest))


def llm_flops(config: dict, lens, labelled: int) -> float:
    """Forward and backward FLOPs of the decoder over the valid tokens of
    rows of `lens`: every activation has the trained token table upstream
    (input gradients everywhere), weight gradients of the adapters and of
    the tied table as the LM head (over the `labelled` positions: the
    positions that have a label to predict)."""
    llm, rank = config["llm"], config["lora"]["rank"]
    tokens = int(sum(lens))
    per_token = 0
    for n_out, n_in in projection_shapes(llm).values():
        per_token += 2 * 2 * n_in * n_out  # base: forward and input gradient
        per_token += 3 * 2 * rank * (n_in + n_out)  # adapters: forward, both gradients
    pairs = sum(int(n) * (int(n) + 1) // 2 for n in lens)
    attn = 6 * 2 * llm["head_dim"] * llm["num_heads"] * pairs  # S, PV; 4 backward
    head = 3 * 2 * llm["hidden_size"] * llm["vocab_size"]
    return llm["num_layers"] * (tokens * per_token) + llm["num_layers"] * attn \
        + labelled * head


def step_flops(config: dict, traffic: dict, host_batch: dict) -> float:
    """Model FLOPs of one training step over `host_batch`: the forward,
    input gradients wherever a trained leaf lies upstream and weight
    gradients of the trained leaves; dense work over the valid tokens,
    attention over the valid causal pairs, the LM head over the labelled
    positions; nothing recomputed."""
    n = host_batch["input_ids"].shape[0]
    lens = host_batch["attention_mask"].sum(axis=1)
    labelled = int((host_batch["labels"][:, 1:] != IGNORE_INDEX).sum())
    return (tower_flops(config, n) + 2 * packer_flops(config["packer"], n)
            + llm_flops(config, lens, labelled))


def attention_launches(config: dict, traffic: dict, host_batch: dict):
    """The flash launches one step needs, as (count, kind, b, h, sq, skv, d,
    kv_lens, q_off, causal): per microbatch, each frozen tower block's
    forward, and each decoder layer's forward with its log-sum-exp and its
    backward."""
    v, llm = config["vision"], config["llm"]
    accum = traffic["grad_accum"]
    n = host_batch["input_ids"].shape[0] // accum
    s = math.prod(g // p for g, p in zip(v["image_size"], v["patch_size"])) + 1
    seq = host_batch["input_ids"].shape[1]
    out = []
    for m in range(accum):
        lens = [int(x) for x in host_batch["attention_mask"][m * n:(m + 1) * n].sum(axis=1)]
        tower = (n, v["num_heads"], s, s, v["hidden_size"] // v["num_heads"],
                 [s] * n, [0] * n, False)
        dec = (n, llm["num_heads"], seq, seq, llm["head_dim"], lens, [0] * n, True)
        out += [(2 * v["num_layers"], "flash_fwd", *tower),
                (llm["num_layers"], "flash_fwd_lse", *dec),
                (llm["num_layers"], "flash_bwd", *dec)]
    return out
