"""LoRA dense layer, the int8 forms and their converters (the port of the
JAX package's models/lora.py: `LoRADense`, `QuantEmbed`, `DenseW8A8`,
`calibrate_w8a8_act_scales`, `merge_lora`, `quantize_kernels_int8`,
`quantize_embed_int8`).

`LoRADense`: the base weight keeps the name `weight` (the Linear layout,
(out, in)) and the adapters are `lora_a` (in, r) and `lora_b` (r, out), in
the JAX package's layout. y = x W^T + b + (drop(x) A) B * alpha / r, with
LoRA dropout on the adapter's input only. Every weight is cast to the
compute dtype at use, so the adapters can be held as f32 masters for
training over a bf16 base.

With `quantized=True` the base weight is two buffers instead: `weight_q`,
int8 codes laid out (out, in) like `weight` (one output channel is one
contiguous row, the layout `ops/quant_matvec.py`'s kernel reads), and
`weight_scale`, one f32 scale per output channel. The product goes through
`ops.quant_matvec.quant_matvec_int8`: at most 8 rows (decode) take the
kernel's function, which applies the scale in f32 to the f32 sum before
the cast; more rows (prefill) take the JAX layer's expression, the scale
applied in the compute dtype after the product. In f32 the two differ by
summation order only; in bf16 the expression rounds the product, the scale
and their product where the kernel rounds once, so they lie at most 1.5
bf16 units (2^-6 relative) apart.

The converters work on the port's own state: a `state_dict` (name ->
tensor) in, a new one out, which the module built with the matching
`quant_int8` / `quant_int8_embed` / `lora=None` config loads strictly.
They round half to even, clip at +-127 and floor the scale at 1e-8, and
give the codes and scales the JAX package's converters give on the same
float weights.

`DenseW8A8` is the W8A8 serving dense of the vision towers: int8 weights
(the same `weight_q` / `weight_scale` buffers, so `quantize_kernels_int8`
converts both forms) times int8 activations, summed in int32 by the
library's integer product `torch._int_mm` (the JAX package leaves this
product to XLA, outside any Pallas kernel), rescaled exactly in f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hsenet_torch import resolve_device
from hsenet_torch.configs import LoRAConfig
from hsenet_torch.models.layers import Dense, dropout
from hsenet_torch.ops.quant_matvec import quant_matvec_int8

QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj",
                 "gate_proj", "up_proj", "down_proj")
# the tower blocks' dense modules of the W8A8 encode serving mode
VIT_QUANT_TARGETS = ("qkv", "out_proj", "fc1", "fc2")


class LoRADense(Dense):
    """Dense with optional LoRA adapters and optional int8 weight-only
    storage, computing in `dtype`."""

    def __init__(self, in_dim: int, features: int, *, use_bias: bool = False,
                 lora: Optional[LoRAConfig] = None, quantized: bool = False,
                 dtype=torch.float32, device="cuda"):
        device = resolve_device(device)
        if quantized:
            # no float weight is ever allocated: codes and scales only
            nn.Module.__init__(self)
            self.in_features, self.out_features = in_dim, features
            self.compute_dtype = dtype
            self.register_parameter("weight", None)
            self.register_buffer("weight_q", torch.zeros(
                (features, in_dim), dtype=torch.int8, device=device))
            self.register_buffer("weight_scale", torch.ones(
                features, dtype=torch.float32, device=device))
            self.register_parameter("bias", nn.Parameter(torch.zeros(
                features, dtype=dtype, device=device)) if use_bias else None)
        else:
            super().__init__(in_dim, features, bias=use_bias, dtype=dtype,
                             device=device)
        self.quantized = quantized
        self.lora = lora
        if lora is not None:
            self.lora_a = nn.Parameter(
                torch.zeros(in_dim, lora.rank, dtype=dtype, device=device)
            )
            self.lora_b = nn.Parameter(
                torch.zeros(lora.rank, features, dtype=dtype, device=device)
            )

    def forward(self, x: torch.Tensor, *,
                deterministic: bool = True) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        if self.quantized:
            y = quant_matvec_int8(x, self.weight_q, self.weight_scale)
            if self.bias is not None:
                y = y + self.bias.to(dt)
        else:
            y = super().forward(x)
        if self.lora is not None:
            h = dropout(x, self.lora.dropout_rate, deterministic)
            y = y + (h @ self.lora_a.to(dt)) @ self.lora_b.to(dt) * self.lora.scale
        return y


class QuantEmbed(nn.Module):
    """int8 weight-only embedding with a tied LM head (`attend`).

    Buffers `embedding_q` (V, D) int8 and `scale` (V,) f32, one scale per
    vocabulary row. The lookup gathers int8 rows and rescales them in
    `dtype`; `attend` is a plain product against the table converted to
    `dtype`, with the logits scaled after it."""

    def __init__(self, vocab_size: int, features: int, *,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.register_buffer("embedding_q", torch.zeros(
            (vocab_size, features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            vocab_size, dtype=torch.float32, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        rows = self.embedding_q[ids].to(self.dtype)
        return rows * self.scale[ids].to(self.dtype)[..., None]

    def attend(self, hidden: torch.Tensor) -> torch.Tensor:
        logits = F.linear(hidden.to(self.dtype), self.embedding_q.to(self.dtype))
        return logits * self.scale.to(self.dtype)


class DenseW8A8(nn.Module):
    """int8 x int8 -> int32 dense for the W8A8 encode serving mode.

    Buffers `weight_q` (out, in) int8 and `weight_scale` (out,) f32 (one
    scale per output channel, as `LoRADense(quantized=True)`); an f32
    `bias`; with `static_act_scale`, a 0-d f32 `act_scale` buffer, the
    calibrated largest |activation| of the layer. Activations are
    quantised in f32 with the JAX layer's arithmetic, so the codes agree:

      * dynamic: one scale per row, max(rowmax |x|, 1e-8) / 127, codes
        round(x / scale) (half to even);
      * static: scale max(act_scale, 1e-8) / 127, codes clipped at +-127;
      * calibrating (`calibrating = True`, static modules only): records
        the running max of |x| in `amax` and quantises dynamically, so
        that deeper layers calibrate on undistorted activations.

    y = int32 sums * act scale * weight scale + bias in f32, cast to
    `dtype`. Inference only: nothing here has a gradient. On a CUDA tensor
    the library's integer product takes more than 16 rows and K, N
    multiples of 8: the towers give it B x 2049 rows of widths 768, 2304
    and 3072. The weight goes in as the column-major view `weight_q.t()`,
    never a copy."""

    def __init__(self, in_dim: int, features: int, *, use_bias: bool = True,
                 static_act_scale: bool = False, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.in_features, self.out_features = in_dim, features
        self.compute_dtype = dtype
        self.static_act_scale = static_act_scale
        self.register_buffer("weight_q", torch.zeros(
            (features, in_dim), dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            features, dtype=torch.float32, device=device))
        if static_act_scale:
            self.register_buffer("act_scale", torch.ones(
                (), dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            features, dtype=torch.float32, device=device)) if use_bias else None
        self.calibrating = False
        self.amax: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.static_act_scale and not self.calibrating:
            ascale = self.act_scale.clamp_min(1e-8) / 127.0
            xq = torch.round(xf / ascale).clamp(-127.0, 127.0)
        else:
            if self.calibrating:
                amax = xf.abs().amax()
                self.amax = amax if self.amax is None else torch.maximum(
                    self.amax, amax)
            ascale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
            xq = torch.round(xf / ascale)
        lead = x.shape[:-1]
        acc = torch._int_mm(xq.to(torch.int8).reshape(-1, self.in_features),
                            self.weight_q.t())
        y = acc.reshape(*lead, self.out_features).float() * ascale
        y = y * self.weight_scale
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.compute_dtype)


@torch.no_grad()
def calibrate_w8a8_act_scales(model: nn.Module, batches, fn=None) -> nn.Module:
    """Set every static-scale `DenseW8A8`'s `act_scale` in `model` to the
    largest |activation| it sees over `batches` (tuples of arguments to
    `fn`, by default the model itself), in place. During the pass each
    such layer quantises dynamically, as the JAX package's calibration
    does. Returns `model`."""
    layers = [m for m in model.modules()
              if isinstance(m, DenseW8A8) and m.static_act_scale]
    if not layers:
        raise ValueError("the model has no DenseW8A8 with static_act_scale")
    fn = model if fn is None else fn
    for layer in layers:
        layer.calibrating, layer.amax = True, None
    try:
        for batch in batches:
            fn(*batch)
        for layer in layers:
            if layer.amax is None:
                raise ValueError("a static-scale DenseW8A8 saw no activation")
            layer.act_scale.copy_(layer.amax)
    finally:
        for layer in layers:
            layer.calibrating, layer.amax = False, None
    return model


def _symmetric_int8(w: torch.Tensor):
    """(rows, cols) float -> (int8 codes, (rows,) f32 scales), each row
    quantised to its own largest |value|."""
    w = w.detach().float()
    scale = (w.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return q, scale[:, 0]


def quantize_kernels_int8(
    state: Dict[str, torch.Tensor],
    target_names: Sequence[str] = QUANT_TARGETS,
) -> Dict[str, torch.Tensor]:
    """`<target>.weight` (out, in) -> `<target>.weight_q` int8 and
    `<target>.weight_scale` (out,) f32 for the named projection modules:
    the state a `quant_int8=True` model loads."""
    out = {}
    for name, value in state.items():
        parts = name.split(".")
        if parts[-1] == "weight" and len(parts) > 1 and parts[-2] in target_names:
            q, scale = _symmetric_int8(value)
            prefix = name[: -len("weight")]
            out[prefix + "weight_q"] = q
            out[prefix + "weight_scale"] = scale
        else:
            out[name] = value
    return out


def quantize_towers_w8a8(state: Dict[str, torch.Tensor], *,
                         static: bool = False) -> Dict[str, torch.Tensor]:
    """`quantize_kernels_int8(..., VIT_QUANT_TARGETS)` over the ViT tower
    blocks of a float state (`*.tower.blocks.*`), the state a `quant_w8a8`
    tower loads. Only the blocks: the slice-guided cross-attention's
    `out_proj` shares a target name but stays a float dense in the W8A8
    mode. With `static`, every quantised module also gets an `act_scale`
    of 1.0 (the JAX layer's initial value) for calibration to overwrite."""
    blocks = {k: v for k, v in state.items() if ".tower.blocks." in f".{k}"}
    out = {k: v for k, v in state.items() if k not in blocks}
    for name, value in quantize_kernels_int8(blocks, VIT_QUANT_TARGETS).items():
        out[name] = value
        if static and name.endswith(".weight_scale"):
            out[name[: -len("weight_scale")] + "act_scale"] = torch.ones(
                (), dtype=torch.float32, device=value.device)
    return out


def quantize_embed_int8(state: Dict[str, torch.Tensor],
                        embed_name: str = "embed") -> Dict[str, torch.Tensor]:
    """`<embed_name>.weight` (V, D) -> `<embed_name>.embedding_q` int8 and
    `<embed_name>.scale` (V,) f32: the state a `quant_int8_embed=True`
    model loads."""
    out = {}
    for name, value in state.items():
        parts = name.split(".")
        if parts[-1] == "weight" and len(parts) > 1 and parts[-2] == embed_name:
            q, scale = _symmetric_int8(value)
            prefix = name[: -len("weight")]
            out[prefix + "embedding_q"] = q
            out[prefix + "scale"] = scale
        else:
            out[name] = value
    return out


def merge_lora(state: Dict[str, torch.Tensor],
               scale_map=None) -> Dict[str, torch.Tensor]:
    """Fold LoRA adapters into the base weights: wherever `weight`,
    `lora_a` and `lora_b` stand together, weight + (lora_a @ lora_b)^T *
    scale, and the adapters go. `scale_map` is the scale (alpha / r),
    default 2.0 (32 / 16)."""
    scale = 2.0 if scale_map is None else scale_map
    out = {}
    for name, value in state.items():
        prefix, _, leaf = name.rpartition(".")
        a, b = state.get(f"{prefix}.lora_a"), state.get(f"{prefix}.lora_b")
        merged = a is not None and b is not None and f"{prefix}.weight" in state
        if merged and leaf in ("lora_a", "lora_b"):
            continue
        if merged and leaf == "weight":
            value = value + (a.to(value.dtype) @ b.to(value.dtype)).t() * scale
        out[name] = value
    return out
