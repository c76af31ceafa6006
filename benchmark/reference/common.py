"""What the plain references share: their precision, their layers, the
optimizer of the program's training steps written out, and the readings
that the check compares.

The references compute in float32 with TF32 off. With precision "fp8"
(the control) every matrix product rounds both of its operands to
float8 e4m3, each tensor scaled by its own largest |value| (the step a
change would take below bfloat16); the gradient passes the rounding
unchanged (straight through), so the backward's products read the rounded
operands too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from benchmark import weights as bench_weights

PRECISIONS = ("f32", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def plain_float32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 at a per-tensor scale, with the gradient of
    the identity."""
    with torch.no_grad():
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        y = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (y - x).detach()


class Numerics:
    """The products of a reference, in float32 or (the control) fp8. A
    frozen weight (one that takes no gradient) is rounded once, in place."""

    def __init__(self, precision: str = "f32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.fp8 = precision == "fp8"
        self._rounded = set()

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.fp8 else x

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        if not self.fp8 or w.requires_grad:
            return self.q(w)
        if id(w) not in self._rounded:
            with torch.no_grad():
                w.copy_(fp8_round(w))
            self._rounded.add(id(w))
        return w

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.weight(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def attention(num: Numerics, q, k, v, *, kv_lens=None, causal=False):
    """Softmax attention over (B, H, S, D); keys at or past a row's kv_len
    and, with `causal`, keys after the query are left out."""
    s = num.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    sq, skv = q.shape[2], k.shape[2]
    col = torch.arange(skv, device=q.device)
    masked = torch.zeros((q.shape[0], 1, sq, skv), dtype=torch.bool,
                         device=q.device)
    if kv_lens is not None:
        masked = masked | (col[None, None, None, :]
                           >= kv_lens.to(q.device)[:, None, None, None])
    if causal:
        row = torch.arange(sq, device=q.device)
        masked = masked | (col[None, :] > row[:, None])[None, None]
    s = s.masked_fill(masked, float("-inf"))
    return num.matmul(torch.softmax(s, dim=-1), v)


def heads(x, n):
    """(B, S, n * d) -> (B, n, S, d)."""
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1).transpose(1, 2)


def merge_heads(x):
    """(B, n, S, d) -> (B, S, n * d)."""
    b, n, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, n * d)


def load_weights(seed: int, table: Dict[str, Sequence[int]], device,
                 trainable: Callable[[str], bool],
                 qk_gain=None) -> Dict[str, torch.Tensor]:
    """The run's weights in float32 (`benchmark.weights`, with the
    configuration's `qk_gain`), the trainable leaves requiring a gradient."""
    out = {}
    for name, shape in table.items():
        t = bench_weights.draw(seed, name, shape, device, qk_gain).float()
        out[name] = t.requires_grad_(trainable(name))
    return out


def schedule(opt: dict, count: int) -> float:
    """The learning rate at an update count: a linear warmup from 0 over
    max(1, int(total * warmup_ratio)) counts, then a cosine to 0 at total."""
    peak, total = opt["learning_rate"], opt["total_steps"]
    warmup = max(1, int(total * opt["warmup_ratio"]))
    if count < warmup:
        return peak * count / warmup
    span = max(total, warmup + 1) - warmup
    t = min(count - warmup, span)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / span))


@dataclass
class Readings:
    """What a training run's first steps give the check: each step's loss,
    each trainable leaf's norm of the first gradient as the optimizer gets
    it (clipped), and of its change over the steps; the reference also
    records each step's gradient norms, which decide the leaves counted."""

    losses: List[float]
    first_grad: Dict[str, float]
    change: Dict[str, float]
    grad_steps: List[Dict[str, float]] = field(default_factory=list)


def train_steps(params: Dict[str, torch.Tensor], batches, opt: dict,
                loss_backward: Callable) -> Readings:
    """The program's optimizer written out over `batches`: the gradient of
    `loss_backward(batch)` (which returns the loss and leaves the gradient
    in each trainable leaf's `.grad`), clipping by the global norm (scaled
    by max / norm only when norm >= max), then AdamW (bias-corrected
    moments, eps outside the root, decoupled weight decay) at the schedule's
    rate before the count is raised."""
    names = [n for n, p in params.items() if p.requires_grad]
    leaves = [params[n] for n in names]
    start = [p.detach().clone() for p in leaves]
    mu = [torch.zeros_like(p) for p in leaves]
    nu = [torch.zeros_like(p) for p in leaves]
    b1, b2, eps = opt["adam_b1"], opt["adam_b2"], opt["adam_eps"]
    losses, grad_steps = [], []
    for count, batch in enumerate(batches):
        for p in leaves:
            p.grad = None
        losses.append(float(loss_backward(batch)))
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.detach()
                 for p in leaves]
        norm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
        clip = 1.0 if norm < opt["max_grad_norm"] else opt["max_grad_norm"] / norm
        grads = [g * clip for g in grads]
        grad_steps.append({n: float(g.norm()) for n, g in zip(names, grads)})
        lr = schedule(opt, count)
        c1, c2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
        with torch.no_grad():
            for p, g, m, v in zip(leaves, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                update = (m / c1) / ((v / c2).sqrt() + eps)
                if opt["weight_decay"]:
                    update = update + opt["weight_decay"] * p
                p.sub_(lr * update)
        del grads
    for p in leaves:
        p.grad = None
    change = {n: float((p.detach() - p0).norm())
              for n, p, p0 in zip(names, leaves, start)}
    return Readings(losses, grad_steps[0], change, grad_steps)
