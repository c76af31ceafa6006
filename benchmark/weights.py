"""The weights both sides get: each leaf drawn on the device from the run's
seed and the leaf's name, in bfloat16, the dtype the models are served in
(a leaf the program holds in float32 takes the same values exactly).

A leaf's values depend on (seed, name, shape) alone, not on the
order in which leaves are drawn, so the program fills its modules and the
plain reference builds its own tensors from the same numbers. The names are
the program's state-dict names; the reference only uses them as keys.

The scales follow the usual initialisers: dense weights normal with std
1/sqrt(fan_in), embedding tables, position embeddings and class tokens
normal with std 0.02, norm scales 1, biases 0, CLIP's logit scale
log(1/0.07). LoRA's A is normal with std 1/rank and its B normal with std
`LORA_B_STD`: a finetune measured mid-run, whose adapters already carry
their share of the output (a B of zeros, as at the start of a run, gives
every A a zero gradient).

A configuration may scale the weights that make queries and keys
(`qk_gain`: a gain for each name prefix, on a BERT's q and k weights and
on the first two thirds of the rows of a fused qkv weight). Random towers
at the usual scale attend almost uniformly, where trained ones do not,
and the gradient of a query or key is then a small difference that the
check cannot tell from its rounding.
"""

from __future__ import annotations

import math
import zlib

import torch

LOGIT_SCALE_INIT = math.log(1 / 0.07)
TABLE_STD = 0.02
LORA_B_STD = 2e-3
# leaves (by their last name part) drawn as tables, whatever their rank
TABLE_LEAVES = ("pos_embed", "cls_token")


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit seed from the run's seed and a leaf's name (splitmix64)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(name.encode())) % (1 << 64)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) % (1 << 64)
    return (x ^ (x >> 31)) % (1 << 63)


def is_table(name: str) -> bool:
    """Embedding tables: looked up by id, not multiplied by an input."""
    parts = name.split(".")
    return (parts[-1] in TABLE_LEAVES or name.endswith("embed.weight")
            or (len(parts) > 2 and parts[-3] == "embeddings"
                and parts[-2] in ("word", "position", "token_type")))


DTYPE = torch.bfloat16


def qk_rows(name: str, shape) -> int:
    """How many leading rows of leaf `name` make queries and keys: all of a
    q or k weight, two thirds of a fused qkv weight, none of the rest."""
    if name.endswith((".q.weight", ".k.weight")):
        return shape[0]
    if name.endswith(".qkv.weight"):
        return 2 * shape[0] // 3
    return 0


def draw(seed: int, name: str, shape, device, qk_gain=None) -> torch.Tensor:
    """The value of leaf `name` of `shape` on `device`, in `DTYPE`; `qk_gain`
    maps name prefixes to the gain of their query and key rows."""
    leaf = name.rsplit(".", 1)[-1]
    out = torch.empty(tuple(shape), dtype=DTYPE, device=device)
    if leaf == "bias":
        return out.zero_()
    if leaf == "logit_scale":
        return out.fill_(LOGIT_SCALE_INIT)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, name))
    if is_table(name):
        std = TABLE_STD
    elif leaf == "weight" and out.ndim == 1:  # LayerNorm / RMSNorm scale
        return out.fill_(1.0)
    elif leaf == "lora_a":
        std = 1.0 / out.shape[1]
    elif leaf == "lora_b":
        std = LORA_B_STD
    elif leaf == "weight" and out.ndim == 2:
        std = 1.0 / math.sqrt(out.shape[1])
    else:
        raise ValueError(f"no initialiser for leaf {name} of shape {tuple(shape)}")
    out.normal_(0.0, std, generator=gen)
    gain = next((g for prefix, g in (qk_gain or {}).items()
                 if name.startswith(prefix)), 1.0)
    rows = qk_rows(name, out.shape)
    if gain != 1.0 and rows:
        out[:rows].mul_(gain)
    return out
