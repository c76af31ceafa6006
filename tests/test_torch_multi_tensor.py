"""The fused multi-tensor optimizer (`ops/multi_tensor.py`,
`csrc/multi_tensor_adamw.cu`) against the per-leaf loop it replaces
(`AdamW.update_per_leaf`, the norm's `g.float().pow(2).sum()` a leaf).

CPU cases: the chunk plan covers every element once, the table's layout,
and the card route's wiring in `AdamW.step` (f16 and strided leaves,
ZeRO-1 slices) with a plain stand-in for the kernel. Card cases (`card`,
skipped without CUDA; this file imports no JAX):

    python -m pytest tests/test_torch_multi_tensor.py -q -m card -o addopts= --noconftest

run the fused route and the loop side by side over the trained leaves of
the benchmark's CLIP and VLM configurations, and over odd leaves: 0, 1 and
4k + 3 elements, views with a storage offset, more leaves than one table
holds, f16 and strided gradients, ZeRO-1 slices. The two routes compute the same
arithmetic, op for op, so from one grad_norm they give the same bits (the
test allows 2e-6 of each element); the norms sum in other orders and agree
to 1e-6.
"""

import ctypes
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from hsenet_torch.configs import TrainConfig
from hsenet_torch.ops import multi_tensor as mt
from hsenet_torch.train import train_state as tts

CHUNK = mt.CHUNK
ODD_NUMELS = (0, 1, 3, 4, 7, 4 * 1000 + 3, CHUNK - 1, CHUNK, CHUNK + 1,
              2 * CHUNK + 4 * 5 + 3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this host has none")
    return torch.device("cuda")


# ---- CPU ----

@pytest.mark.parametrize("offset", [0, 1, 3], ids=lambda o: f"offset{o}")
def test_chunk_plan_covers_every_element_once(offset):
    """Each leaf's chunks, [j * CHUNK, min((j + 1) * CHUNK, numel)) for its
    j, cover it once; the table holds each view's numel and its pointer,
    storage offset included. (The kernels' loads within a chunk are
    checked on the card.)"""
    base = torch.zeros(sum(ODD_NUMELS) + offset)
    views, at = [], offset
    for n in ODD_NUMELS:
        views.append(base[at:at + n])
        at += n
    plan = mt.chunk_plan(tuple(v.numel() for v in views))
    table = plan.table(views)
    assert plan.chunk_start[0] == 0 and table.n == len(views)
    assert list(table.chunk_start[:len(views) + 1]) == list(plan.chunk_start)
    for i, v in enumerate(views):
        n = v.numel()
        assert table.numel[i] == n
        assert (table.ptr[0][i] or 0) == v.data_ptr()
        seen = np.zeros(n, np.int64)
        for j in range(plan.chunk_start[i + 1] - plan.chunk_start[i]):
            seen[j * CHUNK:min((j + 1) * CHUNK, n)] += 1
        assert (seen == 1).all(), (n, offset)


def test_table_layout_and_pointers():
    plan = mt.chunk_plan((5, CHUNK + 1, 0))
    assert ctypes.sizeof(mt._Table) == 4 + 4 * (mt.MAX_LEAVES + 1) + 8 * mt.MAX_LEAVES \
        + 8 * 4 * mt.MAX_LEAVES
    ts = [torch.zeros(5), torch.zeros(CHUNK + 1), torch.zeros(0)]
    table = plan.table(ts, ts[::-1])
    assert table.n == 3 and list(table.chunk_start[:4]) == [0, 1, 3, 3]
    assert list(table.numel[:3]) == [5, CHUNK + 1, 0]
    assert [table.ptr[0][i] or 0 for i in range(3)] == [t.data_ptr() for t in ts]
    assert [table.ptr[1][i] or 0 for i in range(3)] == [t.data_ptr() for t in ts[::-1]]
    with pytest.raises(ValueError, match="leaves"):
        mt.chunk_plan(tuple([1] * (mt.MAX_LEAVES + 1)))


def _plain_adamw_(ps, gs, mus, nus, grad_norm, *, max_norm, b1, b2, eps,
                  weight_decay, lr, c1, c2):
    """The kernel's contract on the CPU: it takes contiguous f32 tensors
    only, and computes `update_per_leaf`'s arithmetic on them."""
    for t in (*ps, *gs, *mus, *nus):
        assert t.dtype == torch.float32 and t.is_contiguous()
    clip = torch.where(grad_norm < max_norm, 1.0, max_norm / grad_norm)
    for p, g, mu, nu in zip(ps, gs, mus, nus):
        g = g * clip
        mu.mul_(b1).add_(g, alpha=1.0 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        update = (mu / c1).div_((nu / c2).sqrt_().add_(eps))
        if weight_decay:
            update.add_(p, alpha=weight_decay)
        p.sub_(update, alpha=lr)


@pytest.mark.parametrize("case", ["cpu", "f16_mix", "zero1", "strided"])
def test_step_routes_each_leaf(case, monkeypatch):
    """On the CPU every leaf takes the per-leaf loop (`per_leaf`). On the
    card (CPU tensors stand in, with a plain stand-in for the kernel) every
    leaf goes to the kernel in one call (`fused`): f16 and bf16 gradients
    as f32 copies, strided gradients, params and moments as contiguous
    copies written back, ZeRO-1 slices gathered after; the result is the
    loop's. An f16 master on the card raises."""
    rng = np.random.default_rng(0)
    shapes = [(4, 6), (3, 4), (5,)]
    params = [torch.tensor(rng.standard_normal(s), dtype=torch.float32) for s in shapes]
    grads = [torch.tensor(rng.standard_normal(s), dtype=torch.float32) for s in shapes]
    tx = tts.AdamW(TrainConfig(total_steps=10, learning_rate=1e-2, warmup_ratio=0.1,
                               weight_decay=0.01))
    dims = [None] * 3
    if case == "f16_mix":
        grads[1], grads[2] = grads[1].half(), grads[2].bfloat16()
    if case == "strided":
        grads[0] = torch.tensor(rng.standard_normal((4, 12)), dtype=torch.float32)[:, ::2]
        params[1] = params[1].t().contiguous().t()
    if case == "zero1":
        dims = [0, 1, None]
        monkeypatch.setattr("hsenet_torch.parallel.mesh.all_gather",
                            lambda t, group, dim: torch.cat([t.neg(), t], dim))

    def cut(t, d):
        return t.clone() if d is None else t.chunk(2, dim=d)[1].clone()

    def fresh():
        zeros = [torch.zeros_like(p) for p in params]
        return tts.AdamWState(3, [cut(z, d) for z, d in zip(zeros, dims)],
                              [cut(z, d) for z, d in zip(zeros, dims)],
                              zero1_dims=dims if case == "zero1" else None,
                              zero1_rank=1, zero1_size=2)

    state, loop = fresh(), fresh()
    loop_params = [p.clone() for p in params]
    if case != "cpu":
        monkeypatch.setattr(mt, "fused_route", lambda t: True)
        monkeypatch.setattr(mt, "adamw_", _plain_adamw_)
    norm = torch.tensor(1.5)
    mt.reset_launch_counts()
    for _ in range(2):
        state = tx.step(params, [g.clone() for g in grads], state, norm)
        tx.update_per_leaf(list(zip(loop_params, [g.clone() for g in grads], loop.mu,
                                    loop.nu, dims)), loop, norm)
        loop = dataclasses.replace(loop, count=loop.count + 1)
    want = {"fused": 0, "per_leaf": 6} if case == "cpu" else {"fused": 6, "per_leaf": 0}
    assert mt.routes == want
    assert state.count == 5 and not params[0].equal(loop_params[0] * 0)
    for got, ref in [(params, loop_params), (state.mu, loop.mu), (state.nu, loop.nu)]:
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=2e-6, atol=0)
    if case == "f16_mix":
        params[2], state.mu[2], state.nu[2] = (t.half() for t in
                                               (params[2], state.mu[2], state.nu[2]))
        with pytest.raises(TypeError, match="f32 masters"):
            tx.step(params, grads, state, norm)


def test_sum_of_squares_per_leaf_on_the_cpu():
    rng = np.random.default_rng(1)
    grads = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
             for s in [(3, 4), (7,), (1,)]] + [torch.zeros(0), torch.ones(5).half()]
    got = mt.sum_of_squares(grads)
    assert got.dtype == torch.float32 and got.shape == (5,)
    for s, g in zip(got, grads):
        assert s.item() == g.float().pow(2).sum().item()
    assert tts.global_norm(grads).item() == torch.sqrt(got.sum()).item()
    # the registered operator's CPU implementation is the plain version
    assert torch.equal(mt.sum_squares_op(grads[:3]), got[:3])


# ---- the card ----

def _trained_shapes(config: str):
    """The shapes of the trained leaves of a benchmark configuration, from
    its model built on the meta device."""
    from benchmark.families import clip, vlm
    from hsenet_torch.models.clip import CLIPModel
    from hsenet_torch.models.mllm import HSENetVLM
    from hsenet_torch.train.vlm import vlm_trainable_mask

    root = Path(__file__).resolve().parent.parent / "benchmark" / "configs"
    if config == "clip":
        cfg = json.loads((root / "hsenet-clip.json").read_text())
        model = CLIPModel(clip.port_config(cfg), dtype=torch.bfloat16,
                          remat=True, device="meta")
        return [tuple(p.shape) for p in model.parameters()]
    cfg = json.loads((root / "hsenet-vlm-phi4mini.json").read_text())
    model = HSENetVLM(vlm.port_config(cfg), dtype=torch.bfloat16, device="meta",
                      remat=True)
    mask = vlm_trainable_mask(model)
    return [tuple(p.shape) for n, p in model.named_parameters() if mask[n]]


def _draw(shapes, device, gen, scale=1.0, offset=0):
    """Normal draws times `scale`; with `offset`, each a view that many
    elements into its own buffer."""
    return [(torch.randn(math.prod(s) + offset, device=device, generator=gen)
             * scale)[offset:].view(s) for s in shapes]


def _plain_norm(grads):
    """Today's norm: each leaf's `g.float().pow(2).sum()`, added in order."""
    return torch.sqrt(sum(g.float().pow(2).sum() for g in grads))


def _assert_same(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=0, msg=lambda m: f"{what}[{i}] {m}")


def _run_both(shapes, device, wd, targets, alter=None, offset=0, seed=0,
              zero1=False):
    """Steps of `AdamW.step` (the fused route on the card) and of the
    per-leaf loop from the same state, with gradients drawn to the global
    norms `targets` and then given to `alter`; with `zero1`, as rank 1 of
    2 holding ZeRO-1 slices of the moments (`all_gather` must be stood in
    for). Returns the routes and launches of the last step."""
    from hsenet_torch.parallel.zero import zero1_dim

    gen = torch.Generator(device=device).manual_seed(seed)
    cfg = TrainConfig(total_steps=20, learning_rate=1e-2, warmup_ratio=0.1,
                      weight_decay=wd, max_grad_norm=1.0)
    tx = tts.AdamW(cfg)
    params = _draw(shapes, device, gen, offset=offset)
    loop_params = [p.clone() for p in params]
    dims = [zero1_dim(p, 2) if zero1 else None for p in params]

    def cut(t, d):
        return t if d is None else t.chunk(2, dim=d)[1].clone()

    fused, loop = (tts.AdamWState(0, [cut(torch.zeros_like(p), d) for p, d in zip(params, dims)],
                                  [cut(torch.zeros_like(p), d) for p, d in zip(params, dims)],
                                  zero1_dims=dims if zero1 else None,
                                  zero1_rank=1, zero1_size=2)
                   for _ in range(2))
    total = sum(math.prod(s) for s in shapes)
    for step, target in enumerate(targets):
        grads = _draw(shapes, device, gen, target / math.sqrt(total), offset)
        if alter is not None:
            alter(grads)
        plain = _plain_norm(grads)
        mt.reset_launch_counts()
        torch.testing.assert_close(tts.global_norm(grads), plain, rtol=1e-6, atol=0)
        assert (plain.item() < 1.0) == (target < 1.0)
        loop_grads = [g.clone() for g in grads]
        fused = tx.step(params, grads, fused, plain)
        tx.update_per_leaf(list(zip(loop_params, loop_grads, loop.mu, loop.nu, dims)),
                           loop, plain)
        loop = dataclasses.replace(loop, count=loop.count + 1)
        _assert_same(params, loop_params, f"step {step} p")
        _assert_same(fused.mu, loop.mu, f"step {step} mu")
        _assert_same(fused.nu, loop.nu, f"step {step} nu")
    return dict(mt.routes), dict(mt.launches)


@pytest.mark.card
@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["wd0", "wd0.01"])
@pytest.mark.parametrize("config", ["clip", "vlm"])
def test_fused_route_matches_the_loop_at_the_cells_leaves(card, config, wd):
    """Five steps over every trained leaf of the configuration (the VLM's
    200064 x 3072 embedding included), norms above and below
    max_grad_norm, one leaf's gradient all zeros."""
    shapes = _trained_shapes(config)
    assert len(shapes) == {"clip": 340, "vlm": 477}[config]

    def zero_one_leaf(grads):
        grads[1] = torch.zeros_like(grads[1])

    routes, launches = _run_both(shapes, card, wd, [0.5, 3.0, 0.2, 5.0, 0.8],
                                 alter=zero_one_leaf)
    assert routes == {"fused": len(shapes), "per_leaf": 0}
    assert launches == {"sum_squares": 1, "leaf_sums": 1, "adamw": 1}


@pytest.mark.card
@pytest.mark.parametrize("case", ["odd", "views", "many", "mixed", "zero1"])
def test_fused_route_matches_the_loop_at_odd_leaves(card, case, monkeypatch):
    """Leaves of 0, 1 and 4k + 3 elements; views with a storage offset
    (1-wide loads); more leaves than one table (two launches each); f16,
    bf16 and strided gradients (contiguous f32 copies); ZeRO-1 slices along
    dims 0 and 1 (a slice along dim 1 updated as a contiguous copy), with a
    stand-in gather that puts the other rank's slice at its negation."""
    shapes = [(n,) for n in ODD_NUMELS] + [(3, CHUNK + 5), (2, 3, 7)]
    if case == "many":
        shapes = [(int(n),) for n in
                  np.random.default_rng(3).integers(1, 5000, mt.MAX_LEAVES + 60)]
    if case == "zero1":
        shapes = [(n * 2,) for n in ODD_NUMELS] + [(6, CHUNK + 5), (3, 2 * CHUNK + 6),
                                                   (5, 7)]
        monkeypatch.setattr("hsenet_torch.parallel.mesh.all_gather",
                            lambda t, group, dim: torch.cat([t.neg(), t], dim))

    def f16_bf16_strided(grads):
        grads[2] = grads[2].half()
        grads[5] = grads[5].bfloat16()
        grads[11] = grads[11].transpose(0, 2).contiguous().transpose(0, 2)

    routes, launches = _run_both(shapes, card, 0.01, [2.0, 0.5, 4.0],
                                 alter=f16_bf16_strided if case == "mixed" else None,
                                 offset=1 if case == "views" else 0, seed=4,
                                 zero1=case == "zero1")
    assert routes == {"fused": len(shapes), "per_leaf": 0}
    per_entry = 2 if case == "many" else 1
    assert launches == {"sum_squares": per_entry, "leaf_sums": per_entry,
                        "adamw": per_entry}
