"""Rank worker of the port's multi-process tests (tests/test_torch_parallel_*.py):
one of `world` gloo processes on the CPU, rendezvous through a `file://` in
the test's directory. It imports torch and hsenet_torch only (the tests'
process has JAX loaded, which runs threads: ranks are started as fresh
interpreters, never forked).

    python _torch_parallel_worker.py <rank> <world> <dir>

reads `<dir>/cases.pt`, a list of (case name, payload), runs each case of
`CASES` in order on every rank, and writes `<dir>/out<rank>.pt`, a dict of
case name -> what the case returned on that rank. `spawn` runs a world of
them and returns every rank's results.
"""

import contextlib
import copy
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(directory, cases, world=2, timeout=600):
    """Run `cases` on `world` gloo ranks; [results of rank r for r in
    range(world)]. A rank that fails fails the caller with its output."""
    return launch(directory, cases, world, timeout)()


def launch(directory, cases, world=2, timeout=600):
    """Start `cases` on `world` gloo ranks and return at once: a function
    that waits for them and returns `spawn`'s result (the caller works
    meanwhile)."""
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    torch.save(cases, os.path.join(directory, "cases.pt"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=os.pathsep.join([REPO, os.path.dirname(__file__)]),
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), directory],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]

    def collect():
        try:
            outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [f"rank {r} failed:\n{out[-4000:]}"
                  for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
        assert not failed, "\n".join(failed)
        return [torch.load(os.path.join(directory, f"out{r}.pt"),
                           weights_only=False) for r in range(world)]

    return collect


def _mesh(dp, tp=1, pp=1, sp=1):
    from hsenet_torch.configs import MeshConfig
    from hsenet_torch.parallel.mesh import create_mesh

    return create_mesh(MeshConfig(dp=dp, tp=tp, pp=pp, sp=sp), device="cpu")


def _rank():
    return torch.distributed.get_rank()


def _tensors(batch, rows=None):
    out = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    return out if rows is None else {k: v[rows] for k, v in out.items()}


def _full_grads(model, names, grads):
    from hsenet_torch.parallel.sharding import gather_leaf

    return {n: gather_leaf(model, n, g).detach().clone()
            for n, g in zip(names, grads)}


# ---- tensor parallelism ----

def case_tp_lm(p):
    """tp = 2 logits, masked-LM gradients (LoRA included) and greedy decode
    of the float and int8 decoders, and the logits with attention biases."""
    from hsenet_torch.eval.generate import make_greedy_generate_llm_only
    from hsenet_torch.parallel.sharding import shard_params

    mesh = _mesh(1, 2)
    ids, labels = torch.as_tensor(p["ids"]), torch.as_tensor(p["labels"])
    model = shard_params(p["model"], mesh)
    out = {"heads": (model.config.num_heads, model.config.num_kv_heads)}
    logits, _ = model(ids)
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].flatten(0, 1).float(), labels[:, 1:].flatten().long())
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    out["logits"] = logits.detach()
    out["grads"] = _full_grads(model, list(params), grads)
    kv = torch.as_tensor(p["kv_lens"])
    for key in ("model", "qmodel"):
        m = model if key == "model" else shard_params(p["qmodel"], mesh)
        gen = make_greedy_generate_llm_only(m, max_new_tokens=p["max_new"],
                                            eos_token_id=-1,
                                            cache_dtype=torch.float32)
        out[f"tokens_{key}"] = gen(ids[:, :p["prompt"]], kv)
    with torch.no_grad():
        out["bias_logits"] = shard_params(p["bias_model"], mesh)(ids)[0]
    return out


def case_tp_engine(p):
    """The serving engine over tp = 2, float and int8 caches."""
    from hsenet_torch.serving import ServingEngine

    mesh = _mesh(1, 2)
    out = {}
    for name, dtype in (("float", torch.float32), ("int8", torch.int8)):
        eng = ServingEngine(copy.deepcopy(p["model"]), mesh=mesh,
                            cache_dtype=dtype, device="cpu", **p["kwargs"])
        uids = [eng.submit(q) for q in p["prompts"]]
        res = eng.run_until_drained()
        out[name] = [res[u] for u in uids]
        out[f"{name}_cache_heads"] = eng._cache.k.shape[2]
    return out


def case_tp_mqa(p):
    """A decoder whose one kv head does not split over tp = 2: logits,
    masked-LM gradients and the engine's tokens, the kv head (and the
    cache) replicated on both ranks."""
    from hsenet_torch.parallel.sharding import shard_params
    from hsenet_torch.serving import ServingEngine

    mesh = _mesh(1, 2)
    ids, labels = torch.as_tensor(p["ids"]), torch.as_tensor(p["labels"])
    model = shard_params(p["model"], mesh)
    logits, _ = model(ids)
    loss = torch.nn.functional.cross_entropy(
        logits[:, :-1].flatten(0, 1).float(), labels[:, 1:].flatten().long())
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    eng = ServingEngine(model, mesh=mesh, cache_dtype=torch.float32,
                        device="cpu", **p["kwargs"])
    uids = [eng.submit(q) for q in p["prompts"]]
    res = eng.run_until_drained()
    return {"logits": logits.detach(), "grads": _full_grads(model, list(params), grads),
            "tokens": [res[u] for u in uids], "cache_heads": eng._cache.k.shape[2]}


def case_serve_cli(p):
    from hsenet_torch.cli import serve

    with contextlib.redirect_stdout(open(os.devnull, "w")):
        return serve.main(p["argv"], device="cpu")


# ---- data parallelism ----

def case_stage1_grads(p):
    """The global contrastive loss and its gradients (averaged over dp) at
    dp = 2, each rank holding its contiguous half of the batch."""
    from hsenet_torch.parallel.sharding import shard_params
    from hsenet_torch.train.stage1 import stage1_loss_fn
    from hsenet_torch.train.train_state import global_norm, reduce_gradients

    mesh = _mesh(2, 1)
    model = shard_params(p["model"], mesh)
    n = len(p["batch"]["image"]) // 2
    batch = _tensors(p["batch"], slice(_rank() * n, (_rank() + 1) * n))
    params = dict(model.named_parameters())
    loss, metrics = stage1_loss_fn(model, batch, None)
    grads = torch.autograd.grad(loss, list(params.values()))
    grads = reduce_gradients(list(grads), list(params), model, mesh)
    return {"loss": loss.detach(), "acc": metrics["retrieval_acc"],
            "grad_norm": global_norm(grads, list(params), model),
            "grads": dict(zip(params, grads))}


def case_stage2_grads(p):
    """Stage 2's loss and gradients at dp = 2 with the teacher recomputed,
    and with its features from a `TeacherCache`."""
    from hsenet_torch.parallel.sharding import shard_params
    from hsenet_torch.train.stage2 import (
        TeacherCache,
        make_teacher_embed_fn,
        stage2_loss_fn,
        stage2_loss_fn_cached,
    )
    from hsenet_torch.train.train_state import reduce_gradients

    mesh = _mesh(2, 1)
    student, teacher = shard_params(p["student"], mesh), p["teacher"]
    for q in teacher.parameters():
        q.requires_grad_(False)
    n = len(p["batch"]["image"]) // 2
    rows = slice(_rank() * n, (_rank() + 1) * n)
    host = {k: np.asarray(v)[rows] for k, v in p["batch"].items()}
    cache = TeacherCache(make_teacher_embed_fn(teacher))
    cached = _tensors(cache.attach(host))
    params = dict(student.named_parameters())
    out = {}
    for name, fn in (
        ("recomputed", lambda: stage2_loss_fn(student, teacher, p["cfg"],
                                              _tensors(host), p["step"])),
        ("cached", lambda: stage2_loss_fn_cached(
            student, p["cfg"], teacher.scale().detach(), cached, p["step"])),
    ):
        loss, metrics = fn()
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = reduce_gradients(list(grads), list(params), student, mesh)
        out[name] = {"metrics": {k: v.detach() for k, v in metrics.items()},
                     "grads": dict(zip(params, grads))}
    return out


def case_vlm_steps(p):
    """Two VLM finetune steps at dp = 2 (rows split as the loader splits
    them), grad_accum 2, under each of the plain, ZeRO-1 and FSDP
    placements: metrics, the full parameters and Adam's full moments."""
    from hsenet_torch.parallel.sharding import shard_params, shard_params_fsdp
    from hsenet_torch.parallel.zero import shard_opt_state
    from hsenet_torch.train.train_state import TrainState, make_optimizer
    from hsenet_torch.train.vlm import (
        make_vlm_train_step,
        to_training_dtypes,
        vlm_trainable_mask,
    )
    from hsenet_torch.utils.checkpoint import _full_moments

    mesh = _mesh(2, 1)
    batch = _tensors(p["batch"], slice(_rank(), None, 2))
    out = {}
    for mode in ("plain", "zero1", "fsdp"):
        model = copy.deepcopy(p["model"])
        mask = vlm_trainable_mask(model)
        to_training_dtypes(model, mask)
        if mode == "fsdp":
            shard_params_fsdp(model, mesh, min_size=0)
        else:
            shard_params(model, mesh)
        tx = make_optimizer(p["train_cfg"], trainable_mask=mask)
        state = TrainState.create(model, tx, mesh=mesh)
        if mode == "zero1":
            state = dataclasses.replace(state, opt_state=shard_opt_state(
                state.opt_state, list(state.params.values()), mesh))
        step = make_vlm_train_step(model, tx, grad_accum=p["grad_accum"])
        rows = []
        for _ in range(2):
            state, metrics = step(state, batch)
            rows.append({k: float(v) for k, v in metrics.items()})
        mu, nu = _full_moments_of(state, _full_moments)
        restored = _save_and_restore(state, os.path.join(p["dir"], mode))
        out[mode] = {
            "restored": restored,
            "metrics": rows,
            "params": _full_grads(model, list(state.params),
                                  list(state.params.values())),
            "mu": mu, "nu": nu,
            "split": {n: tuple(v.shape) for n, v in state.params.items()},
            "moment_shapes": [tuple(t.shape) for t in state.opt_state.mu],
        }
    return out


def case_fsdp_layers(p):
    """One VLM loss and backward under FSDP at dp = 2 (`min_size=0`), with
    and without remat, every gather of a decoder layer's shard watched
    through a weak reference: the layer gathers it as its forward starts
    and nothing keeps it after the forward; the backward gathers again;
    no two layers' full weights are alive at once."""
    import weakref

    from hsenet_torch.models.phi3 import Phi3Block
    from hsenet_torch.parallel import sharding
    from hsenet_torch.parallel.sharding import fsdp_gathered, shard_params_fsdp
    from hsenet_torch.train.vlm import vlm_loss_fn

    mesh = _mesh(2, 1)
    batch = _tensors(p["batch"], slice(_rank(), None, 2))
    out = {}
    for remat in (False, True):
        model = copy.deepcopy(p["model"])
        for m in model.modules():
            if hasattr(m, "remat"):
                m.remat = remat
        shard_params_fsdp(model, mesh, min_size=0)
        layer_of = {id(t): i for i, (name, block) in enumerate(
            (n, b) for n, b in model.named_modules() if isinstance(b, Phi3Block))
            for t in block.parameters()}
        rec = {"phase": "forward", "forward": 0, "backward": 0, "max_live": 0}
        alive = []

        def watch(fn):
            def gather(t, *args, **kwargs):
                full = fn(t, *args, **kwargs)
                if id(t) in layer_of:
                    rec[rec["phase"]] += 1
                    alive.append((layer_of[id(t)], weakref.ref(full)))
                    live = {i for i, ref in alive if ref() is not None}
                    rec["max_live"] = max(rec["max_live"], len(live))
                return full
            return gather

        with contextlib.ExitStack() as stack:
            for name in ("all_gather", "gather_with_grad"):
                real = getattr(sharding, name)
                stack.callback(setattr, sharding, name, real)
                setattr(sharding, name, watch(real))
            with fsdp_gathered(model):
                loss, _ = vlm_loss_fn(model, batch)
                rec["alive_after_forward"] = sum(ref() is not None for _, ref in alive)
                rec["phase"] = "backward"
                loss.backward()
        rec["layer_leaves"] = sum(1 for b in model.modules() if isinstance(b, Phi3Block)
                                  for t in b.parameters() if id(t) in layer_of)
        out[remat] = rec
    return out


def case_fsdp_int8(p):
    """The int8-base VLM's loss and LoRA gradients under FSDP at dp = 2
    (`min_size=0`): the codes and scales each rank holds, the loss and the
    full gradients (averaged over dp)."""
    from hsenet_torch.parallel.sharding import (
        fsdp_gathered,
        gather_leaf,
        shard_params_fsdp,
    )
    from hsenet_torch.train.train_state import reduce_gradients
    from hsenet_torch.train.vlm import vlm_loss_fn

    mesh = _mesh(2, 1)
    model = shard_params_fsdp(copy.deepcopy(p["model"]), mesh, min_size=0)
    batch = _tensors(p["batch"], slice(_rank(), None, 2))
    params = {n: q for n, q in model.named_parameters() if q.requires_grad}
    with fsdp_gathered(model):
        loss, metrics = vlm_loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
    grads = reduce_gradients(list(grads), list(params), model, mesh)
    return {"loss": metrics["loss"].detach(),
            "codes": {n: tuple(b.shape) for n, b in model.named_buffers()},
            "grads": {n: gather_leaf(model, n, g) for n, g in zip(params, grads)}}


def _save_and_restore(state, directory):
    """Save `state` through `CheckpointManager` (the gathered state, written
    by rank 0), wipe this rank's shards, restore them from the file: whether
    every local tensor came back bit for bit."""
    from hsenet_torch.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(directory)
    mgr.save(2, state)
    local = [*state.params.values(), *state.opt_state.mu, *state.opt_state.nu]
    before = [t.detach().clone() for t in local]
    with torch.no_grad():
        for t in local:
            t.zero_()
    restored = mgr.restore(state)
    again = [*restored.params.values(), *restored.opt_state.mu,
             *restored.opt_state.nu]
    return restored.step == 2 and all(torch.equal(a, b)
                                      for a, b in zip(again, before))


def _full_moments_of(state, full_moments):
    names = list(state.params)
    mu, nu = full_moments(state)
    return dict(zip(names, mu)), dict(zip(names, nu))


def case_dp_generate(p):
    """make_data_parallel_generate at dp = 2 over a batch of 3 (padded to
    4): greedy, and sampled from one seed."""
    from hsenet_torch.eval.generate import (
        make_data_parallel_generate,
        make_greedy_generate,
    )
    from hsenet_torch.parallel.sharding import shard_params

    mesh = _mesh(2, 1)
    model = shard_params(p["model"], mesh)
    args = [torch.as_tensor(p[k]) for k in ("ids", "kv_lens", "image", "image_2d")]
    out = {}
    for name, kw in (("greedy", {}), ("sampled", p["sample"])):
        gen = make_greedy_generate(model, **p["gen_kwargs"], **kw)
        gen = make_data_parallel_generate(gen, mesh)
        call = {"rng": p["rng"]} if kw else {}
        out[name] = gen(*args, **call)
    return out


# ---- sequence and pipeline parallelism ----

@contextlib.contextmanager
def _recorded_grads():
    """Within the block, each train step's gradients by name, as its norm
    reads them (after the dp mean, the sp sum), land in the list."""
    import hsenet_torch.train.vlm as tvlm

    steps, real = [], tvlm.global_norm

    def spy(grads, names, model):
        steps.append({n: g.detach().clone() for n, g in zip(names, grads)})
        return real(grads, names, model)

    tvlm.global_norm = spy
    try:
        yield steps
    finally:
        tvlm.global_norm = real


def _steps(make_step, model, train_cfg, batch, n, mask=None, mesh=None,
           rng=None):
    """`n` steps of `make_step(tx)` from a fresh state: (metrics by step,
    each step's gradients, the trained leaves gathered over the stages)."""
    from hsenet_torch.parallel.pipeline import gather_stages
    from hsenet_torch.train.train_state import TrainState, make_optimizer

    tx = make_optimizer(train_cfg, trainable_mask=mask)
    state = TrainState.create(model, tx, mesh=mesh)
    step, rows = make_step(tx), []
    with _recorded_grads() as grads:
        for _ in range(n):
            state, m = step(state, batch) if rng is None else step(state, batch, rng)
            rows.append({k: float(v) for k, v in m.items()})
    params = gather_stages(model, {k: v.detach().clone()
                                   for k, v in state.params.items()})
    return {"metrics": rows, "grads": [gather_stages(model, g) for g in grads],
            "params": params}


def _dp_rows(batch, mesh):
    """This dp rank's contiguous rows of the global batch."""
    from hsenet_torch.parallel.mesh import axis_rank, axis_size

    n = len(next(iter(batch.values()))) // axis_size(mesh, "dp")
    r = axis_rank(mesh, "dp")
    return _tensors(batch, slice(r * n, (r + 1) * n))


def case_ring(p):
    """Ring attention at sp = 4: each sub-case's output chunk and, where
    it has a cotangent `w`, the gradients of sum(out * w) by q, k, v (this
    rank's chunks)."""
    from hsenet_torch.ops.ring_attention import ring_attention

    mesh = _mesh(1, sp=4)
    group = mesh.get_group("sp")
    r = _rank()
    out = {}
    for name, c in p.items():
        full = [torch.as_tensor(c[k]) for k in ("q", "k", "v")]
        n = full[0].shape[2] // 4
        loc = [t[:, :, r * n:(r + 1) * n].clone().requires_grad_() for t in full]
        kw = {k: (torch.as_tensor(v) if k == "kv_lens" else v)
              for k, v in c.get("kwargs", {}).items()}
        y = ring_attention(*loc, group=group, **kw)
        res = {"out": y.detach()}
        if "w" in c:
            w = torch.as_tensor(c["w"])[:, :, r * n:(r + 1) * n]
            res["grads"] = torch.autograd.grad((y * w).sum(), loc)
        out[name] = res
    return out


def case_sp_encode(p):
    """The ViT3D over the ring at (dp 2, sp 2), plain and slice-guided:
    the tokens of this dp rank's rows."""
    from hsenet_torch.parallel.sp import make_sp_encode_fn

    mesh = _mesh(2, sp=2)
    out = {}
    for name, c in p.items():
        encode = make_sp_encode_fn(c["model"], mesh)
        rows = _dp_rows(c["inputs"], mesh)
        with torch.no_grad():
            out[name] = encode(rows["volume"], rows.get("slices"))
    return out


def case_sp_steps(p):
    """The sp train steps at (dp 2, sp 2) and the port's plain steps on the
    global batch: stage 1, stage 2 (teacher recomputed and cached, and the
    cache's fill over the ring), the causal LM and the VLM."""
    from hsenet_torch.parallel import sp as tsp
    from hsenet_torch.parallel.sharding import shard_params
    from hsenet_torch.train import stage1 as tstage1
    from hsenet_torch.train import stage2 as tstage2
    from hsenet_torch.train.vlm import (
        make_masked_train_step,
        make_vlm_train_step,
        to_training_dtypes,
        vlm_trainable_mask,
    )

    mesh = _mesh(2, sp=2)
    cfg = p["train_cfg"]
    out = {}

    def placed(model):
        model = copy.deepcopy(model)
        to_training_dtypes(model, {n: True for n, _ in model.named_parameters()})
        return shard_params(model, mesh)

    clip = p["clip"]
    rows = _dp_rows(clip["batch"], mesh)
    whole = _tensors(clip["batch"])
    m = placed(clip["stage1"])
    out["stage1"] = _steps(lambda tx: tsp.make_sp_stage1_train_step(m, tx, mesh),
                           m, cfg, rows, 2, mesh=mesh, rng=7)
    plain = copy.deepcopy(clip["stage1"])
    to_training_dtypes(plain, {n: True for n, _ in plain.named_parameters()})
    out["stage1_plain"] = _steps(lambda tx: tstage1.make_stage1_train_step(plain, tx),
                                 plain, cfg, whole, 2, rng=7)
    teacher = clip["stage1"]
    fill = tsp.make_sp_teacher_embed_fn(teacher, mesh)
    host = {k: np.asarray(v)[_dp_slice(clip["batch"], mesh)]
            for k, v in clip["batch"].items()}
    out["fill"] = {k: v.detach() for k, v in fill(host).items()}
    cached = _tensors(tstage2.TeacherCache(fill).attach(host))
    for mode, batch in (("recomputed", rows), ("cached", cached)):
        m = placed(clip["stage2"])
        out[f"stage2_{mode}"] = _steps(
            lambda tx: tsp.make_sp_stage2_train_step(
                m, teacher, clip["cfg2"], tx, mesh, mode == "cached"),
            m, cfg, batch, 2, mesh=mesh, rng=7)
    plain = copy.deepcopy(clip["stage2"])
    to_training_dtypes(plain, {n: True for n, _ in plain.named_parameters()})
    out["stage2_plain"] = _steps(
        lambda tx: tstage2.make_stage2_train_step(plain, teacher, clip["cfg2"], tx),
        plain, cfg, whole, 2, rng=7)

    lm = p["lm"]
    rows, whole = _dp_rows(lm["batch"], mesh), _tensors(lm["batch"])
    m = placed(lm["model"])
    out["lm"] = _steps(lambda tx: tsp.make_sp_causal_lm_train_step(m, tx, mesh),
                       m, cfg, rows, 2, mesh=mesh)
    m = placed(lm["model"])
    out["lm_block"] = _steps(
        lambda tx: tsp.make_sp_causal_lm_train_step(m, tx, mesh, block_q=2),
        m, cfg, rows, 1, mesh=mesh)
    plain = placed_plain = copy.deepcopy(lm["model"])
    to_training_dtypes(plain, {n: True for n, _ in plain.named_parameters()})

    def lm_loss(batch, generator=None):
        from hsenet_torch.train.losses import masked_lm_loss

        lens = batch["attention_mask"].sum(-1).to(torch.int32)
        logits, _ = placed_plain(batch["input_ids"], kv_lens=lens)
        loss, acc = masked_lm_loss(logits, batch["labels"])
        return loss, {"loss": loss, "token_acc": acc}

    out["lm_plain"] = _steps(lambda tx: make_masked_train_step(lm_loss, tx),
                             plain, cfg, whole, 2)

    vlm = p["vlm"]
    rows, whole = _dp_rows(vlm["batch"], mesh), _tensors(vlm["batch"])
    for name, model, batch, make in (
            ("vlm", vlm["model"], rows,
             lambda mm: (lambda tx: tsp.make_sp_vlm_train_step(mm, tx, mesh))),
            ("vlm_plain", vlm["model"], whole,
             lambda mm: (lambda tx: make_vlm_train_step(mm, tx)))):
        mm = copy.deepcopy(model)
        mask = vlm_trainable_mask(mm)
        to_training_dtypes(mm, mask)
        if name == "vlm":
            shard_params(mm, mesh)
        out[name] = _steps(make(mm), mm, cfg, batch, 2, mask=mask,
                           mesh=mesh if name == "vlm" else None)
    return out


def _dp_slice(batch, mesh):
    from hsenet_torch.parallel.mesh import axis_rank, axis_size

    n = len(next(iter(batch.values()))) // axis_size(mesh, "dp")
    r = axis_rank(mesh, "dp")
    return slice(r * n, (r + 1) * n)


def case_pp(p):
    """The pipeline at (dp 1, pp 4) and (dp 2, pp 2): the causal LM's
    logits; its masked-LM loss and gradients (every stage's leaves
    gathered); its train step and the VLM's, each against the port's plain
    step; which leaves each stage holds; the divisibility error."""
    from hsenet_torch.parallel import pipeline as tpp
    from hsenet_torch.parallel.sharding import shard_params
    from hsenet_torch.train.losses import masked_lm_loss
    from hsenet_torch.train.train_state import reduce_gradients
    from hsenet_torch.train.vlm import (
        lm_loss_terms,
        make_masked_train_step,
        make_vlm_train_step,
        to_training_dtypes,
        vlm_trainable_mask,
    )

    out = {}
    lm = p["lm"]
    ids, kv = torch.as_tensor(lm["ids"]), torch.as_tensor(lm["kv_lens"])

    def staged(model, mesh, mask=None):
        model = copy.deepcopy(model)
        to_training_dtypes(model, mask or {n: True for n, _ in model.named_parameters()})
        shard_params(model, mesh)
        return tpp.shard_params_pp(model, mesh)

    mesh4 = _mesh(1, pp=4)
    m = staged(lm["model"], mesh4)
    fwd = tpp.make_pp_causal_lm_forward(m, mesh4, n_micro=2)
    with torch.no_grad():
        out["logits"] = fwd(ids, kv)
    out["held"] = sorted(n for n, _ in m.named_parameters() if ".layers." in n)
    out["specs"] = tpp.make_pp_specs(m)

    mesh = _mesh(2, pp=2)
    m = staged(lm["model"], mesh)
    fwd = tpp.make_pp_causal_lm_forward(m, mesh, n_micro=2)
    rows = _dp_rows({"ids": lm["ids"][:4], "kv_lens": lm["kv_lens"][:4],
                     "labels": lm["labels"][:4]}, mesh)
    # the loss of the global batch, the gradients averaged over dp
    loss, metrics = lm_loss_terms(m, fwd(rows["ids"], rows["kv_lens"]),
                                  rows["labels"])
    names = [n for n, q in m.named_parameters()]
    grads = torch.autograd.grad(loss, [q for _, q in m.named_parameters()])
    grads = reduce_gradients(list(grads), names, m, mesh)
    out["loss"] = metrics["loss"]
    out["grads"] = tpp.gather_stages(m, dict(zip(names, grads)))

    cfg = p["train_cfg"]
    batch = lm["batch"]
    m = staged(lm["model"], mesh)
    out["lm"] = _steps(
        lambda tx: tpp.make_pp_causal_lm_train_step(m, tx, mesh, n_micro=2),
        m, cfg, _dp_rows(batch, mesh), 2, mesh=mesh)
    plain = copy.deepcopy(lm["model"])
    to_training_dtypes(plain, {n: True for n, _ in plain.named_parameters()})

    def lm_loss(b, generator=None):
        lens = b["attention_mask"].sum(-1).to(torch.int32)
        logits, _ = plain(b["input_ids"], kv_lens=lens)
        loss, acc = masked_lm_loss(logits, b["labels"])
        return loss, {"loss": loss, "token_acc": acc}

    out["lm_plain"] = _steps(lambda tx: make_masked_train_step(lm_loss, tx),
                             plain, cfg, _tensors(batch), 2)

    vlm = p["vlm"]
    mask = vlm_trainable_mask(vlm["model"])
    m = staged(vlm["model"], mesh, mask)
    out["vlm"] = _steps(
        lambda tx: tpp.make_pp_vlm_train_step(m, tx, mesh, n_micro=2),
        m, cfg, _dp_rows(vlm["batch"], mesh), 2, mask=mask, mesh=mesh)
    out["vlm_towers_whole"] = sorted(
        n for n, _ in m.named_parameters() if n.startswith("vision_tower.")) == \
        sorted(n for n, _ in vlm["model"].named_parameters()
               if n.startswith("vision_tower."))
    plain = copy.deepcopy(vlm["model"])
    to_training_dtypes(plain, mask)
    out["vlm_plain"] = _steps(lambda tx: make_vlm_train_step(plain, tx), plain,
                              cfg, _tensors(vlm["batch"]), 2, mask=mask)

    try:
        tpp.shard_params_pp(copy.deepcopy(p["odd"]), mesh4)
        out["odd"] = None
    except ValueError as e:
        out["odd"] = str(e)
    return out


def case_clip_clis(p):
    """`case_resume_cli` of each item of `p`."""
    return [case_resume_cli(item) for item in p]


def case_resume_cli(p):
    """Training CLI runs in order, each through `main` with its argv and a
    fresh copy of the model: every run's logged history, final step and
    the keys of the vlm_deltas file it wrote."""
    import importlib

    cli = importlib.import_module(p["cli"])
    if hasattr(cli, "build_vlm_config"):
        cli.build_vlm_config = _without_vlm_dropout(cli.build_vlm_config)
    if p.get("no_slice_dropout"):
        import functools

        import hsenet_torch.cli.train_clip_stage1 as tcli1

        tcli1.ViT3DConfig = functools.partial(tcli1.ViT3DConfig,
                                              slice_dropout_rate=0.0)
    out = []
    for argv in p["runs"]:
        with _recorded_fit() as runs, \
                contextlib.redirect_stdout(open(os.devnull, "w")):
            state = cli.main(argv, device="cpu", model=copy.deepcopy(p["model"]))
        torch.distributed.barrier()  # rank 0 has written the run's files
        deltas = os.path.join(argv[argv.index("--output-dir") + 1], "vlm_deltas")
        out.append({"history": runs[0], "step": state.step,
                    "deltas": sorted(torch.load(deltas, weights_only=True))
                    if os.path.exists(deltas) else None})
    return out


# ---- the CLIs ----

@contextlib.contextmanager
def _recorded_fit():
    import hsenet_torch.train.trainer as ttrainer

    runs, fit = [], ttrainer.Trainer.fit

    def recorded(self, total_steps=None):
        state = fit(self, total_steps)
        runs.append(self.history)
        return state

    ttrainer.Trainer.fit = recorded
    try:
        yield runs
    finally:
        ttrainer.Trainer.fit = fit


def _without_vlm_dropout(build):
    def build_vlm_config(args):
        cfg = build(args)
        return dataclasses.replace(
            cfg,
            vision=dataclasses.replace(cfg.vision, dropout_rate=0.0,
                                       slice_dropout_rate=0.0),
            packer=dataclasses.replace(cfg.packer, dropout_rate=0.0),
            llm=dataclasses.replace(cfg.llm, lora=dataclasses.replace(
                cfg.llm.lora, dropout_rate=0.0)),
        )

    return build_vlm_config


def case_train_cli(p):
    """A training CLI's `main` with the given argv and model: its logged
    history and final step."""
    import importlib

    cli = importlib.import_module(p["cli"])
    if hasattr(cli, "build_vlm_config"):
        cli.build_vlm_config = _without_vlm_dropout(cli.build_vlm_config)
    with _recorded_fit() as runs, \
            contextlib.redirect_stdout(open(os.devnull, "w")):
        state = cli.main(p["argv"], device="cpu", model=p["model"])
    return {"history": runs[0], "step": state.step}


case_train_vlm_cli = case_train_cli


def case_eval_cli(p):
    from hsenet_torch.cli import evaluate

    out = {}
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        for name, argv in p["runs"].items():
            out[name] = evaluate.main(argv, device="cpu")
    return out


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main():
    rank, world, directory = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(2)
    from hsenet_torch.parallel.mesh import init_distributed

    init_distributed("cpu", init_method=f"file://{directory}/rendezvous")
    cases = torch.load(os.path.join(directory, "cases.pt"), weights_only=False)
    results = {}
    for name, payload in cases:
        results[name] = CASES[name](payload)
    torch.save(results, os.path.join(directory, f"out{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
