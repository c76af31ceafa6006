"""The port's spans (`hsenet_torch.utils.profiling.span`) on the CPU: off
they are one shared no-op and record nothing; on they record the tree of
the training path's phases and modules with parents and host times, and
inside a torch.profiler session they are the ancestors of the operations
they cover; the prefetcher, the Trainer's profile window and `trace` carry
them; and they change no number a step computes, nor a traced program.
"""

import json
import threading

import numpy as np
import pytest
import torch

from hsenet_torch.configs import (
    BertConfig,
    CLIPConfig,
    LoRAConfig,
    PackerConfig,
    Phi3Config,
    TrainConfig,
    ViT3DConfig,
    VLMConfig,
)
from hsenet_torch.data.prefetch import DevicePrefetcher
from hsenet_torch.models import init_random_
from hsenet_torch.models.clip import CLIPModel
from hsenet_torch.models.mllm import HSENetVLM
from hsenet_torch.train.stage1 import make_stage1_train_step
from hsenet_torch.train.train_state import TrainState, make_optimizer
from hsenet_torch.train.trainer import Trainer
from hsenet_torch.train.vlm import make_vlm_train_step, vlm_trainable_mask
from hsenet_torch.utils import profiling
from hsenet_torch.utils.profiling import collect, span, spans_on

torch.set_num_threads(1)

VIT = ViT3DConfig(image_size=(4, 16, 16), patch_size=(2, 8, 8), hidden_size=16,
                  mlp_dim=32, num_layers=2, num_heads=2, num_slices=2,
                  slice_feature_dim=16)
CLIP = CLIPConfig(vision=VIT, text=BertConfig(
    vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
    intermediate_size=32, max_position_embeddings=16),
    projection_dim=16, max_text_len=8)
VLM = VLMConfig(
    vision=VIT,
    packer=PackerConfig(grid=(2, 2, 2), kernel=(1, 2, 2), in_dim=16, out_dim=32,
                        dropout_rate=0.1),
    llm=Phi3Config(vocab_size=64, hidden_size=32, intermediate_size=64,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
                   tie_word_embeddings=True,
                   lora=LoRAConfig(rank=2, alpha=4, dropout_rate=0.05)))
TRAIN = TrainConfig(total_steps=10, learning_rate=1e-3, warmup_ratio=0.0)
B = 4


@pytest.fixture(autouse=True)
def no_records_left():
    collect()
    yield
    assert not profiling._on, "a test left spans on"
    collect()


def tree(records):
    """{record: [children in opening order]} and the roots."""
    children = {id(r): [] for r in records}
    roots = []
    for r in records:
        (children[id(r.parent)] if r.parent is not None else roots).append(r)
    return children, roots


def names(records):
    return [r.name for r in records]


def clip_run(seed=0):
    """A toy stage-1 CLIP with remat, its step and two batches."""
    gen = torch.Generator().manual_seed(seed)
    model = init_random_(CLIPModel(CLIP, device="cpu", remat=True), gen)
    model.train()
    tx = make_optimizer(TRAIN)
    state = TrainState.create(model, tx)
    rng = np.random.default_rng(seed)
    batches = [{"image": torch.as_tensor(rng.random((B, 1, 4, 16, 16), np.float32)),
                "input_ids": torch.as_tensor(rng.integers(3, 64, (B, 8))),
                "attention_mask": torch.ones(B, 8, dtype=torch.int64)}
               for _ in range(2)]
    return make_stage1_train_step(model, tx), state, batches


def vlm_run(seed=0, grad_accum=2):
    """A toy VLM with remat and dropout, its step over `grad_accum`
    microbatches and two batches."""
    gen = torch.Generator().manual_seed(seed)
    model = init_random_(HSENetVLM(VLM, dtype=torch.float32, device="cpu",
                                   remat=True), gen)
    model.train()
    mask = vlm_trainable_mask(model)
    tx = make_optimizer(TRAIN, trainable_mask=mask)
    state = TrainState.create(model, tx)
    rng = np.random.default_rng(seed)
    seq, n_img = 24, VLM.num_image_tokens
    batches = []
    for _ in range(2):
        ids = rng.integers(3, 64, (B, seq))
        labels = ids.copy()
        labels[:, :n_img + 2] = -100
        batches.append({
            "input_ids": torch.as_tensor(ids),
            "labels": torch.as_tensor(labels),
            "attention_mask": torch.ones(B, seq, dtype=torch.int64),
            "image": torch.as_tensor(rng.random((B, 1, 4, 16, 16), np.float32)),
            "image_2d": torch.as_tensor(rng.random((B, 2, 16), np.float32))})
    return make_vlm_train_step(model, tx, grad_accum=grad_accum), state, batches


def test_off_is_the_shared_noop():
    assert span("a") is span("train.step") is profiling._OFF
    with span("a") as inside:
        assert inside is None
    assert collect() == []


def test_on_records_the_nested_tree_with_host_times():
    with spans_on():
        with span("a"):
            with span("b"):
                pass
            with span("c"):
                worker = threading.Thread(target=lambda: span("d").__enter__())
                worker.start()
                worker.join(timeout=10)
        assert not worker.is_alive()
    assert span("a") is profiling._OFF
    records = collect()
    assert collect() == []
    a, b, c, d = records
    assert names(records) == ["a", "b", "c", "d"]
    assert a.parent is None and b.parent is a and c.parent is a
    assert d.parent is None and d.thread != a.thread  # its own thread's stack
    assert a.thread == b.thread == threading.get_ident()
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= c.end_ns <= a.end_ns
    assert a.start_event is None and a.host_ms() >= 0


def test_spans_on_nests_and_restores():
    with spans_on():
        with spans_on():
            pass
        assert profiling._on
    assert not profiling._on


def test_span_events_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with spans_on(events=True):
            pass


def test_spans_are_ancestors_in_a_profiler_session():
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(32, 32)
    with spans_on(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with span("inner"):
                torch.mm(x, x)
            torch.add(x, x)
    collect()
    events = prof.events()

    def ancestors(e):
        out = []
        while e.cpu_parent is not None:
            e = e.cpu_parent
            out.append(e.name)
        return out

    mm = next(e for e in events if e.name == "aten::mm")
    add = next(e for e in events if e.name == "aten::add")
    assert ancestors(mm)[:2] == ["inner", "outer"]
    assert ancestors(add)[0] == "outer"


def test_clip_step_records_its_phases_and_modules():
    step, state, batches = clip_run()
    with spans_on():
        step(state, batches[0], 7)
    records = collect()
    children, roots = tree(records)
    assert names(roots) == ["train.step"]
    phases = children[id(roots[0])]
    assert names(phases) == ["train.forward", "train.backward", "train.optimizer"]
    forward, backward, optimizer = phases
    assert sorted(names(children[id(forward)])) == [
        "model.head_loss", "model.text", "model.vision"]
    assert children[id(backward)] == [] and children[id(optimizer)] == []


def test_vlm_step_records_each_microbatch():
    step, state, batches = vlm_run(grad_accum=2)
    with spans_on():
        step(state, batches[0], 7)
    records = collect()
    children, roots = tree(records)
    assert names(roots) == ["train.step"]
    phases = children[id(roots[0])]
    assert names(phases) == ["train.forward", "train.backward"] * 2 + ["train.optimizer"]
    for forward in phases[0:4:2]:
        # the embedding, the towers, the packers, the decoder, the head and
        # the loss, each once a microbatch
        assert names(children[id(forward)]) == [
            "model.llm", "model.vision", "model.projector", "model.llm",
            "model.head_loss", "model.head_loss"]


def test_prefetcher_records_data_wait():
    loader = [{"x": np.full(3, i, np.float32)} for i in range(4)]
    with spans_on():
        got = [b["x"][0].item() for b in DevicePrefetcher(loader, depth=2)]
    records = collect()
    assert got == [0.0, 1.0, 2.0, 3.0]
    # one a batch, and one that meets the end of the loader
    assert names(records) == ["data.wait"] * 5
    assert all(r.thread == threading.get_ident() for r in records)


def trace_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trainer_profile_trace_holds_the_spans(tmp_path):
    step, state, batches = clip_run()
    cfg = TrainConfig(total_steps=3, learning_rate=1e-3, warmup_ratio=0.0,
                      log_every=1, device_prefetch=2,
                      profile_dir=str(tmp_path / "prof"), profile_start=1,
                      profile_stop=2)
    host = [{k: v.numpy() for k, v in batches[i % 2].items()} for i in range(3)]
    trainer = Trainer(step, state, lambda: host, cfg)
    trainer.fit()
    [path] = (tmp_path / "prof").glob("steps_1-2.*.json")
    found = trace_names(path)
    assert {"data.wait", "train.step", "train.forward", "train.backward",
            "train.optimizer", "model.vision", "model.text",
            "model.head_loss"} <= found
    assert not profiling._on and collect() == []  # nobody asked for the records


def test_trace_holds_the_spans(tmp_path):
    with profiling.trace(str(tmp_path)) as path:
        with span("train.step"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert "train.step" in trace_names(path)
    assert not profiling._on and collect() == []


@pytest.mark.parametrize("run", [clip_run, vlm_run])
def test_spans_change_no_number(run):
    """Two steps with spans off and on (records, and a profiler session
    opening `record_function`): the same losses and parameters, bit for
    bit."""
    from torch.profiler import ProfilerActivity, profile

    out = []
    for on in (False, True):
        step, state, batches = run()
        losses = []
        if on:
            with spans_on(), profile(activities=[ProfilerActivity.CPU]):
                for i, b in enumerate(batches):
                    state, m = step(state, b, 11 + i)
                    losses.append(m["loss"])
            assert collect()
        else:
            for i, b in enumerate(batches):
                state, m = step(state, b, 11 + i)
                losses.append(m["loss"])
        out.append((losses, {n: p.detach().clone() for n, p in state.params.items()}))
    (l0, p0), (l1, p1) = out
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert p0.keys() == p1.keys()
    assert all(torch.equal(p0[n], p1[n]) for n in p0)


def test_traced_programs_hold_no_span():
    """torch.export and torch.compile see the off branch, spans on or
    off: the exported graph is the same and records nothing."""
    from torch.profiler import ProfilerActivity, profile

    class Toy(torch.nn.Module):
        def forward(self, x):
            with span("model.llm"):
                return torch.relu(x) * 2

    x = torch.randn(4, 4)
    off = str(torch.export.export(Toy(), (x,), strict=False).graph)
    with spans_on(), profile(activities=[ProfilerActivity.CPU]):
        on = str(torch.export.export(Toy(), (x,), strict=False).graph)
        compiled = torch.compile(Toy(), backend="eager", fullgraph=True)(x)
        records = collect()
    assert on == off and "record_function" not in on
    assert torch.equal(compiled, Toy()(x)) and records == []
