"""The attribution of a traced step's kernels to the program's spans
(`benchmark/spans.py`) on a hand-made profile: through a module span's
ancestry, through the backward node's sequence link, through the
`train.backward` interval; the outside remainder; idle gaps by span and
`trace.reduce`'s labels unchanged by spans; the span steps' event times;
and each span metric's `read` on toy values."""

from collections import namedtuple
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import spans as bspans
from benchmark.harness import metric_reader, run
from benchmark.spans import SPAN_METRICS, SpanSummary, attribute, read_span_steps, without_spans
from benchmark.tests.toy import toy_cell
from benchmark.trace import SPAN, reduce

Kernel = namedtuple("Kernel", "name device duration")
MAIN, ENGINE, LOADER = 1, 2, 9
NODE = "autograd::engine::evaluate_function: "


def event(name, start, end, *, device=False, thread=MAIN, parent=None,
          kernels=(), seq=-1, fwd_thread=0):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end), is_async=False,
        thread=thread, cpu_parent=parent, kernels=[Kernel(n, 0, d) for n, d in kernels],
        is_user_annotation=False, sequence_nr=seq, fwd_thread=fwd_thread)


def k(name, duration):
    return (name, duration)


def profile(with_spans=True):
    """Two forward modules, a backward on the engine thread (a node linked
    to its forward op on the training thread's id, one linked under
    another id space, one unlinked), the optimizer, the loader's copy, a
    kernel linked to no operation and one linked twice (to a runtime call
    outside any operation too, as the profiler links them). Without spans, the same operations with
    the spans taken out of the tree."""
    host = []

    def add(name, start, end, parent=None, **kw):
        if not with_spans and name in bspans.SPANS:
            return parent
        e = event(name, start, end, parent=parent, **kw)
        host.append(e)
        return e

    window = add(SPAN, 0, 200)
    wait = add("data.wait", 1, 4, window)
    # a runtime call outside any operation whose id is the forward mm's
    add("cudaStreamWaitEvent", 2, 3, wait, kernels=[k("gemm_fwd", 10)])
    step = add("train.step", 5, 190, window)
    fwd = add("train.forward", 10, 60, step)
    vision = add("model.vision", 12, 40, fwd)
    add("aten::mm", 14, 20, vision, seq=100, kernels=[k("gemm_fwd", 10)])
    head = add("model.head_loss", 42, 58, fwd)
    add("aten::add", 44, 46, head, seq=101, kernels=[k("add_kernel", 4)])
    add("aten::where", 59, 60, fwd, kernels=[k("where_kernel", 2)])
    add("train.backward", 62, 140, step)
    mm_node = add(NODE + "MmBackward0", 70, 90, thread=ENGINE, seq=100, fwd_thread=MAIN)
    add("aten::mm", 72, 80, mm_node, thread=ENGINE, seq=7, kernels=[k("gemm_bwd", 12)])
    add("aten::mul", 81, 83, mm_node, thread=ENGINE, kernels=[k("recompute_mul", 4)])
    add_node = add(NODE + "AddBackward0", 84, 90, thread=ENGINE, seq=101, fwd_thread=42)
    add("aten::neg", 85, 86, add_node, thread=ENGINE, kernels=[k("neg_kernel", 2)])
    lost = add(NODE + "SumBackward0", 92, 100, thread=ENGINE, seq=555, fwd_thread=MAIN)
    add("aten::sum", 93, 95, lost, thread=ENGINE, kernels=[k("sum_kernel", 3)])
    add("aten::fill_", 150, 151, thread=ENGINE, kernels=[k("fill_kernel", 1)])
    opt = add("train.optimizer", 145, 185, step)
    add("aten::mul_", 150, 152, opt, kernels=[k("adam_kernel", 5), k("Memset (Device)", 1)])
    add("aten::copy_", 100, 120, thread=LOADER, kernels=[k("Memcpy HtoD (Pinned -> Device)", 10)])
    device = [event(n, s, e, device=True) for n, s, e in (
        ("gemm_fwd", 15, 25), ("add_kernel", 45, 49), ("where_kernel", 60, 62),
        ("gemm_bwd", 75, 87), ("recompute_mul", 88, 92), ("neg_kernel", 92, 94),
        ("sum_kernel", 96, 99), ("Memcpy HtoD (Pinned -> Device)", 105, 115),
        ("fill_kernel", 152, 153), ("adam_kernel", 155, 160),
        ("Memset (Device)", 160, 161), ("unlinked_kernel", 186, 188))]
    return SimpleNamespace(events=lambda: host + device)


def summary():
    return attribute(profile(), steps=1)


def test_attribution_through_a_module_span_ancestry():
    s = summary()
    # the forward gemm under model.vision, the add under model.head_loss, the
    # where under train.forward, the optimizer's kernel under train.optimizer
    assert s.rules["ancestor"] == 4
    assert s.kernel_us["train.forward"] == 2
    assert s.kernel_us["train.optimizer"] == 5 and s.launches["train.optimizer"] == 1
    assert s.busy_us["train.optimizer"] == 6  # the fill is busy time, no kernel


def test_attribution_through_the_backward_nodes_sequence_link():
    s = summary()
    # MmBackward0's gemm and the recompute under it follow seq 100 to the
    # forward mm (fwd_thread is the training thread's id); AddBackward0's
    # fwd_thread is of another id space, so seq 101 is looked up on the
    # training thread
    assert s.kernel_us["model.vision"] == 10 + 12 + 4
    assert s.launches["model.vision"] == 3
    assert s.rules["sequence"] == 2 and s.rules["sequence_main"] == 1
    assert s.kernel_us["model.head_loss"] == 4 + 2


def test_attribution_through_the_backward_interval():
    s = summary()
    assert s.kernel_us["train.backward"] == 3 and s.rules["interval"] == 1


def test_outside_remainder_sums_to_the_kernel_total():
    s = summary()
    assert s.kernel_total_us == 10 + 4 + 2 + 12 + 4 + 2 + 3 + 1 + 5 + 2
    assert s.launches_total == 10
    # the engine's fill after every backward span and the unlinked kernel
    assert s.kernel_us[bspans.OUTSIDE] == 1 + 2 and s.launches[bspans.OUTSIDE] == 2
    assert sum(s.kernel_us.values()) == pytest.approx(s.kernel_total_us)
    assert sum(s.launches.values()) == s.launches_total
    assert reduce(profile(), 1, skip_threads={LOADER}).launches == s.launches_total
    assert s.unmatched == [("unlinked_kernel", -1, "")]
    assert "data.wait" not in s.launches  # the runtime call holds no kernel
    covered = 26 + 6 + 5
    assert bspans.coverage_pct(s) == pytest.approx(100 * covered / s.kernel_total_us)


def test_idle_gaps_by_innermost_span():
    gaps = {name: sec * 1e6 for name, sec in summary().idle_gaps}
    assert gaps == pytest.approx({
        "train.step": 15, "model.vision": 20, "model.head_loss": 11,
        "train.backward": 13 + 1 + 2 + 6 + 37,
        "train.optimizer": 2 + 25, "none": 12})


def test_idle_gap_labels_are_unchanged_by_spans():
    plain = reduce(profile(with_spans=False), 1, skip_threads={LOADER})
    spanned = reduce(without_spans(profile()), 1, skip_threads={LOADER})
    assert spanned.idle_gaps == plain.idle_gaps
    assert (spanned.busy_s, spanned.launches, spanned.glue_us) == (
        plain.busy_s, plain.launches, plain.glue_us)
    # read with the spans, the labels would name them
    raw = dict(reduce(profile(), 1, skip_threads={LOADER}).idle_gaps)
    assert "train.backward" in raw and "train.backward" not in dict(plain.idle_gaps)


class FakeEvent:
    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def record(name, start, end, thread=MAIN, host=(0, 0)):
    return SimpleNamespace(
        name=name, thread=thread, start_event=FakeEvent(start),
        end_event=FakeEvent(end), host_ms=lambda: host[1] - host[0],
        device_ms=lambda: end - start)


def test_span_steps_times():
    records = [record("data.wait", 0, 0, host=(0, 1.5)), record("train.step", 10, 95),
               record("train.optimizer", 80, 90),
               record("data.wait", 0, 0, host=(0, 0.5)), record("train.step", 100, 180),
               record("train.optimizer", 170, 178)]
    s = read_span_steps(SpanSummary(steps=1), records)
    assert s.span_steps == 2
    assert s.step_event_ms == [90, 80]  # to the next start; the last to its end
    assert s.optimizer_event_ms == [10, 8]
    assert s.wait_host_ms == 1.0


def toy_context():
    s = SpanSummary(
        steps=2, kernel_us={"model.vision": 6000, "model.text": 2000,
                            "model.projector": 1000, "model.llm": 8000,
                            "model.head_loss": 3000, "train.optimizer": 4000},
        launches={"model.vision": 10, "model.text": 5, "model.projector": 3,
                  "model.llm": 9, "model.head_loss": 2, "train.optimizer": 300},
        busy_us={"train.optimizer": 5000}, step_event_ms=[40.0, 60.0],
        optimizer_event_ms=[9.0, 11.0], wait_host_ms=1.25, span_steps=2)
    trace = SimpleNamespace(steps=2, busy_s=0.06)
    return SimpleNamespace(spans=s, trace=trace)


EXPECTED = {
    "vision_ms_per_step.train": 3.0, "text_ms_per_step.train": 1.0,
    "projector_ms_per_step.train": 0.5, "llm_ms_per_step.train": 4.0,
    "head_loss_ms_per_step.train": 1.5, "optimizer_ms_per_step.train": 2.0,
    "optimizer_launches_per_step.train": 150.0,
    "optimizer_idle_ms_per_step.train": 10.0 - 2.5,
    "device_idle_untraced_pct.train": 100 * (1 - 30.0 / 50.0),
    "prefetch_wait_ms_per_step.train": 1.25,
}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_metric_reads_toy_values(name):
    read = metric_reader(name)
    assert read(toy_context()) == pytest.approx(EXPECTED[name])
    # a run whose program has no spans reads nothing, and raises nothing
    assert read(SimpleNamespace(trace=toy_context().trace)) is None
    assert read(SimpleNamespace(spans=SpanSummary(steps=1), trace=None)) is None


def test_a_toy_run_with_spans_on_the_cpu():
    """The driver on the CPU: the profiled steps attribute (no kernels on
    the CPU), and the cell's own readers still read."""
    result = bspans.run("clip-s1-b24", 5, 0.1, device="cpu",
                        cell=toy_cell("clip-s1-b24"))
    assert "input_wait_ms_per_step.train" in result["metrics"]
    assert result["coverage_pct"] == 0.0


def test_the_harness_run_is_unchanged_by_spans():
    """A traced harness run never turns spans on, and keeps no record."""
    from hsenet_torch.utils import profiling

    run("clip-s1-b24", 5, 0.1, True, device="cpu", cell=toy_cell("clip-s1-b24"))
    assert not profiling._on and profiling.collect() == []
