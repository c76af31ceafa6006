"""The trace's reduction on a hand-made profile: busy time as the union of
device intervals, idle gaps labelled by the host operation around them,
attention work as the kernels launched under the attention operations."""

from collections import namedtuple
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark.trace import SPAN, reduce, union

Kernel = namedtuple("Kernel", "name device duration")


def event(name, start, end, *, device=False, thread=1, parent=None, kernels=()):
    return SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end), is_async=False,
        thread=thread, cpu_parent=parent, kernels=list(kernels),
        is_user_annotation=False)


def profile():
    span = event(SPAN, 0, 100)
    fwd = event("hsenet_torch::flash_fwd", 10, 20, parent=span,
                kernels=[Kernel("flash_fwd_wgmma_kernel", 0, 8)])
    node = event("autograd::engine::evaluate_function: _FlashAttentionBackward",
                 50, 70, thread=2)
    mul = event("aten::mul", 52, 54, thread=2, parent=node,
                kernels=[Kernel("elementwise_kernel<mul>", 0, 3)])
    mm = event("aten::mm", 30, 40, parent=span,
               kernels=[Kernel("nvjet_tst_256x128_gemm", 0, 10)])
    loader = event("aten::copy_", 75, 95, thread=9)
    host = [span, fwd, node, mul, mm, loader]
    device = [event("flash_fwd_wgmma_kernel", 12, 20, device=True),
              event("nvjet_tst_256x128_gemm", 32, 42, device=True),
              event("elementwise_kernel<mul>", 55, 58, device=True),
              event("Memcpy HtoD (Pinned -> Device)", 80, 90, device=True),
              event("elementwise_kernel<add>", 40, 45, device=True)]
    return SimpleNamespace(events=lambda: host + device)


def test_union_merges_overlaps():
    assert union([(5, 9), (0, 2), (1, 3), (9, 10)]) == [[0, 3], [5, 10]]


def test_reduce_splits_the_device_time():
    s = reduce(profile(), steps=2, skip_threads={9})
    assert s.window_s == pytest.approx(100e-6)
    # busy: 12-20, 32-45, 55-58, 80-90
    assert s.busy_s == pytest.approx(34e-6)
    assert s.launches == 4  # the copy is no kernel
    assert s.attention_us == 8 + 3
    assert s.gemm_us == 10
    assert s.glue_us == 5  # the add; the mul is attention work
    labels = dict(s.idle_gaps)
    # the gaps' middles: 6, 26 and 95 lie in no operation but the span (the
    # loader's thread is skipped); 50 and 69 in the backward node
    assert labels["python"] == pytest.approx((12 + 12 + 10) * 1e-6)
    node = "autograd::engine::evaluate_function: _FlashAttentionBackward"
    assert labels[node] == pytest.approx((10 + 22) * 1e-6)
    assert s.device_ops[0][0] == "nvjet_tst_256x128_gemm"
