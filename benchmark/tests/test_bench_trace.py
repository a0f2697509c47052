"""The trace's reduction on a hand-made ``torch.profiler`` event list: the
clock, busy time and idle gaps, the breakdown, and the launch check that
fails a session which dropped kernels."""

import pytest

from benchmark import harness, trace as T

ATTN = 'void oadp::(anonymous namespace)::attention_kernel<2>(Args)'
RESIZE = 'void oadp::(anonymous namespace)::resize_crops_kernel(ResizeArgs)'


def _events():
    # microseconds; the marker at ts 1000 is perf_counter 10.0 s
    x = lambda cat, name, ts, dur, tid=1: dict(ph='X', cat=cat, name=name, ts=ts, dur=dur,  # noqa: E731
                                                tid=tid)
    return [
        x('user_annotation', 'benchmark.clock', 1000, 1),
        x('kernel', ATTN, 2000, 500, 7),
        x('kernel', RESIZE, 2400, 300, 8),  # overlaps the first
        x('gpu_memcpy', 'Memcpy HtoD', 4000, 100, 7),
        x('kernel', ATTN, 6000, 1000, 7),
        x('cpu_op', 'aten::copy_', 4500, 1200),
        x('cpu_op', 'aten::to', 4400, 1400),
        x('cpu_op', 'aten::empty', 4500, 10, 2),  # another thread
    ]


def test_reduction_on_the_host_clock():
    t = T.Trace(_events(), 10.0)
    lo, hi = 10.0, 10.007
    # busy: [1000, 1700] + [3000, 3100] + [5000, 6000] us after the marker
    assert t.busy_s(lo, hi) == pytest.approx(1.8e-3)
    assert t.kernel_s(lo, hi) == pytest.approx(1.8e-3)
    assert t.kernel_s(lo, hi, lambda n: 'resize' in n) == pytest.approx(0.3e-3)
    gaps = t.gaps(lo, hi)
    assert [(round((a - lo) * 1e6), round((b - lo) * 1e6)) for a, b in gaps] == [
        (0, 1000), (1700, 3000), (3100, 5000), (6000, 7000)]
    spans = harness.Spans()
    spans.add('oake.prepare', 10.002, 10.003)
    t.spans = spans
    b = t.breakdown(lo, hi, top=3)
    assert b['device_ops'][0] == [ATTN, pytest.approx(1.5e-3)]
    # the gap 3100-5000 us: the launching thread was in aten::to (outermost)
    assert b['idle_gaps'][0] == ['main:aten::to', pytest.approx(1.9e-3)]
    assert b['idle_gaps'][1][0] == 'span:oake.prepare'
    assert len(b['idle_gaps']) == 3


def test_a_session_that_dropped_kernels_fails():
    t = T.Trace(_events(), 10.0)
    before = dict(fused_surgery_layer=5, resize_crops=1)
    ok = dict(fused_surgery_layer=7, resize_crops=2)
    assert T.check_launches(t, before, ok)['attention_kernel'] == [2, 2]
    with pytest.raises(harness.BenchmarkError, match='attention_kernel'):
        T.check_launches(t, before, dict(fused_surgery_layer=8, resize_crops=2))
    # kernel 3's two-family route also runs attention kernels: left unchecked
    assert 'attention_kernel' not in T.check_launches(
        t, before, dict(fused_surgery_layer=8, resize_crops=2, fused_ln_qkv_attention=1))
