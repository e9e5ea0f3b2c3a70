"""The reductions from a trace to per-layer metrics, on synthetic events."""

import os

import pytest

from nucbench import cells, roofline
from nucbench.trace import Trace, busy, gaps, innermost, merge, named_gaps, top_ops

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reader(name):
    return cells.load_module(cells.reader_path(HERE, "metrics", name), f"t_{name}")


def test_union_counts_overlap_once():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.5, 2.6)]
    assert merge(iv) == [(0.0, 1.5), (2.0, 3.0)]
    assert busy(iv, 0.0, 4.0) == pytest.approx(2.5)
    assert busy(iv, 1.0, 2.5) == pytest.approx(1.0)  # clipped to the window
    assert gaps(iv, 0.0, 4.0) == [(1.5, 2.0), (3.0, 4.0)]
    assert gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_sum_of_durations_would_count_overlap_twice():
    ev = [("k", 0.0, 1.0), ("copy", 0.0, 1.0)]
    t = Trace(ev, (0.0, 2.0), [], {}, {})
    assert t.busy_s() == pytest.approx(1.0)
    assert t.kernel_s() == pytest.approx(2.0)
    assert _reader("device_idle_pct.batch").read(t) == pytest.approx(50.0)


def test_gaps_are_named_by_the_innermost_span():
    spans = [("client.guide", 0.0, 10.0), ("packed_ops.best_match_stream", 1.0, 2.0)]
    assert innermost(spans, [1.5, 5.0, 11.0, 1.0, 2.0]) == [
        "packed_ops.best_match_stream", "client.guide", "outside any span", "packed_ops.best_match_stream",
        "client.guide"]
    named = named_gaps([(1.2, 1.4), (1.5, 1.6), (3.0, 7.0)], spans)
    assert named[0] == ["client.guide (1 gaps)", pytest.approx(4.0)]
    assert named[1] == ["packed_ops.best_match_stream (2 gaps)", pytest.approx(0.3)]


def test_top_ops_sum_by_name():
    assert top_ops([("a", 0, 1), ("b", 1, 3), ("a", 3, 4.5)]) == [["a", 2.5], ["b", 2]]


def _codec_trace(seen):
    ev = [("void encode_b5_kernel<true, false>(...)", 0.0, 0.002), ("void decode_b5_kernel<1, false, false>", 0.002,
          0.003), ("fill", 0.003, 0.0031)][:seen]
    return Trace(ev, (0.0, 0.004), [], {"launches.encode_b5_stream": 1, "launches.decode_b5_stream": 1},
                 {"codec_bound_s": 0.0015})


def test_codec_roofline_and_a_lost_launch():
    assert _reader("codec_roofline").read(_codec_trace(3)) == pytest.approx(50.0)
    assert _reader("codec_roofline").read(_codec_trace(1)) is None  # the profile lost #6
    encode_only = Trace([("void encode_b5_kernel<false, false>(...)", 0.0, 0.002)], (0.0, 0.004), [],
                        {"launches.encode_b5_stream": 1}, {"codec_bound_s": 0.0015})
    assert _reader("codec_roofline").read(encode_only) == pytest.approx(75.0)  # the gather cell's #5 alone


def test_myers_readers():
    ops = int(roofline.INT_INSTR_PER_S * 0.001)
    ev = [("void myers_lanes<1, 1, true, true>(Args, int)", 0.0, 0.004), ("peq build", 0.004, 0.010)]
    t = Trace(ev, (0.0, 0.02), [], {"launches.myers_scan": 1}, {"myers_floor_ops": ops, "queries": 2})
    for name in ("myers_roofline.batch", "myers_roofline.stream"):
        assert _reader(name).read(t) == pytest.approx(25.0, rel=1e-6)
    assert _reader("align_glue_pct.batch").read(t) == pytest.approx(60.0)
    assert _reader("device_ops_per_query").read(t) == pytest.approx(1.0)
    assert _reader("device_idle_pct.query").read(t) == pytest.approx(50.0)
    empty = Trace([], (0.0, 1.0), [], {}, {})
    for name in ("myers_roofline.batch", "align_glue_pct.batch", "device_ops_per_query", "device_idle_pct.query",
                 "allgather_gbs", "codec_roofline", "enqueue_us_per_batch"):
        assert _reader(name).read(empty) is None


def test_allgather_and_enqueue_readers():
    t = Trace([("ncclDevKernel_AllGather_RING_LL(x)", 0.0, 0.001)], (0.0, 0.002),
              [("probe.enqueue", 1.0, 1.0004), ("probe.enqueue", 2.0, 2.0002), ("other", 0.0, 5.0)], {},
              {"allgather_recv_bytes": 3e8, "probe.round_trips": 6})
    assert _reader("allgather_gbs").read(t) == pytest.approx(300.0)
    assert _reader("enqueue_us_per_batch").read(t) == pytest.approx(100.0)
