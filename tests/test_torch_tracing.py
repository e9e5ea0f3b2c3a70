"""The port's span recorder (``utils/tracing.py``), the spans of the
one-stream Myers path (``ops/align.py``) and those of the parallel layer
(``parallel/mesh.py``, ``parallel/data_parallel.py``), on the CPU: when it
records, how spans nest within a thread, its bound, the seven steps of a
``best_match_stream`` call, the steps of a data-parallel encode and of a
gather over a gloo group, and that it changes no result and puts nothing
into the profiler's stream."""

import collections
import os
import sys
import threading
import tokenize

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cute_nucleotides_tpu_torch.ops import align, native
from cute_nucleotides_tpu_torch.parallel import data_parallel, mesh
from cute_nucleotides_tpu_torch.utils import tracing

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cute_nucleotides_tpu_torch")
STEPS = ("align.stream.peq", "align.stream.plan", "align.stream.launch", "align.stream.copy",
         "align.stream.reduce")


@pytest.fixture(autouse=True)
def fresh():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _record(*names):
    for name in names:
        with tracing.span(name):
            pass


def _stream(codec: str, n: int = 3000, seed: int = 7):
    """``(call, words, n, query)`` for a planted stream of ``codec``."""
    rng = np.random.default_rng(seed)
    text = bytearray(rng.choice(np.frombuffer(b"ACGTN" if codec == "b5" else b"ACGT", np.uint8), n).tobytes())
    text[n // 2: n // 2 + 15] = b"GATTACAGATTTACA"
    if codec == "b5":
        words = np.ascontiguousarray(native.n_to_bits2(bytes(text))).view(np.uint32)
        return align.best_match_stream_b5, torch.from_numpy(words), n, b"GATNACAG?TTACA"
    words = np.ascontiguousarray(native.n_to_bits(bytes(text))).view(np.uint32)
    return align.best_match_stream, torch.from_numpy(words), n, b"GATTACAGNTTACA"


def test_off_by_default_records_nothing():
    assert tracing.span("x") is tracing.span("y")  # the one shared no-op
    _record("x")
    call, words, n, q = _stream("2bit")
    call(words, n, q)
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_on_under_a_profile_and_under_enable_then_off():
    with profile(activities=[ProfilerActivity.CPU]):
        _record("in_profile")
    _record("after_profile")
    tracing.enable()
    _record("enabled")
    tracing.disable()
    _record("after_disable")
    assert [s[0] for s in tracing.spans()] == ["in_profile", "enabled"]


def test_nesting_parent_and_call_id_per_thread():
    tracing.enable()
    ready = threading.Barrier(2, timeout=10)

    def work(tag):
        with tracing.span(f"{tag}.top"):
            ready.wait()  # both threads hold an open top span at once
            with tracing.span(f"{tag}.child"):
                with tracing.span(f"{tag}.grandchild"):
                    pass
            with tracing.span(f"{tag}.second"):
                pass
        with tracing.span(f"{tag}.next"):
            pass

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    got = tracing.spans()
    at = {s[0]: i for i, s in enumerate(got)}
    for tag in "ab":
        top, child, grand, second, nxt = (got[at[f"{tag}.{k}"]]
                                          for k in ("top", "child", "grandchild", "second", "next"))
        assert top[3] == -1 and nxt[3] == -1
        assert child[3] == at[f"{tag}.top"] and second[3] == at[f"{tag}.top"]
        assert grand[3] == at[f"{tag}.child"]
        assert top[4] == child[4] == grand[4] == second[4] != nxt[4]
        assert len({s[5] for s in (top, child, grand, second, nxt)}) == 1
        assert all(s[1] <= s[2] for s in (top, child, grand, second, nxt))
        assert top[1] <= child[1] <= grand[1] <= grand[2] <= child[2] <= second[1] <= second[2] <= top[2]
    assert got[at["a.top"]][4] != got[at["b.top"]][4] and got[at["a.top"]][5] != got[at["b.top"]][5]


def test_a_raising_block_closes_its_span():
    tracing.enable()
    with pytest.raises(ValueError):
        with tracing.span("outer"):
            raise ValueError("x")
    _record("after")
    outer, after = tracing.spans()
    assert outer[2] >= outer[1] and after[3] == -1 and after[4] != outer[4]


def test_bound_keeps_the_oldest_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.enable()
    _record("s0", "s1", "s2", "s3", "s4")
    assert [s[0] for s in tracing.spans()] == ["s0", "s1", "s2"] and tracing.dropped() == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0
    with tracing.span("p"):
        tracing.clear()  # the open parent is forgotten: its child reads -1
        _record("c")
    assert [(s[0], s[3]) for s in tracing.spans()] == [("c", -1)]


def test_threads_lose_no_span_and_no_drop(monkeypatch):
    """More threads than cores and a short switch interval: every span is
    either kept or counted as dropped, and the kept ones nest per thread."""
    monkeypatch.setattr(tracing, "CAPACITY", 10_000)
    tracing.enable()
    threads, each = 16, 1000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=_work, args=(each,)) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
            assert not w.is_alive()
    finally:
        sys.setswitchinterval(old)
    got = tracing.spans()
    assert len(got) == 10_000 and len(got) + tracing.dropped() == threads * each
    for name, s, e, parent, call, thread in got:
        if parent >= 0:
            assert got[parent][5] == thread and got[parent][4] == call and got[parent][0] == "outer"


def _work(n: int) -> None:
    """``n`` spans: half flat, half as ``outer`` around one ``inner``."""
    _record(*["flat"] * (n // 2))
    for _ in range(n // 4):
        with tracing.span("outer"):
            _record("inner")


@pytest.mark.parametrize("codec", ("2bit", "b5"))
def test_stream_call_records_each_step(codec):
    call, words, n, q = _stream(codec)
    tracing.enable()
    for _ in range(2):
        call(words, n, q)
    got = tracing.spans()
    tops = [i for i, s in enumerate(got) if s[0] == "align.stream"]
    assert len(tops) == 2 and all(got[i][3] == -1 for i in tops)
    assert got[tops[0]][4] != got[tops[1]][4]
    for top in tops:
        mine = [s for s in got if s[4] == got[top][4]]
        names = collections.Counter(s[0] for s in mine)
        assert names == {"align.stream": 1, "align.stream.readback": 2, **dict.fromkeys(STEPS, 1)}
        index = {s[0]: got.index(s) for s in mine}
        for s in mine:
            if s[0] == "align.stream.copy":  # enqueued between the launch's inputs, where it always was
                assert s[3] == index["align.stream.launch"]
            elif s[0] != "align.stream":
                assert s[3] == top
            assert got[top][1] <= s[1] <= s[2] <= got[top][2]


@pytest.mark.parametrize("codec", ("2bit", "b5"))
def test_stream_results_equal_with_tracing_on_and_off(codec):
    call, words, n, q = _stream(codec, n=5000, seed=11)
    off = [call(words, length, query) for length in (n, n - 13, 1) for query in (q, q[:5])]
    tracing.enable()
    on = [call(words, length, query) for length in (n, n - 13, 1) for query in (q, q[:5])]
    assert on == off


@pytest.mark.parametrize("codec", ("2bit", "b5"))
def test_stream_errors_and_the_empty_text_leave_spans_closed(codec):
    call, words, n, q = _stream(codec)
    tracing.enable()
    assert call(words, 0, q) == (len(q), 0)
    with pytest.raises(ValueError, match="capacity"):
        call(words, 10**9, q)
    got = tracing.spans()
    assert all(s[2] >= s[1] for s in got)
    assert [s[0] for s in got if s[3] == -1] == ["align.stream", "align.stream"]
    _record("after")
    assert tracing.spans()[-1][3] == -1


def _profiled_events(call, words, n, q) -> collections.Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            call(words, n, q)
    return collections.Counter(ev.name() for ev in prof.profiler.kineto_results.events())


@pytest.mark.parametrize("codec", ("2bit", "b5"))
def test_recorder_puts_nothing_into_the_profile(codec, monkeypatch):
    call, words, n, q = _stream(codec)
    call(words, n, q)  # warm
    with_recorder = _profiled_events(call, words, n, q)
    assert sum(s[0] == "align.stream" for s in tracing.spans()) == 3  # it did record inside the profile
    monkeypatch.setattr(tracing, "span", lambda name: tracing._OFF)
    without = _profiled_events(call, words, n, q)
    assert with_recorder == without and sum(without.values()) > 0


@pytest.mark.parametrize("path", ("utils/tracing.py", "ops/align.py", "parallel/mesh.py"))
def test_no_profiler_range_sync_or_event_in_the_source(path):
    """No name in the code (docstrings and comments aside) opens a profiler
    range, synchronizes or makes a CUDA event."""
    with open(os.path.join(PKG, path)) as f:
        names = {tok.string for tok in tokenize.generate_tokens(f.readline) if tok.type == tokenize.NAME}
    for word in ("record_function", "RecordFunction", "nvtx", "synchronize", "Event"):
        assert not [name for name in names if word in name], (path, word)


# --- the parallel layer, over a gloo group of this process alone ------------------

GATHER = ("mesh.all_gather.stage", "mesh.all_gather.collective")


@pytest.fixture
def group(tmp_path):
    """A one-rank gloo group in this process, holding two logical CPU
    shards, and a (2, 1) mesh over them: every collective runs over the
    group, as on a mesh across processes."""
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        yield mesh.make_mesh(2, 1, devices=mesh.devices([torch.device("cpu")] * 2))
    finally:
        torch.distributed.destroy_process_group()


def _reads(rows: int = 6, length: int = 135, seed: int = 5) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice(np.frombuffer(b"ACGTNacgtn", np.uint8), (rows, length)))


def _family(got, top: int) -> dict:
    """``{name: [spans]}`` of the spans below ``got[top]``, each with its
    parent's name."""
    out = collections.defaultdict(list)
    for s in got:
        if s[4] == got[top][4] and s is not got[top]:
            out[s[0]].append((s, got[s[3]][0]))
    return out


def test_data_parallel_encode_records_its_steps(group):
    x = _reads()
    tracing.enable()
    for _ in range(2):
        data_parallel.data_parallel_encode(x, mesh=group, codec="base5", gather=True)
    data_parallel.data_parallel_encode(x, mesh=group, codec="base5")  # no gather: no collective
    got = tracing.spans()
    tops = [i for i, s in enumerate(got) if s[0] == "dp.encode"]
    assert len(tops) == 3 and all(got[i][3] == -1 for i in tops)
    for n, top in enumerate(tops):
        fam = _family(got, top)
        want = {"dp.encode.codec": 1}
        if n < 2:
            want.update({"mesh.all_gather": 1, **dict.fromkeys(GATHER, 1)})
        assert {k: len(v) for k, v in fam.items()} == want
        assert fam["dp.encode.codec"][0][1] == "dp.encode"
        if n < 2:
            assert fam["mesh.all_gather"][0][1] == "dp.encode"
            assert all(fam[k][0][1] == "mesh.all_gather" for k in GATHER)
        for k in fam:
            s = fam[k][0][0]
            assert got[top][1] <= s[1] <= s[2] <= got[top][2]


def test_a_gather_without_row_counts_records_them_and_psum_records_itself(group):
    ax = group.axis(mesh.DATA_AXIS)
    tracing.enable()
    blocks = mesh._every_block([torch.arange(6).view(3, 2), torch.arange(4).view(2, 2)], ax)
    assert [b.shape[0] for b in blocks] == [3, 2]
    total = mesh.psum([torch.ones(3, dtype=torch.int32)] * 2, ax)
    assert total.shards[0].tolist() == [2, 2, 2]
    got = tracing.spans()
    top = [i for i, s in enumerate(got) if s[0] == "mesh.all_gather"]
    assert len(top) == 1 and got[top[0]][3] == -1
    fam = _family(got, top[0])
    assert {k: len(v) for k, v in fam.items()} == {"mesh.all_gather.rows": 1, "mesh.all_gather.stage": 2,
                                                   "mesh.all_gather.collective": 2}
    assert fam["mesh.all_gather.rows"][0][1] == "mesh.all_gather"
    assert sorted(p for _, p in fam["mesh.all_gather.stage"]) == ["mesh.all_gather", "mesh.all_gather.rows"]
    assert [s[0] for s in got if s[3] == -1] == ["mesh.all_gather", "mesh.psum"]


def test_parallel_spans_off_record_nothing_and_count_each_collective_once(group):
    x = _reads()
    before = mesh._COLLECTIVES["gloo"]
    off = data_parallel.data_parallel_encode_checked(x, mesh=group, codec="base5", gather=True)
    assert tracing.spans() == [] and mesh._COLLECTIVES["gloo"] - before == 2  # the gather and the flags' psum
    tracing.enable()
    on = data_parallel.data_parallel_encode_checked(x, mesh=group, codec="base5", gather=True)
    assert mesh._COLLECTIVES["gloo"] - before == 4
    assert torch.equal(on[0].shards[0], off[0].shards[0]) and int(on[1].shards[0]) == int(off[1].shards[0]) == 0
    assert sorted(s[0] for s in tracing.spans() if s[3] == -1) == ["mesh.all_gather", "mesh.psum"]


def _profiled_gathers(m, x) -> collections.Counter:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            data_parallel.data_parallel_encode(x, mesh=m, codec="base5", gather=True)
    return collections.Counter(ev.name() for ev in prof.profiler.kineto_results.events())


def test_parallel_recorder_puts_nothing_into_the_profile(group, monkeypatch):
    x = _reads()
    data_parallel.data_parallel_encode(x, mesh=group, codec="base5", gather=True)  # warm
    with_recorder = _profiled_gathers(group, x)
    assert sum(s[0] == "dp.encode" for s in tracing.spans()) == 3  # it did record inside the profile
    assert sum(s[0] == "mesh.all_gather.collective" for s in tracing.spans()) == 3
    monkeypatch.setattr(tracing, "span", lambda name: tracing._OFF)
    without = _profiled_gathers(group, x)
    assert with_recorder == without and sum(without.values()) > 0
