"""The port's stream input (``utils/io.py``: ``shard_records``,
``BatchStream`` with ``skip`` and ``truncate``, ``fastq_batches``) and its
``utils/metrics.py`` against the JAX package's copies, on the same seeded
files: the same batches field for field, the same errors, the same metrics
under a fake clock."""

import io as pyio
import json
import time

import numpy as np
import pytest

from cute_nucleotides_tpu.ops import native as ref_native
from cute_nucleotides_tpu.utils import io as ref_io, metrics as ref_metrics
from cute_nucleotides_tpu_torch.ops import native
from cute_nucleotides_tpu_torch.utils import io as port_io, metrics

#: lengths at the 2-bit (32 nt) and base-5 (27 nt) word edges, and empty
EDGES = (31, 32, 33, 26, 27, 28, 0, 1, 64, 54)


def _fastq(path, seed: int, lengths, crlf: bool = False) -> list[bytes]:
    rng = np.random.default_rng(seed)
    seqs = [rng.choice(np.frombuffer(b"ACGTNacgtn", np.uint8), n).tobytes() for n in lengths]
    end = b"\r\n" if crlf else b"\n"
    parts = [b"@r%d meta%s%s%s+%s%s\n" % (i, end, s, end, end, bytes(rng.integers(33, 105, len(s)).astype(np.uint8)))
             for i, s in enumerate(seqs)]
    path.write_bytes(b"".join(parts))
    return seqs


def _same(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.count == w.count
        for f in ("reads", "lengths", "indices"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f


def _both(fn, *args, **kwargs):
    """fn(module) for the port and the reference: (port result, reference
    result), or the two error messages when both raise."""
    out = []
    for mod in (port_io, ref_io):
        try:
            out.append(fn(mod, *args, **kwargs))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


@pytest.mark.parametrize("block", (32, 27))
@pytest.mark.parametrize("skip", (0, 1, 2, 9))
def test_fastq_batches_equal_reference(tmp_path, block, skip):
    fq = tmp_path / "t.fastq"
    _fastq(fq, block + skip, [int(n) for n in np.random.default_rng(skip).integers(0, 120, 150)] + list(EDGES))
    for chunk_bytes in (4096, 1 << 26):
        got, want = _both(lambda m: list(m.fastq_batches(str(fq), 16, 120, block=block, skip=skip,
                                                         chunk_bytes=chunk_bytes)))
        _same(got, want)
        assert len(got) == max(0, 10 - skip)


@pytest.mark.parametrize("truncate", (False, True))
@pytest.mark.parametrize("skip", (0, 3))
def test_fastq_batches_truncate_and_skipped_length_check_equal_reference(tmp_path, truncate, skip):
    fq = tmp_path / "t.fastq"
    _fastq(fq, 4, [40] * 5 + [200] + [40] * 35, crlf=True)  # the long read sits in batch 0
    got, want = _both(lambda m: list(m.fastq_batches(str(fq), 8, 64, truncate=truncate, skip=skip,
                                                     chunk_bytes=1000)))
    if truncate:
        _same(got, want)
        assert len(got) == 6 - skip and int(got[0].lengths.max()) == (64 if skip == 0 else 40)
    else:
        assert got == want == ("ValueError", "read of length 200 exceeds max_len 64")


def test_fastq_batches_without_the_cpp_scan_equal_reference(tmp_path, monkeypatch):
    fq = tmp_path / "t.fastq"
    _fastq(fq, 9, list(EDGES) * 7, crlf=True)
    want = list(ref_io.fastq_batches(str(fq), 8, 64, block=27, chunk_bytes=777))
    monkeypatch.setattr(native, "_lib", lambda: None)
    monkeypatch.setattr(ref_native, "_lib", lambda: None)
    assert native.fastq_scan(np.zeros(8, np.uint8)) is None
    _same(list(port_io.fastq_batches(str(fq), 8, 64, block=27, chunk_bytes=777)), want)
    _same(list(ref_io.fastq_batches(str(fq), 8, 64, block=27, chunk_bytes=777)), want)


def test_fastq_batches_malformed_equals_reference(tmp_path):
    fq = tmp_path / "bad.fastq"
    fq.write_bytes(b"@r0\nACGT\n+\nIIII\n@r1\nACGT\n-\nIIII\n")
    assert _both(lambda m: list(m.fastq_batches(str(fq), 8, 32))) == [("ValueError", "malformed FASTQ record")] * 2


@pytest.mark.parametrize("block", (32, 27))
@pytest.mark.parametrize("skip", (0, 2, 5))
def test_batch_stream_equals_reference(block, skip):
    rng = np.random.default_rng(block + skip)
    seqs = [rng.choice(np.frombuffer(b"ACGT", np.uint8), int(n)).tobytes() for n in rng.integers(0, 70, 37)]
    seqs += [b"A" * n for n in EDGES]

    def run(m, sharded):
        recs = [m.Record(b"", s) for s in seqs]
        source = m.shard_records(recs, 1, 2) if sharded else recs
        return list(m.BatchStream(source, 8, 70, block=block, skip=skip))

    for sharded in (False, True):
        got, want = _both(run, sharded)
        _same(got, want)
        assert all((b.indices[: b.count] >= 0).all() == sharded for b in got)


def test_batch_stream_truncate_and_length_check_equal_reference():
    for kwargs in ({}, {"truncate": True}, {"skip": 5}, {"skip": 1, "truncate": True}):
        got, want = _both(lambda m: list(m.BatchStream([m.Record(b"", b"A" * 100)] * 4, 2, 32, **kwargs)))
        if isinstance(want, tuple):
            assert got == want == ("ValueError", "read of length 100 exceeds max_len 32")
        else:
            _same(got, want)
            assert all(int(b.lengths[: b.count].max()) == 32 for b in got)
    # the length check fires before further records leave the caller's iterator
    it = iter([port_io.Record(b"", b"A" * 100), port_io.Record(b"", b"ACGT")])
    with pytest.raises(ValueError, match="exceeds max_len"):
        next(iter(port_io.BatchStream(it, batch_size=8, max_len=32)))
    assert next(it).seq == b"ACGT"


def test_shard_records_equals_reference():
    for hosts in (1, 2, 3, 7):
        for host in range(hosts):
            got, want = _both(lambda m: [(i, r.seq) for i, r in m.shard_records(
                [m.Record(b"%d" % i, b"A" * i) for i in range(20)], host, hosts)])
            assert got == want and [i for i, _ in got] == list(range(host, 20, hosts))


def test_throughput_logger_equals_reference_under_a_fake_clock(monkeypatch):
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    out = {}
    for name, mod in (("port", metrics), ("ref", ref_metrics)):
        buf = pyio.StringIO()
        log = mod.ThroughputLogger(name="t", stream=buf, log_every=2)
        with pytest.raises(RuntimeError, match="call start"):
            log.batch_done(nt=1, reads=1)
        log.start()
        for nt, reads in ((1000, 10), (2000, 20), (3000, 30), (500, 5)):
            log.batch_done(nt=nt, reads=reads)
        out[name] = (log.aggregate(), buf.getvalue(), mod.scaling_efficiency(10.0, 4, 30.0),
                     mod.scaling_efficiency(0.0, 4, 30.0))
    assert out["port"] == out["ref"]
    agg, lines, eff, zero = out["port"]
    assert (agg["batches"], agg["total_nt"], agg["total_reads"], agg["seconds"]) == (4, 6500, 65, 1.0)
    assert [json.loads(line)["batch"] for line in lines.splitlines()] == [2, 4] and (eff, zero) == (0.75, 0.0)
