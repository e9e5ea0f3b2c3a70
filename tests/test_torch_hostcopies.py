"""The port's own copies of the reference's host layers against the
originals: ``ops/spec.py``, ``ops/oracle.py``, the C++ oracle
(``native/codec.cpp`` and ``ops/native.py``, with the bench's ``memcpy``,
the de-pad copy and the FASTQ scan), ``utils/io.py`` (with the stream's
``shard_records``, ``BatchStream(skip=, truncate=)`` and
``fastq_batches``), ``utils/metrics.py``, ``utils/checkpoint.py``, the
``.nup`` container (``nup.py``, with its random access by name) and the
byte models of ``utils/profiling.py``.  The port
imports none of the reference, so these tests keep the copies honest: the
same constants, the same words, the same bytes on disk, the same records
and the same errors."""

import gzip
import io
import os
import time

import numpy as np
import pytest

from cute_nucleotides_tpu import cli as ref_cli
from cute_nucleotides_tpu.native import __file__ as ref_native_init
from cute_nucleotides_tpu.ops import native as ref_native, oracle as ref_oracle, pallas_kernels as ref_pk
from cute_nucleotides_tpu.ops import spec as ref_spec
from cute_nucleotides_tpu.utils import checkpoint as ref_checkpoint, io as ref_io, metrics as ref_metrics
from cute_nucleotides_tpu.utils import profiling as ref_profiling
from cute_nucleotides_tpu_torch import native as port_native_build, nup
from cute_nucleotides_tpu_torch.ops import kernels, native, oracle, spec
from cute_nucleotides_tpu_torch.utils import checkpoint, io as port_io, metrics, profiling

LENGTHS = (0, 1, 26, 27, 28, 31, 32, 33, 1000, 4099)


def _seq(n: int, alphabet: bytes = b"ACGTUNacgtunX\x00\xff") -> np.ndarray:
    return np.random.default_rng(n).choice(np.frombuffer(alphabet, np.uint8), n)


def test_spec_constants_equal_reference():
    names = [n for n in dir(ref_spec) if n.isupper()]
    assert len(names) >= 20 and names == [n for n in dir(spec) if n.isupper()]
    for name in names:
        a, b = getattr(spec, name), getattr(ref_spec, name)
        assert (np.array_equal(a, b) and a.dtype == b.dtype) if isinstance(b, np.ndarray) else a == b, name
    w = np.arange(12, dtype=np.uint64) * np.uint64(0x0123456789ABCDEF)
    assert np.array_equal(spec.u64_to_u32_pairs(w), ref_spec.u64_to_u32_pairs(w))
    assert spec.num_words_b5(55) == ref_spec.num_words_b5(55) and spec.cdiv(-7, 3) == ref_spec.cdiv(-7, 3)


@pytest.mark.parametrize("n", [0, 1, 26, 27, 28, 31, 32, 33, 2**31 + 5, 2**33])
def test_spec_helpers_of_the_long_sequence_mode_equal_reference(n):
    """The helpers ``parallel/longseq.py`` plans its shards with: word counts
    past 2^31 nt, and the u32-pair views both ways."""
    assert spec.num_words_2bit(n) == ref_spec.num_words_2bit(n)
    assert spec.num_words_b5(n) == ref_spec.num_words_b5(n)
    w = (np.arange(min(n, 40), dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)).reshape(-1)
    pairs = spec.u64_to_u32_pairs(w)
    assert np.array_equal(pairs, ref_spec.u64_to_u32_pairs(w))
    assert np.array_equal(spec.u32_pairs_to_u64(pairs.reshape(-1)), ref_spec.u32_pairs_to_u64(pairs.reshape(-1)))


def test_codec_cpp_is_the_reference_source():
    port_src = os.path.join(os.path.dirname(port_native_build.__file__), "codec.cpp")
    ref_src = os.path.join(os.path.dirname(ref_native_init), "codec.cpp")
    with open(port_src, "rb") as a, open(ref_src, "rb") as b:
        assert a.read() == b.read()


def test_native_builds_into_the_build_directory():
    assert native.available() and ref_native.available()
    lib = port_native_build.load()
    assert os.path.dirname(lib._name) == port_native_build.BUILD_DIR
    assert not [f for f in os.listdir(os.path.dirname(port_native_build.__file__)) if f.endswith(".so")]


@pytest.mark.parametrize("n", LENGTHS)
def test_native_and_oracle_equal_reference(n):
    s = _seq(n)
    w2, w5 = ref_native.n_to_bits(s), ref_native.n_to_bits2(s)
    assert np.array_equal(native.n_to_bits(s), w2) and np.array_equal(oracle.n_to_bits_lut(s), w2)
    assert np.array_equal(native.n_to_bits2(s), w5) and np.array_equal(oracle.n_to_bits2_lut(s), w5)
    assert np.array_equal(native.bits_to_n(w2, n), ref_native.bits_to_n(w2, n))
    assert np.array_equal(oracle.bits_to_n_lut(w2, n), ref_oracle.bits_to_n_lut(w2, n))
    assert np.array_equal(native.bits_to_n2(w5, n), ref_native.bits_to_n2(w5, n))
    assert np.array_equal(oracle.bits_to_n2_lut(w5, n), ref_oracle.bits_to_n2_lut(w5, n))
    for allow_n in (False, True):
        assert native.find_invalid(s, allow_n=allow_n) == ref_native.find_invalid(s, allow_n=allow_n)
        clean = _seq(n, b"ACGTUacgtu")
        assert native.find_invalid(clean, allow_n=allow_n) == ref_native.find_invalid(clean, allow_n=allow_n) == -1


def test_native_capacity_errors_equal_reference():
    for port_fn, ref_fn in ((native.bits_to_n, ref_native.bits_to_n), (native.bits_to_n2, ref_native.bits_to_n2)):
        with pytest.raises(ValueError) as want:
            ref_fn(np.zeros(2, np.uint64), 100)
        with pytest.raises(ValueError) as got:
            port_fn(np.zeros(2, np.uint64), 100)
        assert str(got.value) == str(want.value)


def test_fill_rows_equals_reference():
    buf = _seq(500)
    starts, lens = np.array([0, 10, 200, 499]), np.array([5, 0, 300, 1])
    a, b = np.zeros((6, 64), np.uint8), np.ones((6, 64), np.uint8)
    native.fill_rows(buf, starts, lens, a)
    ref_native.fill_rows(buf, starts, lens, b)
    assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="out of buffer bounds"):
        native.fill_rows(buf, np.array([490]), np.array([20]), a)


@pytest.mark.parametrize("n", (0, 1, 4099, 1 << 20))
def test_memcpy_equals_reference(n):
    s = _seq(n)
    got = native.memcpy(s)
    assert got.dtype == np.uint8 and np.array_equal(got, ref_native.memcpy(s)) and np.array_equal(got, s)
    assert got.ctypes.data != s.ctypes.data
    assert np.array_equal(native.memcpy(bytes(s[:33])), ref_native.memcpy(bytes(s[:33])))


@pytest.mark.parametrize("rows", (0, 1, 3, 64))
def test_depad_equals_reference(rows):
    panels = np.random.default_rng(rows).integers(0, 2**32, (rows, 896), dtype=np.uint32)
    got = kernels.depad_nt4_host(panels)
    assert np.array_equal(got, ref_pk.depad_nt4_host(panels)) and got.size == rows * 3456
    assert np.array_equal(native.depad_nt4(panels), got)
    assert np.array_equal(kernels.depad_nt4_host(panels.T.copy().T), got)  # made contiguous first
    for bad in (np.zeros((2, 864), np.uint32), np.zeros(896, np.uint32)):
        with pytest.raises(TypeError) as want:
            ref_pk.depad_nt4_host(bad)
        with pytest.raises(TypeError) as err:
            kernels.depad_nt4_host(bad)
        assert str(err.value) == str(want.value)


@pytest.mark.parametrize("nt", (0, 26, 27, 1000, 268_435_456, 268_959_744))
def test_byte_models_equal_reference(nt):
    for name in ("encode_2bit_roofline", "decode_2bit_roofline", "encode_b5_roofline", "decode_b5_roofline"):
        got, want = getattr(profiling, name)(nt), getattr(ref_profiling, name)(nt)
        assert (got.read_bytes, got.write_bytes, got.total) == (want.read_bytes, want.write_bytes, want.total), name


def test_roofline_bound_at_the_card_peaks():
    r = profiling.Roofline(3_350_000_000, 0)  # 1 ms of bytes at 3.35 TB/s
    assert r.speed_of_light_s() == pytest.approx(1e-3) and r.bound_kind() == "bytes"
    assert r.efficiency(2e-3) == pytest.approx(0.5)
    ops = profiling.Roofline(8, 8, int_ops=67_000_000_000)  # 2 ms of instructions at 33.5 T/s
    assert ops.speed_of_light_s() == pytest.approx(2e-3) and ops.bound_kind() == "operations"
    assert profiling.bound(3.35e9) == (pytest.approx(1.0), "bytes")
    assert not hasattr(profiling, "HBM_GIBS") and not hasattr(profiling, "MXU_INT8_TOPS")


def _entries(codec: str):
    rng = np.random.default_rng(2)
    names = [b"r0", b"", b"chr1 some description", b"r0"]
    lengths = [0, 1, 100, 64]
    per = 32 if codec == "2bit" else 27
    words = [rng.integers(0, 2**63, -(-n // per), dtype=np.uint64) for n in lengths]
    return names, words, lengths


@pytest.mark.parametrize("codec", ("2bit", "base5"))
def test_nup_files_identical_to_reference(tmp_path, codec):
    names, words, lengths = _entries(codec)
    mine, theirs = tmp_path / "a.nup", tmp_path / "b.nup"
    nup.write_nup(str(mine), names, words, lengths, codec)
    ref_cli.write_nup(str(theirs), names, words, lengths, codec)
    assert mine.read_bytes() == theirs.read_bytes()
    got, want = nup.read_nup(str(theirs)), ref_cli.read_nup(str(mine))
    assert got[0] == want[0] == codec
    assert [(n, ln, w.tolist()) for n, ln, w in got[1]] == [(n, ln, w.tolist()) for n, ln, w in want[1]]
    with nup.NupReader(str(mine)) as r, ref_cli.NupReader(str(mine)) as q:
        assert r.names == q.names and r.lengths == q.lengths and r.codec == q.codec


@pytest.mark.parametrize("codec", ("2bit", "base5"))
def test_nup_random_access_equals_reference(tmp_path, codec):
    """``len``, ``in``, ``get`` and the first-occurrence rule for a repeated
    name (``r0`` twice), as ``region`` uses them."""
    names, words, lengths = _entries(codec)
    path = tmp_path / "r.nup"
    nup.write_nup(str(path), names, words, lengths, codec)
    with nup.NupReader(str(path)) as r, ref_cli.NupReader(str(path)) as q:
        assert len(r) == len(q) == 4
        for name in (b"r0", b"", b"chr1 some description", b"nope", b"r"):
            assert (name in r) == (name in q)
            if name in q:
                (n1, w1), (n2, w2) = r.get(name), q.get(name)
                assert n1 == n2 and np.array_equal(w1, w2) and w1.dtype == w2.dtype
        assert r.get(b"r0")[0] == lengths[0] != lengths[3]  # the first r0, not the second
        for reader in (q, r):
            with pytest.raises(KeyError):
                reader.get(b"nope")


def test_nup_errors_equal_reference(tmp_path):
    names, words, lengths = _entries("2bit")
    path = tmp_path / "t.nup"
    nup.write_nup(str(path), names, words, lengths, "2bit")
    truncated = tmp_path / "trunc.nup"
    truncated.write_bytes(path.read_bytes()[:-9])
    bad = tmp_path / "bad.nup"
    bad.write_bytes(b"NOPE" + path.read_bytes()[4:])
    codec_byte = tmp_path / "codec.nup"
    codec_byte.write_bytes(path.read_bytes()[:8] + b"\x07" + path.read_bytes()[9:])
    for p in (truncated, bad, codec_byte):
        with pytest.raises(ValueError) as want:
            ref_cli.read_nup(str(p))
        with pytest.raises(ValueError) as got:
            nup.read_nup(str(p))
        assert str(got.value) == str(want.value)


def test_write_fasta_identical_to_reference():
    a, b = io.BytesIO(), io.BytesIO()
    for name, data in ((b"x", b""), (b"y", b"A" * 80), (b"z", b"ACGT" * 41)):
        nup.write_fasta(a, name, data)
        ref_cli._write_fasta(b, name, data)
    assert a.getvalue() == b.getvalue()


def _reads_files(tmp_path) -> dict:
    rng = np.random.default_rng(5)
    seqs = [rng.choice(np.frombuffer(b"ACGTN", np.uint8), n).tobytes() for n in (0, 7, 80, 81, 333)]
    fasta = b"".join(b">s%d desc\n%s\n\n" % (i, b"\n".join(s[j : j + 80] for j in range(0, len(s), 80)))
                     for i, s in enumerate(seqs))
    fastq = b"".join(b"@q%d\n%s\n+\n%s\n" % (i, s, b"@" * len(s)) for i, s in enumerate(seqs))
    files = {"a.fa": fasta, "a.fasta": fasta, "a.fna": fasta, "a.fq": fastq,
             "tail.fastq": fastq.rstrip(b"\n"), "bad.fq": b"@q0\nACGT\n-\nIIII\n"}
    paths = {}
    for name, data in files.items():
        paths[name] = tmp_path / name
        paths[name].write_bytes(data)
    for name in ("a.fa", "a.fq"):
        paths[name + ".gz"] = tmp_path / (name + ".gz")
        paths[name + ".gz"].write_bytes(gzip.compress(files[name]))
    return paths


def test_open_reads_equals_reference(tmp_path):
    paths = _reads_files(tmp_path)
    for name, path in paths.items():
        if name == "bad.fq":
            continue
        got = [(r.name, r.seq) for r in port_io.open_reads(path)]
        assert got == [(r.name, r.seq) for r in ref_io.open_reads(path)], name
        assert len(got) == 5
    for path in (paths["bad.fq"], tmp_path / "reads.txt"):
        with pytest.raises(ValueError) as want:
            list(ref_io.open_reads(path))
        with pytest.raises(ValueError) as got:
            list(port_io.open_reads(path))
        assert str(got.value) == str(want.value)


def test_batch_stream_and_word_batches_equal_reference(tmp_path):
    records = list(ref_io.open_reads(_reads_files(tmp_path)["a.fq"]))
    for kwargs in ({"batch_size": 2, "max_len": 333}, {"batch_size": 4, "max_len": 333, "block": 27},
                   {"batch_size": 8, "max_len": 400}):
        got, want = list(port_io.BatchStream(records, **kwargs)), list(ref_io.BatchStream(records, **kwargs))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.count == w.count
            for f in ("reads", "lengths"):
                assert np.array_equal(getattr(g, f), getattr(w, f))
    with pytest.raises(ValueError, match="exceeds max_len"):
        list(port_io.BatchStream(records, batch_size=2, max_len=64))
    entries = [(b"a", 5, np.arange(1, dtype=np.uint64)), (b"b", 70, np.arange(3, dtype=np.uint64)), (b"c", 0, np.zeros(0, np.uint64))]
    assert np.array_equal(port_io.pack_words_batch(entries, 4), ref_io.pack_words_batch(entries, 4))


def test_metrics_is_the_reference_source():
    with open(metrics.__file__, "rb") as a, open(ref_metrics.__file__, "rb") as b:
        assert a.read() == b.read()


def test_manifest_files_equal_reference(tmp_path, monkeypatch):
    """The same advances and saves write the same bytes and read back the
    same positions (the port's lock file aside)."""
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    files = {}
    for name, mod in (("port", checkpoint), ("ref", ref_checkpoint)):
        p = tmp_path / f"{name}.json"
        m = mod.Manifest(p)
        m.advance(0, batches=3, records=100)
        m.advance(1, batches=2, records=64)
        m.save()
        m2 = mod.Manifest(p)
        m2.advance(2)
        m2.advance(0, records=5)
        m2.save()
        m3 = mod.Manifest(p)
        files[name] = (p.read_bytes(), [(m3.batches_done(h), m3.records_done(h)) for h in range(4)])
    assert files["port"] == files["ref"]
    assert files["port"][1] == [(4, 105), (2, 64), (1, 0), (0, 0)]


def test_stream_batches_equal_reference(tmp_path):
    """fastq_batches, and BatchStream over sharded records, with skip and
    truncate, on the reads files (the tail file ends without a newline)."""
    paths = _reads_files(tmp_path)
    for name in ("a.fq", "tail.fastq"):
        for kwargs in ({}, {"skip": 1}, {"truncate": True, "block": 27}, {"chunk_bytes": 64}):
            got = list(port_io.fastq_batches(paths[name], 2, 100 if "truncate" in kwargs else 333, **kwargs))
            want = list(ref_io.fastq_batches(paths[name], 2, 100 if "truncate" in kwargs else 333, **kwargs))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert g.count == w.count
                for f in ("reads", "lengths", "indices"):
                    assert np.array_equal(getattr(g, f), getattr(w, f))
    records = list(ref_io.open_reads(paths["a.fq"]))
    for max_len, kwargs in ((333, {"skip": 1}), (80, {"truncate": True}), (80, {"skip": 1, "truncate": True})):
        got = list(port_io.BatchStream(port_io.shard_records(records, 0, 2), 2, max_len, **kwargs))
        want = list(ref_io.BatchStream(ref_io.shard_records(records, 0, 2), 2, max_len, **kwargs))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.count == w.count
            for f in ("reads", "lengths", "indices"):
                assert np.array_equal(getattr(g, f), getattr(w, f))


@pytest.mark.parametrize("crlf", (False, True))
def test_fastq_scan_equals_reference_on_chunks_that_split_a_record(crlf):
    rng = np.random.default_rng(8)
    end = b"\r\n" if crlf else b"\n"
    recs = [b"@r%d%s%s%s+%sI%s" % (i, end, b"ACGT" * int(n), end, end, end) for i, n in enumerate(rng.integers(0, 9, 12))]
    data = np.frombuffer(b"".join(recs), np.uint8)
    for cut in (0, 1, 5, len(recs[0]), len(recs[0]) + 3, data.size // 2, data.size - 1, data.size):
        chunk = data[:cut].copy()
        got, want = native.fastq_scan(chunk), ref_native.fastq_scan(chunk)
        assert got[2] == want[2] and np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[2] <= cut and (got[0].size == 0 or got[0][-1] + got[1][-1] < got[2])
    bad = np.frombuffer(b"@r0\nACGT\n-\nIIII\n", np.uint8)
    for fn in (native.fastq_scan, ref_native.fastq_scan):
        with pytest.raises(ValueError, match="malformed FASTQ record"):
            fn(bad)
    with pytest.raises(TypeError):
        native.fastq_scan(data.view(np.int8))


MYERS_PAIRS = ((b"", b"ACGT"), (b"ACGT", b""), (b"", b""), (b"GATTACA", b"GATACAGATTTACA"), (b"NNA", b"CCCT"),
               (b"acgu", b"ACGT"), (b"GANTACA", b"TTGACTACATT"), (b"ACGTACGTAC", b"T" * 14))


def test_host_myers_equals_reference(monkeypatch):
    """The port's ``native.edit_distance`` / ``best_match`` / ``prefix_match``
    (the C++ Myers scan of the copied ``codec.cpp``) against the reference's,
    at the u64 block seams (m = 63, 64, 65, 128, 129), with N wildcards and
    empty sides; and their NumPy fallbacks (no C++ library) against the
    same results."""
    rng = np.random.default_rng(64)
    pairs = list(MYERS_PAIRS)
    for m in (1, 63, 64, 65, 128, 129):
        q = bytearray(rng.choice(np.frombuffer(b"ACGTN", np.uint8), m).tobytes())
        t = rng.choice(np.frombuffer(b"ACGTacgtU", np.uint8), int(rng.integers(0, 300))).tobytes()
        pairs.append((bytes(q), t))
        pairs.append((bytes(q), t[:50] + bytes(q).replace(b"N", b"G") + t[50:]))
    for q, t in pairs:
        for name in ("edit_distance", "best_match", "prefix_match"):
            assert getattr(native, name)(q, t) == getattr(ref_native, name)(q, t), (name, q, t)
        arr = np.frombuffer(t, np.uint8)
        assert native.best_match(np.frombuffer(q, np.uint8), arr) == ref_native.best_match(q, t)
    monkeypatch.setattr(native, "_lib", lambda: None)
    for q, t in pairs[:10]:
        for name in ("edit_distance", "best_match", "prefix_match"):
            assert getattr(native, name)(q, t) == getattr(ref_native, name)(q, t), ("fallback", name, q, t)
