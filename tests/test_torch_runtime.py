"""The port's streaming runtime (``cute_nucleotides_tpu_torch/parallel``)
against the JAX package's, on the CPU: the same seeded inputs through both
``StreamingEncoder``s and ``StreamingDecoder``s give the same sunk words and
bytes, aggregate counts, stage keys, manifest positions, deliveries after a
crash and a resume, and error messages (tolerance 0).  The reference runs on
its 8-device CPU mesh, so batch sizes are multiples of 8; the port runs with
``device="cpu"`` (the torch tier), as a caller must ask for the CPU."""

import time

import numpy as np
import pytest
import torch

from cute_nucleotides_tpu.ops import oracle as ref_oracle
from cute_nucleotides_tpu.parallel import data_parallel as ref_dp, runtime as ref_rt
from cute_nucleotides_tpu.utils import checkpoint as ref_ckpt, io as ref_io
from cute_nucleotides_tpu_torch import models
from cute_nucleotides_tpu_torch.ops import kernels
from cute_nucleotides_tpu_torch.parallel import ShardedCodec, StreamConfig, data_parallel, runtime as rt
from cute_nucleotides_tpu_torch.utils import checkpoint, io as port_io

CPU = {"device": "cpu"}
CODECS = ("2bit", "base5")
ALPHA = {"2bit": b"ACGTUacgtu", "base5": b"ACGTUNacgtun"}
#: (name, runtime, io, checkpoint, what the port is given to run on the CPU)
SIDES = (("ref", ref_rt, ref_io, ref_ckpt, {}), ("port", rt, port_io, checkpoint, CPU))


def _seqs(seed: int, codec: str, lengths) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.choice(np.frombuffer(ALPHA[codec], np.uint8), n).tobytes() for n in lengths]


def _keep(into: list):
    return lambda w, b: into.append((np.array(w), b))


def _same_batches(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for (gw, gb), (ww, wb) in zip(got, want):
        assert gw.dtype == ww.dtype and np.array_equal(gw, ww)
        assert gb.count == wb.count
        for f in ("reads", "lengths", "indices"):
            assert np.array_equal(getattr(gb, f), getattr(wb, f)), f


def _same_agg(got: dict, want: dict) -> None:
    assert set(got) == set(want) and set(got["stages"]) == set(want["stages"])
    for k in ("batches", "total_nt", "total_reads", "host_id", "num_hosts", "name", "event"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("codec", CODECS)
def test_encoder_end_to_end_and_resume_match_reference(tmp_path, codec):
    seqs = _seqs(1, codec, (20, 8, 160, 0, 31, 32, 33, 26, 27, 28, 100))
    out = {}
    for side, run_mod, io_mod, ckpt_mod, extra in SIDES:
        path = str(tmp_path / f"{side}.json")
        records = [io_mod.Record(b"r%d" % i, s) for i, s in enumerate(seqs)]
        sunk = []
        agg = run_mod.StreamingEncoder(batch_size=8, max_len=192, codec=codec, manifest_path=path,
                                       **extra).run(records, sink=_keep(sunk))
        m = ckpt_mod.Manifest(path)
        again = run_mod.StreamingEncoder(batch_size=8, max_len=192, codec=codec, manifest_path=path,
                                         **extra).run(records, sink=_keep(sunk))
        out[side] = (agg, sunk, (m.batches_done(0), m.records_done(0)), again["batches"])
    (agg, sunk, pos, again), (ragg, rsunk, rpos, ragain) = out["port"], out["ref"]
    _same_agg(agg, ragg)
    _same_batches(sunk, rsunk)
    assert pos == rpos == (2, len(seqs)) and again == ragain == 0
    per = 32 if codec == "2bit" else 27
    oracle = ref_oracle.n_to_bits_lut if codec == "2bit" else ref_oracle.n_to_bits2_lut
    words, batch = sunk[0]
    for i in range(batch.count):
        want = oracle(np.frombuffer(seqs[i], np.uint8))
        assert np.array_equal(words[i].view("<u8")[: -(-len(seqs[i]) // per)], want)


@pytest.mark.parametrize("codec", CODECS)
def test_crash_and_resume_deliver_each_record_once_as_reference(tmp_path, codec):
    seqs = _seqs(2, codec, [4 * (i % 5 + 1) for i in range(20)])

    class Boom(Exception):
        pass

    out = {}
    for side, run_mod, io_mod, ckpt_mod, extra in SIDES:
        path = str(tmp_path / f"{side}.json")
        records = [io_mod.Record(str(i).encode(), s) for i, s in enumerate(seqs)]
        delivered = []

        def crashing(words, batch):
            if len(delivered) == 1:
                raise Boom()
            delivered.append(sorted(int(i) for i in batch.indices if i >= 0))

        with pytest.raises(Boom):
            run_mod.StreamingEncoder(batch_size=8, max_len=64, codec=codec, manifest_path=path,
                                     **extra).run(records, sink=crashing)
        done = ckpt_mod.Manifest(path).batches_done(0)
        run_mod.StreamingEncoder(batch_size=8, max_len=64, codec=codec, manifest_path=path, **extra).run(
            records, sink=lambda w, b: delivered.append(sorted(int(i) for i in b.indices if i >= 0)))
        out[side] = (done, delivered)
    assert out["port"] == out["ref"]
    assert out["port"][0] == 1 and sorted(i for b in out["port"][1] for i in b) == list(range(20))


@pytest.mark.parametrize("codec", CODECS)
def test_run_batches_from_fastq_and_resume_match_reference(tmp_path, codec):
    seqs = _seqs(3, codec, [64] * 37)
    fq = tmp_path / "r.fastq"
    fq.write_bytes(b"".join(b"@r%d\n%s\n+\nI\n" % (i, s) for i, s in enumerate(seqs)))
    out = {}
    for side, run_mod, io_mod, ckpt_mod, extra in SIDES:
        path = str(tmp_path / f"{side}.json")
        sunk = []
        agg = run_mod.StreamingEncoder(batch_size=8, max_len=64, codec=codec, manifest_path=path, **extra).run_batches(
            io_mod.fastq_batches(str(fq), 8, 64, block=32 if codec == "2bit" else 27), sink=_keep(sunk))
        again = run_mod.StreamingEncoder(batch_size=8, max_len=64, codec=codec, manifest_path=path,
                                         **extra).run_batches(io_mod.fastq_batches(str(fq), 8, 64), sink=_keep(sunk))
        out[side] = (agg, sunk, again["batches"], ckpt_mod.Manifest(path).records_done(0))
    _same_agg(out["port"][0], out["ref"][0])
    _same_batches(out["port"][1], out["ref"][1])
    assert out["port"][2:] == out["ref"][2:] == (0, 37) and len(out["port"][1]) == 5


@pytest.mark.parametrize("codec", CODECS)
def test_encoder_validate_raises_as_reference(codec):
    seqs = _seqs(13, codec, (8, 33, 100, 64, 31, 7, 200, 16))
    bad = list(seqs)
    bad[5] = bad[5][:3] + b"@" + bad[5][4:]
    messages, sunk = {}, {}
    for side, run_mod, io_mod, _, extra in SIDES:
        clean = []
        agg = run_mod.StreamingEncoder(batch_size=8, max_len=256, codec=codec, validate=True, **extra).run(
            [io_mod.Record(b"r%d" % i, s) for i, s in enumerate(seqs)], sink=lambda w, b: clean.append(b.count))
        assert agg["total_reads"] == len(seqs) and clean == [8]
        sunk[side] = []
        with pytest.raises(ValueError) as err:
            run_mod.StreamingEncoder(batch_size=8, max_len=256, codec=codec, validate=True, **extra).run(
                [io_mod.Record(b"r%d" % i, s) for i, s in enumerate(bad)], sink=lambda w, b: sunk[side].append(1))
        messages[side] = str(err.value)
    assert messages["port"] == messages["ref"] == "invalid byte b'@' at position 3 of record index 5"
    assert sunk["port"] == sunk["ref"] == []


def _entries(codec: str, seqs):
    enc = ref_oracle.n_to_bits_lut if codec == "2bit" else ref_oracle.n_to_bits2_lut
    return [(b"r%d" % i, len(s), enc(np.frombuffer(s, np.uint8))) for i, s in enumerate(seqs)]


@pytest.mark.parametrize("codec", CODECS)
def test_decoder_roundtrip_crash_and_resume_match_reference(tmp_path, codec):
    seqs = _seqs(3, codec, (1, 33, 100, 64, 31, 7, 200, 16, 42, 5, 26, 27, 28))
    entries = _entries(codec, seqs)
    want = {b"r%d" % i: s.upper().replace(b"U", b"T") for i, s in enumerate(seqs)}

    class Boom(Exception):
        pass

    out = {}
    for side, run_mod, _, ckpt_mod, extra in SIDES:
        got = {}
        agg = run_mod.StreamingDecoder(batch_size=8, max_len=256, codec=codec, **extra).run(
            entries, sink=lambda name, seq: got.__setitem__(name, seq))
        path = str(tmp_path / f"{side}.json")
        seen = []

        def crashing(name, seq):
            if len(seen) == 8:
                raise Boom()
            seen.append(name)

        with pytest.raises(Boom):
            run_mod.StreamingDecoder(batch_size=8, codec=codec, manifest_path=path, **extra).run(entries, crashing)
        got2 = {}
        agg2 = run_mod.StreamingDecoder(batch_size=8, codec=codec, manifest_path=path, **extra).run(
            entries, sink=lambda name, seq: got2.__setitem__(name, seq))
        m = ckpt_mod.Manifest(path)
        out[side] = (got, got2, seen, (m.batches_done(0), m.records_done(0)), agg, agg2)
    port, ref = out["port"], out["ref"]
    assert port[:4] == ref[:4]
    assert port[0] == want and set(port[1]) == {b"r%d" % i for i in range(8, 13)}
    assert port[3] == (2, 13)
    _same_agg(port[4], ref[4])
    _same_agg(port[5], ref[5])


def test_decoder_verify_raises_as_reference():
    seqs = _seqs(11, "base5", (27, 54, 13, 100, 7, 81, 40, 64, 9, 120))
    entries = _entries("base5", seqs)
    bad_entries = [(n, ln, w.copy()) for n, ln, w in entries]
    bad_entries[4][2][0] |= np.uint64(1) << np.uint64(63)  # r4's pad bit
    msgs, sunk = {}, {}
    for side, run_mod, _, _, extra in SIDES:
        got = {}
        run_mod.StreamingDecoder(batch_size=8, codec="base5", verify=True, **extra).run(
            entries, sink=lambda name, seq: got.__setitem__(name, seq))
        assert got == {b"r%d" % i: s.upper().replace(b"U", b"T") for i, s in enumerate(seqs)}
        sunk[side] = []
        with pytest.raises(ValueError) as err:
            run_mod.StreamingDecoder(batch_size=8, codec="base5", verify=True, **extra).run(
                bad_entries, sink=lambda name, seq: sunk[side].append(name))
        msgs[side] = [str(err.value)]
        with pytest.raises(ValueError) as err:
            run_mod.StreamingDecoder(codec="2bit", verify=True, **extra)
        msgs[side].append(str(err.value))
    assert msgs["port"] == msgs["ref"]
    assert msgs["port"][0] == "corrupt base-5 word 0 in record r4"
    assert sunk["port"] == sunk["ref"] == []


def test_sharded_codec_flags_and_errors_match_reference():
    rng = np.random.default_rng(5)
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(8, 64))
    sc = ShardedCodec("2bit", **CPU)
    x = sc.shard(reads)
    words, bad = sc.encode_checked(x)
    assert words.dtype == torch.uint32 and bad.dtype == torch.int32 and int(bad) == 0
    assert torch.equal(sc.encode(x, gather=True).view(torch.int32), words.view(torch.int32))  # one device
    ref = ref_dp.ShardedCodec("2bit")
    rwords, rbad = ref.encode_checked(ref.shard(reads))
    assert np.array_equal(words.numpy(), np.asarray(rwords)) and int(rbad) == 0
    reads[3, 5] = ord("N")
    assert int(sc.encode_checked(sc.shard(reads))[1]) == int(ref.encode_checked(ref.shard(reads))[1]) == 1
    with pytest.raises(ValueError) as want:
        ref.decode_checked(None)
    with pytest.raises(ValueError) as got:
        sc.decode_checked(x)
    assert str(got.value) == str(want.value)
    b5 = ShardedCodec("base5", **CPU)
    w5 = b5.encode(b5.shard(rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(8, 54))))
    w5.view(torch.int32)[2, 1] |= -(1 << 31)  # bit 63 of word 0 of row 2
    assert int(b5.decode_checked(w5)[1]) == 1
    assert sc.fetch(words) == ((words,), None)  # the CPU copies nothing
    assert sc.upload is sc.compute is sc.download is None
    with pytest.raises(ValueError, match="unknown codec"):
        ShardedCodec("3bit", **CPU)


def test_default_variants_follow_the_tier(monkeypatch):
    assert models.default_encode_variant("torch") == "dot" and models.default_decode_variant("torch") == "broadcast"
    assert models.default_encode_variant("cuda") == "mul" and models.default_decode_variant("cuda") == "swar"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert models.default_encode_variant("auto") == "dot"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert models.default_decode_variant("auto") == "swar"
    sc = ShardedCodec("2bit", tier="torch")
    assert sc.device == torch.device("cpu") and (sc.variant, sc.decode_variant) == ("dot", "broadcast")


def test_a_stream_that_asks_for_the_card_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (rt.StreamingEncoder, rt.StreamingDecoder):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(batch_size=8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(StreamConfig(tier="cuda"))
        with pytest.raises(ValueError, match='tier="cuda" runs on a CUDA device'):
            make(tier="cuda", device="cpu")
        assert make(tier="torch").sharded.device == torch.device("cpu")  # asked for the CPU
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        data_parallel.ShardedCodec("base5")


def test_initialize_single_process_matches_reference(monkeypatch):
    got, want = rt.initialize(), ref_rt.initialize()
    assert set(got) == set(want) and got["process_index"] == want["process_index"] == 0
    assert got["process_count"] == want["process_count"] == 1
    assert got["global_devices"] == got["local_devices"] >= 1
    # a coordinator address, or more than one process, joins a group (gloo
    # without CUDA; the two-process runs are tests/test_torch_multihost.py)
    joined = []
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda *a, **kw: joined.append((a, kw)))
    for kwargs in ({"coordinator_address": "localhost:1234"}, {"num_processes": 2, "process_id": 0}):
        rt.initialize(**kwargs)
    assert joined == [(("gloo",), {"init_method": "tcp://localhost:1234", "world_size": -1, "rank": -1}),
                      (("gloo",), {"init_method": "env://", "world_size": 2, "rank": 0})]


def test_an_initialized_process_group_shards_the_stream(monkeypatch):
    """Rank 1 of 3 consumes records 1, 4, 7, ... (never the whole stream)."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 3)
    seqs = _seqs(4, "2bit", [10] * 10)
    seen = []
    enc = rt.StreamingEncoder(batch_size=8, max_len=32, **CPU)
    agg = enc.run([port_io.Record(b"", s) for s in seqs], sink=lambda w, b: seen.extend(b.indices[: b.count]))
    assert seen == [1, 4, 7] and (agg["host_id"], agg["num_hosts"]) == (1, 3)
    got = []
    rt.StreamingDecoder(batch_size=8, **CPU).run(_entries("2bit", seqs), sink=lambda n, s: got.append(n))
    assert got == [b"r1", b"r4", b"r7"]
    assert rt.initialize()["process_index"] == 1


def test_sunk_words_stay_valid_and_no_kernel_runs_on_the_cpu():
    seqs = _seqs(6, "2bit", [50] * 40)
    kept = []
    kernels.reset_launch_counts()
    rt.StreamingEncoder(batch_size=8, max_len=64, **CPU).run([port_io.Record(b"", s) for s in seqs],
                                                             sink=lambda w, b: kept.append((w, w.copy())))
    assert len(kept) == 5 and all(np.array_equal(w, copy) for w, copy in kept)
    assert all(fn.launches == 0 for fn in kernels.WRAPPERS)


def test_stage_attribution_covers_the_wall():
    seqs = _seqs(7, "base5", [90] * 24)

    def slow_sink(w, b):
        time.sleep(0.02)

    agg = rt.StreamingEncoder(batch_size=8, max_len=96, codec="base5", readback_depth=1, **CPU).run(
        [port_io.Record(b"", s) for s in seqs], sink=slow_sink)
    st = agg["stages"]
    assert st["sink_s"] >= 0.05 and st["finish_s"] >= st["sink_s"]
    assert st["prep_wait_s"] + st["dispatch_s"] + st["backpressure_s"] <= st["wall_s"] + 1e-3
