"""The port's bench (``cute_nucleotides_tpu_torch/bench.py``) on the CPU: its
row table against the reference harness's (the root ``bench.py``: names with
the tier swapped, denominators, byte models and bound tags), every row's
step run once through a fake timer, the launch accounting, the output
shapes, and the refusal without CUDA.  The eager twins the bench runs on
the card are checked here for the uint32 operations the card lacks."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from cute_nucleotides_tpu_torch import bench, interop
from cute_nucleotides_tpu_torch.ops import eager, kernels as K

REPO = pathlib.Path(__file__).resolve().parents[1]
#: rows of the reference that run outside the row table (``run_stream_rows``)
STREAM = {"stream_encode_e2e", "stream_encode_records", "stream_decode_e2e"}


def _port_name(ref: str) -> str:
    return ref.replace("_pallas", "_cuda").replace("_xla", "_torch")


def _reference_rows(scale: int, full: bool) -> dict:
    """{port name: (denominator, read bytes, write bytes, bound tag)} as the
    reference's bench.py:382-1151 computes them (no roofline for host rows;
    its "vpu" tag is the port's "operations" where the port counts no
    instructions; the Myers rows count them, with no tag)."""
    rows = max(32768 // scale, 8)
    nt = rows * 8192
    rows_b5 = rows * 8208 // 3456
    nt5 = rows_b5 * 3456
    w5 = 8 * (nt5 // 27)
    padded = nt5 * 896 * 4 // 3456
    t = {"memcpy_device": (nt, nt, nt, None)}
    for v in ("mul", "shift", "interleave", "mxu", "checked"):
        t[f"encode_2bit_pallas_{v}"] = (nt, nt, nt // 4, None)
    for v in ("swar", "shuffle", "select"):
        t[f"decode_2bit_pallas_{v}"] = (nt, nt // 4, nt, None)
    for v in ("", "_planar", "_checked"):
        t[f"encode_b5_pallas{v}"] = (nt5, nt5, w5, None)
    t["decode_b5_pallas_nt4"] = (nt5, w5, nt5, None)
    for v in ("nt4_padded", "interleaved", "digits"):
        t[f"decode_b5_pallas_{v}"] = (nt5, w5, padded, None)
    t["decode_b5_pallas_checked"] = (nt5, w5, nt5 * (896 + 128) * 4 // 3456, None)
    if full:
        t["decode_b5_pallas_u8"] = (nt5, w5, nt5, None)
    xrows, xrows5 = (rows, rows_b5) if full else (rows // 8, rows_b5 // 8)
    x_nt, x_nt5 = xrows * 8192, xrows5 * 3456
    for v in ("mul", "dot"):
        t[f"encode_2bit_xla_{v}"] = (x_nt, x_nt, x_nt // 4, None)
    for v in ("shuffle", "broadcast"):
        t[f"decode_2bit_xla_{v}"] = (x_nt, x_nt // 4, x_nt, None)
    t["encode_b5_xla"] = (x_nt5, x_nt5, 8 * (x_nt5 // 27), None)
    t["decode_b5_xla"] = (x_nt5, 8 * (x_nt5 // 27), x_nt5, None)
    words = rows * 512
    kmw = max(min(max(((1 << 20) // scale) & ~127, 128), words) & ~127, 128)
    kc, mz = min(words, 1 << 18), kmw // 2
    t["kmer_codes_k15"] = (16 * kmw, 8 * kmw, 64 * kmw, None)
    t["kmer_histogram_k8"] = (16 * kmw, 4 * kmw, 4 * 4**8, None)
    t["kmer_codes_k31_pair"] = (16 * kmw, 12 * kmw, 128 * kmw, None)
    t["kmer_counts_k21"] = (16 * kc, 12 * kc, 8 * (16 * kc - 20), "sort")
    t["minimizers_w10_k15"] = (16 * mz, 4 * mz, 16 * mz, "operations")
    t["minimizer_bits_w10_k15"] = (16 * mz, 4 * mz, 4 * mz, "operations")
    t["sketch_bottom1k_k21"] = (16 * kc, 12 * kc, 64 * kc, "sort")
    t["revcomp_packed"] = t["revcomp_packed_ragged"] = (16 * words, 4 * words, 4 * words, None)
    t["gc_content_packed"] = (16 * words, 4 * words, 4, None)
    t["search_scan_7nt"] = t["search_scan_45nt"] = (4 * words, 4 * words, 4 * words, None)
    n5 = 2 * (nt5 // 27)
    t["search_b5_7nt"] = t["search_b5_45nt"] = (4 * n5, 5 * n5, 2 * n5, None)
    t["gc_content_packed_b5"] = ((n5 // 2) * 27, 4 * n5, 4 * -(-n5 // 256), None)
    t["revcomp_packed_b5"] = ((n5 // 2) * 27, 4 * n5, 4 * n5, "operations")
    t["hamming_packed"] = (16 * words, 8 * words, 4 * rows, None)
    ph = min(4096, rows)
    t["pairwise_hamming_4096"] = (ph * 8192, ph * 8192, 4 * ph * ph, None)
    t["pairwise_hamming_packed_4096"] = (ph * 8192, 4 * ph * 512, 4 * ph * ph, None)
    al = min(8192, rows)
    t["edit_distance_m128_n2048"] = (al * 128 * 2048, 4 * (al * 8 + al * 128), 4 * al, None)
    ap = min(words, 4 << 20)
    t["approx_stream_m21"] = (16 * ap * 21, 4 * ap, 8, None)
    hb = min(rows, 4096) * 8192
    for name in ("host_memcpy", "host_oracle_encode", "host_oracle_decode"):
        t[name] = (hb, None, None, None)
    t["host_myers_m128"] = (128 * min(hb, 1 << 20), None, None, None)
    return {_port_name(k): v for k, v in t.items()}


@pytest.fixture(scope="module")
def table():
    return bench.build_rows("cpu", scale=4096, full=True)


def test_row_names_are_the_reference_table_with_the_tier_swapped(table):
    with open(REPO / "BENCH_DETAIL.json") as f:
        ref = list(json.load(f)["detail"])
    assert len(ref) == 51
    want = [_port_name(n) for n in ref if n not in STREAM]
    assert STREAM <= set(ref) and set(bench.STREAM_ROWS) == STREAM
    want.insert(want.index("decode_b5_cuda_checked") + 1, "decode_b5_cuda_u8")  # BENCH_FULL's extra row
    assert [r.name for r in table] == want and len(want) == 49
    short = [r.name for r in bench.build_rows("cpu", scale=4096)]
    assert short == [n for n in want if n != "decode_b5_cuda_u8"] and len(short) == 48


@pytest.mark.parametrize("scale, full", ((4096, True), (1024, False)))
def test_denominators_and_byte_models_equal_the_reference(scale, full):
    rows = bench.build_rows("cpu", scale=scale, full=full)
    want = _reference_rows(scale, full)
    assert set(want) == {r.name for r in rows}
    for r in rows:
        denom, read, write, tag = want[r.name]
        assert r.denom == denom, r.name
        if read is None:
            assert r.roofline is None and r.section == "host", r.name
        else:
            assert (r.roofline.read_bytes, r.roofline.write_bytes) == (read, write), r.name
        assert r.bound_override == tag, r.name


def test_rows_calls_per_run_are_the_reference_chain_lengths(table):
    k = {r.name: r.k for r in table}
    assert k["memcpy_device"] == k["decode_b5_cuda_u8"] == k["search_b5_45nt"] == k["revcomp_packed"] == 32
    assert k["kmer_codes_k15"] == k["minimizers_w10_k15"] == 16
    assert k["kmer_counts_k21"] == k["sketch_bottom1k_k21"] == 6
    assert k["encode_b5_torch"] == 32  # BENCH_FULL: the twins run the core chains
    assert {r.name: r.k for r in bench.build_rows("cpu", scale=4096)}["encode_b5_torch"] == 16
    assert k["hamming_packed"] == 32 and k["pairwise_hamming_4096"] == k["pairwise_hamming_packed_4096"] == 8
    assert k["edit_distance_m128_n2048"] == k["approx_stream_m21"] == 6


@pytest.mark.parametrize("scale", (4096, 64))
def test_myers_and_pairwise_rows_count_the_reference_work(scale):
    """The GCUPS rows keep the reference's DP-cell denominators (B m n,
    16 W m) and count the least integer instructions kernel #19 needs for
    the text nt they scan: 11 nb + 2 a nt (global, whose score the last
    column gives) over B n, 11 nb + 8 (semiglobal, a score and its best
    every nt) over the nt of the reference's own row plan, each row
    clamped at the stream's end; the all-pairs rows count their int8
    multiply-adds at two operations each, and their steps return what the
    reference's do."""
    from cute_nucleotides_tpu.ops import align as ref_align

    rows = {r.name: r for r in bench.build_rows("cpu", scale=scale)}
    n_rows = max(32768 // scale, 8)
    al = min(8192, n_rows)
    assert rows["edit_distance_m128_n2048"].denom == al * 128 * 2048
    assert rows["edit_distance_m128_n2048"].roofline.int_ops == al * 2048 * (11 * 4 + 2)
    W = min(n_rows * 512, 4 << 20)
    R, wrb, H = ref_align.stream_rows_plan(W, 21)
    nt = sum(min(max(16 * W - 16 * wrb * r, 0), 16 * (wrb + H)) for r in range(R))
    assert 16 * W <= nt <= R * 16 * (wrb + H)
    assert rows["approx_stream_m21"].denom == 16 * W * 21
    assert rows["approx_stream_m21"].roofline.int_ops == nt * (11 * 1 + 8)
    ph = min(4096, n_rows)
    for name in ("pairwise_hamming_4096", "pairwise_hamming_packed_4096"):
        assert rows[name].roofline.tensor_ops == 2 * ph * ph * 4 * 8192 and rows[name].roofline.int_ops == 0
    if scale == 4096:  # the bench's batch, remade from its seed: the stream row's (dist, end)
        from cute_nucleotides_tpu_torch.ops import native

        reads = np.random.default_rng(0xC0DEC).choice(np.frombuffer(b"ACGTUacgtu", np.uint8), (n_rows, 8192))
        words = np.ascontiguousarray(native.n_to_bits(reads.reshape(-1))).view(np.uint32)
        want = ref_align.best_match_stream(words, 16 * words.size, bench.APPROX_QUERY)
        assert tuple(rows["approx_stream_m21"].step().tolist()) == want


def test_every_step_runs_once_through_the_timer(table, capsys):
    calls = []

    def timer(row):
        calls.append(row.name)
        out = row.step()
        assert out is not None
        return 1e-3, 2e-5

    results = bench.run_rows(table, timer, bench.Results())
    assert calls == [r.name for r in table] and not results.failed
    assert set(results.gibs) == set(results.ms) == set(calls)
    assert all(v > 0 for v in results.gibs.values())
    assert results.latency_ms["memcpy_device"] == pytest.approx(2e-2)
    assert results.bound["kmer_counts_k21"] == "sort" and "kmer_counts_k21" not in results.sol
    assert results.bound["search_scan_7nt"] == "bytes" and results.sol["search_scan_7nt"] > 0
    assert "host_memcpy" not in results.bound
    assert all(counts == {} for counts in results.launches.values())  # the CPU launches nothing
    err = capsys.readouterr().err.splitlines()
    assert len(err) == len(table) and err[0].startswith("memcpy_device") and "GiB/s" in err[0]


def test_launches_failures_and_sections_are_accounted():
    def planar_step():
        K.encode_b5_planar.launches += 2
        return torch.zeros(1)

    def broken():
        raise RuntimeError("boom")

    rows = [bench.Row("a", "core", planar_step, 10, bench.Roofline(10, 10)),
            bench.Row("b", "core", broken, 10), bench.Row("c", "packed", lambda: torch.zeros(1), 10),
            bench.Row("d", "host", lambda: 0, 10)]
    results = bench.run_rows(rows, lambda r: (r.step(), (1.0, 0.0))[1], bench.Results(), sections={"core", "host"})
    assert results.launches["a"] == {"encode_b5_planar": 2}
    assert results.failed == ["b"] and results.gibs["b"] == 0.0
    assert "c" not in results.gibs and "d" in results.gibs
    late = bench.run_rows(rows[2:], lambda r: (1.0, 0.0), bench.Results(), budget_s=0.0, t_start=0.0)
    assert late.gibs == {}  # sections after core are skipped past the budget
    K.reset_launch_counts()


def test_headline_and_detail_file(tmp_path, capsys):
    results = bench.Results(device={"name": "card"})
    for name, v in (("memcpy_device", 900.0), ("encode_2bit_cuda_mul", 800.0), ("encode_2bit_cuda_mxu", 300.0),
                    ("decode_b5_cuda_nt4", 700.0), ("gc_content_packed_b5", 2000.0)):
        results.gibs[name] = v
    path = str(tmp_path / "d" / "detail.json")
    bench.emit(results, path)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "gbps_per_chip", "vs_device_memcpy",
                          "vs_reference_memcpy", "chips", "champions_gibs", "detail_file"]
    assert line["metric"] == "encode_2bit_throughput" and line["value"] == 800.0 and line["chips"] == 1
    assert line["vs_device_memcpy"] == round(800 / 900, 3) and line["vs_baseline"] == round(800 / 28.962, 3)
    champions = line["champions_gibs"]
    assert champions["decode_b5"] == 700.0 and champions["gc_b5"] == 2000.0
    assert champions["stream_encode"] is champions["edit_distance_gcups"] is champions["encode_b5"] is None
    assert line["detail_file"] == path
    with open(path) as f:
        detail = json.load(f)
    assert {"detail", "sol_frac", "bound", "dispatch_latency_ms", "stream", "device", "launches"} <= set(detail)
    assert detail["stream"] == {} and detail["device"] == {"name": "card"}


def test_stream_rows_on_the_cpu_tier():
    """The stream rows at scale 4096 (8 reads of 2048 nt, one batch of 4096
    rows) on the CPU tier: every field of each row, the sunk bytes, the
    counts, the stage keys; no H2D rate and no kernel launch off the card;
    the headline's stream champions become numbers."""
    from cute_nucleotides_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    before = set(os.listdir(_build.BUILD_DIR))
    results = bench.Results()
    bench.run_stream_rows(results, "cpu", scale=4096)
    assert results.stream["link_h2d_mib_s"] is None and not results.failed
    assert set(os.listdir(_build.BUILD_DIR)) <= before  # the FASTQ file went with its directory
    stages = {"prep_wait_s", "dispatch_s", "backpressure_s", "finish_s", "readback_s", "sink_s", "manifest_s",
              "wall_s"}
    for name in bench.STREAM_ROWS:
        row = results.stream[name]
        assert results.gibs[name] > 0 and results.ms[name] > 0 and results.launches[name] == {}
        assert row["gbp_s"] == pytest.approx(results.gibs[name] * 2**30 / 1e9)
        assert row["reads_per_s"] == pytest.approx(8 / (results.ms[name] / 1e3))
        assert (row["total_reads"], row["total_nt"], row["batches"], row["runs"]) == (8, 8 * 2048, 1, 3)
        assert row["link_saturation"] is row["link_saturation_range"] is None
        assert set(row["stages"]) == stages and row["launches"] == {}
        assert row["sunk_bytes"] == (8 * 2048 if name == "stream_decode_e2e" else 4096 * 128 * 4)
    line = json.loads(bench.headline(results, "d.json"))
    assert line["champions_gibs"]["stream_encode"] == round(results.gibs["stream_encode_e2e"], 3)
    assert line["champions_gibs"]["stream_decode"] == round(results.gibs["stream_decode_e2e"], 3)
    assert bench.h2d_mib_s("cpu") is None


def test_config_from_env():
    default = bench.Config.from_env({})
    assert (default.scale, default.full, default.sections) == (1, False, frozenset())
    assert default.detail_path.endswith(os.path.join("build", "bench_detail.json"))
    partial = bench.Config.from_env({"BENCH_SCALE": "8", "BENCH_FULL": "1"})
    assert partial.full and partial.detail_path.endswith("bench_detail.partial.json")
    assert bench.Config.from_env({"BENCH_SECTIONS": "core,host"}).detail_path.endswith("partial.json")
    assert bench.Config.from_env({"BENCH_DETAIL_PATH": "x.json"}).detail_path == "x.json"
    assert "BENCH_DETAIL.json" not in default.detail_path
    with pytest.raises(ValueError, match="unknown BENCH_SECTIONS"):
        bench.Config.from_env({"BENCH_SECTIONS": "xla"})


def test_main_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA is not available"):
        bench.main({})


def test_bench_command_without_cuda_exits_1_with_one_error_line():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "cute_nucleotides_tpu_torch", "bench"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and proc.stdout == ""
    assert proc.stderr.strip().splitlines() == ["error: bench measures the card, and CUDA is not available"]


# --- the uint32 operations the card lacks ---------------------------------------

#: aten ops that raise NotImplementedError for uint32 on the card (probed:
#: bitwise and shifts; add, lt and minimum are not in its uint32 kernels)
_MISSING_ON_CARD = {"bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not", "bitwise_left_shift",
                    "bitwise_right_shift", "__and__", "__or__", "__xor__", "__lshift__", "__rshift__", "__iand__",
                    "__ior__", "__ixor__", "__ilshift__", "__irshift__", "add", "add_", "lt", "minimum"}


class _CardUint32(TorchDispatchMode):
    """Raise, as the card does, where one of those ops meets a uint32 tensor."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket.__name__ in _MISSING_ON_CARD and any(
                isinstance(a, torch.Tensor) and a.dtype == torch.uint32 for a in tree_flatten((args, kwargs))[0]):
            raise NotImplementedError(f"{func} on uint32 (missing on the card)")
        return func(*args, **kwargs)


def test_the_guard_catches_uint32_bit_ops():
    w = torch.arange(4, dtype=torch.int32).view(torch.uint32)
    for op in (lambda: w & 1, lambda: w >> 1, lambda: w + w, lambda: w < w, lambda: torch.minimum(w, w)):
        with _CardUint32(), pytest.raises(NotImplementedError, match="missing on the card"):
            op()
    with _CardUint32():
        assert torch.equal((w.view(torch.int32) & 1), torch.tensor([0, 1, 0, 1], dtype=torch.int32))


def test_torch_twins_and_planar_plain_versions_avoid_the_missing_ops():
    """The six functions of the bench's torch rows, and the plain versions
    of #15-#17 that chip_smoke.py runs on the card, under the guard: each
    equals its unguarded result."""
    rng = np.random.default_rng(1)
    x = interop.to_tensor(rng.choice(np.frombuffer(b"ACGTUacgtu", np.uint8), size=(3, 256)))
    x5 = interop.to_tensor(rng.choice(np.frombuffer(b"ACGTUNacgtun", np.uint8), size=(2, K.B5_ROW_NT)))
    w2 = eager.encode_2bit_words(x, "mul")
    w5 = eager.encode_b5_words(x5)
    lo, hi = K.encode_b5_planar_plain(x5)
    calls = {"encode mul": lambda: eager.encode_2bit_words(x, "mul"),
             "encode dot": lambda: eager.encode_2bit_words(x, "dot"),
             "decode shuffle": lambda: eager.decode_2bit_bytes(w2, "shuffle"),
             "decode broadcast": lambda: eager.decode_2bit_bytes(w2, "broadcast"),
             "encode b5": lambda: eager.encode_b5_words(x5), "decode b5": lambda: eager.decode_b5_bytes(w5),
             "#15 plain": lambda: K.encode_b5_planar_plain(x5)[1],
             "#16 plain": lambda: K.decode_b5_nt4_panels_plain(lo, hi),
             "#16 compact plain": lambda: K.decode_b5_nt4_panels_plain(lo, hi, padded=False),
             "#17 plain": lambda: K.decode_b5_panels_plain(lo, hi)}
    for label, call in calls.items():
        want = call()
        with _CardUint32():
            got = call()
        assert torch.equal(got.view(torch.int32) if got.dtype == torch.uint32 else got,
                           want.view(torch.int32) if want.dtype == torch.uint32 else want), label


def test_align_and_distance_paths_avoid_the_missing_ops():
    """#19's plain version (both alphabets, every mode, batch and stream
    rows), the Peq constructors, the stream forms and the distance functions,
    all of which chip_smoke.py and the bench run on the card, under the
    guard: each equals its unguarded result."""
    from cute_nucleotides_tpu_torch.ops import align, distance

    rng = np.random.default_rng(2)
    words = interop.to_tensor(rng.integers(0, 2**32, 40, dtype=np.uint32))
    q2 = interop.to_tensor(rng.integers(0, 2**32, (4, 3), dtype=np.uint32))
    lens = torch.tensor([48, 20, 0, 33], dtype=torch.int32)
    peq4 = align.peq_from_packed(q2, lens)
    peq5 = align._peq_b5(q2[:, :2].contiguous(), [27, 20, 0, 5])
    reads = interop.to_tensor(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(5, 70)))
    calls = {"peq 2-bit": lambda: align.peq_from_packed(q2, lens),
             "peq b5": lambda: align._peq_b5(q2[:, :2].contiguous(), [27, 20, 0, 5]),
             "stream 2-bit": lambda: torch.tensor(align.best_match_stream(words, 600, b"GATNACA")),
             "stream b5": lambda: torch.tensor(align.best_match_stream_b5(words, 500, b"GAT?ACA")),
             "hamming": lambda: distance.hamming_packed(q2, q2.flip(0)),
             "pairwise": lambda: distance.pairwise_hamming(reads, chunk=32),
             "pairwise packed": lambda: distance.pairwise_hamming_packed(q2, chunk=8)}
    for mode in K.MYERS_MODES:
        for b5, peq in ((False, peq4), (True, peq5)):
            if mode == "ends" and b5:
                continue
            calls[f"#19 {mode} b5={b5}"] = lambda mode=mode, b5=b5, peq=peq: K.myers_scan_plain(
                peq, lens, words, torch.tensor([300, 7, 0, 160], dtype=torch.int32), 10, 10, mode=mode, b5=b5,
                max_errors=torch.tensor([0, 2, 2**31 - 1, 3], dtype=torch.int32))
            calls[f"#19 {mode} b5={b5} stream rows"] = lambda mode=mode, b5=b5, peq=peq: K.myers_scan_plain(
                peq[:1].expand(10, *peq.shape[1:]), torch.full((10,), 20, dtype=torch.int32), words,
                torch.full((10,), 200, dtype=torch.int32), 4, 14, mode=mode, b5=b5,
                max_errors=torch.full((10,), 9, dtype=torch.int32))
    for label, call in calls.items():
        want = call()
        with _CardUint32():
            got = call()
        for g, w in zip(*((x if isinstance(x, tuple) else (x,)) for x in (got, want))):
            assert torch.equal(g.view(torch.int32) if g.dtype == torch.uint32 else g,
                               w.view(torch.int32) if w.dtype == torch.uint32 else w), label
