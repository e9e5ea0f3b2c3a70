"""The port never loads JAX, and nothing in it runs on the CPU in place of
the card: ``tier="cuda"`` and ``chip_smoke.py`` fail without CUDA."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cute_nucleotides_tpu_torch"


def _run(code_or_args, cwd=REPO):
    # CUDA_VISIBLE_DEVICES="" hides any card, so these hold on a GPU host too
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO))
    args = ["-c", code_or_args] if isinstance(code_or_args, str) else code_or_args
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax\b|import jaxlib|from jaxlib\b)", re.M)
    sources = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    assert len(sources) >= 10
    assert [str(p) for p in sources if pattern.search(p.read_text())] == []


def test_chip_smoke_imports_only_the_port():
    """The on-card gate imports the port, never the reference (its host
    oracle is the port's own, through the api's "oracle" tier)."""
    pattern = re.compile(r"^\s*(import|from)\s+cute_nucleotides_tpu\b", re.M)
    assert pattern.findall((REPO / "chip_smoke.py").read_text()) == []


IMPORTS_REFERENCE = re.compile(r"^\s*(import|from)\s+cute_nucleotides_tpu(\.|\s|$)", re.M)


def test_port_sources_never_import_the_reference():
    """No module of the port, and not chip_smoke.py, imports anything of the
    JAX package, not even its numpy-only layers: the port keeps its own
    copies (spec, oracle, the C++ oracle, utils/io, the .nup container)."""
    sources = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    assert len(sources) >= 20
    assert [str(p) for p in sources if IMPORTS_REFERENCE.search(p.read_text())] == []


def test_port_paths_leave_the_reference_unloaded(tmp_path):
    """api, compat, the CLI (encode, decode, grep, stats, sketch), kmer
    (counts, minimizers) and sketch, driven in one process: afterwards no
    cute_nucleotides_tpu module is loaded."""
    code = f"""
import sys
from cute_nucleotides_tpu_torch import api, cli, compat, interop
from cute_nucleotides_tpu_torch.ops import kmer, sketch
d = {str(tmp_path)!r}
seq = b"ACGTGATTACAGGGGTGTAATCCC" * 40
assert compat.n_to_bits_pext(seq).tolist() == api.n_to_bits(seq, tier="oracle").tolist()
with open(d + "/r.fa", "wb") as f:
    f.write(b">r1\\n" + seq + b"\\n>r2\\nACGT\\n")
assert cli.main(["encode", d + "/r.fa", d + "/r.nup"]) == 0
assert cli.main(["decode", d + "/r.nup", d + "/back.fa"]) == 0
assert cli.main(["grep", d + "/r.nup", "GATTACA", "--both", "--count"]) == 0
for argv in (["-k", "8", "--canonical"], ["-k", "21"]):
    assert cli.main(["stats", d + "/r.nup", *argv]) == 0
    assert cli.main(["stats", d + "/r.fa", *argv]) == 0
w = interop.u64_to_tensor(api.n_to_bits(seq))
assert int(kmer.kmer_histogram(w, len(seq), 5).sum()) == len(seq) - 4
assert int(kmer.kmer_counts(w, len(seq), 25, canonical=True)[2].sum()) == len(seq) - 24
assert cli.main(["sketch", d + "/r.fa", d + "/r.nup", "-k", "21", "-s", "64"]) == 0
assert cli.main(["sketch", d + "/r.fa", "-k", "9", "--scale", "2", "-s", "64"]) == 0
assert sketch.jaccard(sketch.bottom_k_sketch(w, len(seq), 21, 64), sketch.bottom_k_sketch(w, len(seq), 21, 64)) == 1
long = interop.u64_to_tensor(api.n_to_bits(seq * 20))  # 1200 u32: the kernel route of minimizers
mask, h = kmer.minimizers(long, 20 * len(seq), 15, 10)
assert kmer.minimizer_bits(long, 20 * len(seq), 15, 10).numel() == -(-mask.numel() // 16)
loaded = sorted(m for m in sys.modules if m == "cute_nucleotides_tpu" or m.startswith("cute_nucleotides_tpu."))
print("REFERENCE", loaded)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "REFERENCE []" in proc.stdout


def test_port_runs_without_loading_jax():
    code = """
import sys
import cute_nucleotides_tpu_torch as cnt
from cute_nucleotides_tpu_torch import api, cli, compat, interop, models
from cute_nucleotides_tpu_torch.ops import eager, kernels, search, seqops, validate
import chip_smoke
seq = b"ACGTUacgtuNACGT" * 11
words = api.n_to_bits(seq)
back = api.bits_to_n(words, len(seq))
assert bytes(back) == seq.upper().replace(b"U", b"T").replace(b"N", b"G")
codec = models.TwoBitCodec()
x = interop.to_tensor(bytes(seq[:160]), "cpu").view(2, 80)
assert codec.decode(codec.encode(x)).shape == (2, 80)
assert compat.n_to_bits_pext(b"ACGT" * 8).tolist() == compat.n_to_bits_lut(b"ACGT" * 8).tolist()
words2 = api.n_to_bits2(seq)
assert bytes(api.bits_to_n2(words2, len(seq))) == seq.upper().replace(b"U", b"T")
b5 = models.Base5Codec()
w5, bad = b5.decode_checked(b5.encode(interop.to_tensor(bytes(seq[:162]), "cpu").view(2, 81)))
assert w5.shape == (2, 81) and not bool(bad)
assert int(seqops.first_invalid_word_b5(b5.encode(x[:, :54]))[0]) == -1
assert compat.n_to_bits2_pext(b"ATCGN" * 7).tolist() == compat.n_to_bits2_lut(b"ATCGN" * 7).tolist()
hay = b"ACGTGATTACAGGGGTGTAATCCC" * 50
assert search.match_positions(interop.u64_to_tensor(api.n_to_bits(hay)), len(hay), b"GATTACA").tolist() == list(range(4, 1200, 24))
hay5 = b"ACGTNGATTACAN" * 2200  # 1059 u32: the kernel tier's plain version
w5 = interop.u64_to_tensor(api.n_to_bits2(hay5))
assert w5.shape[0] >= 1024 and search._use_b5_kernel(w5, b"TACAN")
assert search.match_positions_b5(w5, len(hay5), b"TACAN").tolist() == list(range(8, len(hay5), 13))
from cute_nucleotides_tpu_torch.ops import kmer, sketch
w2 = interop.u64_to_tensor(api.n_to_bits(hay5))
assert int(sketch.frac_sketch(w2, len(hay5), 21, scale=1, cap=64)[1]) == 13
assert kmer.minimizers(w2, len(hay5), 15, 10)[0].any()
import numpy as np, torch
from cute_nucleotides_tpu_torch import parallel
from cute_nucleotides_tpu_torch.parallel import longseq
mesh = parallel.make_mesh(2, 2, devices=[torch.device("cpu")] * 4)
assert np.array_equal(longseq.encode_long_b5(hay5, mesh=mesh), api.n_to_bits2(hay5))
assert longseq.best_match_long(api.n_to_bits(hay5), len(hay5), b"GATTACA", mesh=mesh) == (0, 12)
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("JAX", loaded)
assert not loaded, loaded
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "JAX []" in proc.stdout


def test_seqops_sort_and_their_commands_load_neither_jax_nor_the_reference(tmp_path):
    """region (FASTA and --packed), translate and dedup on both codecs, the
    seqops functions (kernel #7's route included) and sort_pairs on both
    routes, in one process: afterwards no jax and no cute_nucleotides_tpu
    module is loaded; kernels #7 and #18 ran their plain versions (no
    launch counted) and refuse a device without kernels."""
    code = f"""
import sys
import torch
from cute_nucleotides_tpu_torch import api, cli, interop
from cute_nucleotides_tpu_torch.ops import kernels, seqops, sort
d = {str(tmp_path)!r}
seq = b"ACGTGATTACAGGGGTGTAATCCCN" * 40
with open(d + "/r.fa", "wb") as f:
    f.write(b">r1\\n" + seq + b"\\n>r2\\nACGT\\n>r3\\nACGT\\n")
for codec in ("2bit", "base5"):
    nup = d + "/r_" + codec + ".nup"
    assert cli.main(["encode", d + "/r.fa", nup, "--codec", codec]) == 0
    assert cli.main(["region", nup, "r1:5-700", "r2:1-3", "-o", d + "/w.fa"]) == 0
    assert cli.main(["region", nup, "r1:5-700", "--packed", "-o", d + "/w.nup"]) == 0
    assert cli.main(["translate", nup, d + "/p.fa", "--frames", "all"]) == 0
    assert cli.main(["dedup", nup, d + "/u.nup"]) == 0
w2 = interop.u64_to_tensor(api.n_to_bits(seq))
w5 = interop.u64_to_tensor(api.n_to_bits2(seq * 30))  # 2224 u32: kernel #7's route
n = len(seq)
kernels.reset_launch_counts()
joined = seqops.packed_concat(seqops.packed_slice(w2, 0, 7), 7, seqops.packed_slice(w2, 7, n - 7), n - 7)
assert joined.view(torch.int32).equal(w2.view(torch.int32))
assert int(seqops.gc_content_packed_b5(w5)) == 30 * (seq.count(b"C") + seq.count(b"G"))
assert int(seqops.n_count_packed_b5(w5)) == 30 * 40
assert seqops.revcomp_packed_b5(seqops.revcomp_packed_b5(w5, 30 * n), 30 * n).view(torch.int32).equal(w5.view(torch.int32))
assert len(seqops.translate_6frame(w2, n)) == len(seqops.translate_6frame_b5(w5, 30 * n)) == 6
assert seqops.duplicate_mask(w2.view(2, -1).repeat(2, 1), [n, n, n, 3]).tolist() == [False, False, True, False]
keys = interop.to_tensor(torch.randint(0, 1 << 32, (5000,), dtype=torch.int64).to(torch.int32).view(torch.uint32).numpy())
for prefer in ("lax", "bitonic"):
    hi, lo = sort.sort_pairs(keys, keys, prefer=prefer)
    assert hi.view(torch.int32).equal(lo.view(torch.int32))
assert all(fn.launches == 0 for fn in kernels.WRAPPERS)
for call in (lambda: kernels.gc_b5_stream(w5.to("meta")), lambda: seqops.gc_content_packed_b5(w5.to("meta")),
             lambda: kernels.sort_pairs_bitonic(keys.to("meta"), keys.to("meta")),
             lambda: sort.sort_pairs(keys.to("meta"), keys.to("meta"), prefer="bitonic")):
    try:
        call()
    except ValueError as e:
        assert str(e) == "no kernel for device meta", e
        print("refused")
    else:
        raise SystemExit("computed on a device without kernels")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cute_nucleotides_tpu"))
print("LOADED", loaded)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout and proc.stdout.count("refused") == 4


def test_align_distance_and_approx_load_neither_jax_nor_the_reference(tmp_path):
    """distance, every align scan of both codecs, the stream forms, the host
    Myers and ``approx`` (--both --cigar, --all) in one process: afterwards
    no jax and no cute_nucleotides_tpu module is loaded, kernel #19 ran its
    plain version (no launch counted) and refuses a device without
    kernels."""
    code = f"""
import sys
import numpy as np, torch
from cute_nucleotides_tpu_torch import api, cli, interop
from cute_nucleotides_tpu_torch.ops import align, distance, kernels, native
d = {str(tmp_path)!r}
seq = b"ACGTGATTACAGGGGTGTAATCCC" * 20
with open(d + "/r.fa", "wb") as f:
    f.write(b">r1\\n" + seq + b"\\n>r2\\nGATTACA\\n")
kernels.reset_launch_counts()
for codec in ("2bit", "base5"):
    nup = d + "/r_" + codec + ".nup"
    assert cli.main(["encode", d + "/r.fa", nup, "--codec", codec]) == 0
    assert cli.main(["approx", nup, "GATTACA", "--both", "--cigar"]) == 0
assert cli.main(["approx", d + "/r_2bit.nup", "GATTACA", "--all", "--max-errors", "1"]) == 0
w2 = interop.u64_to_tensor(api.n_to_bits(seq))
w5 = interop.u64_to_tensor(api.n_to_bits2(seq))
assert align.best_match_stream(w2, len(seq), b"GATTNCA") == native.best_match(b"GATTNCA", seq) == (0, 11)
assert align.best_match_stream_b5(w5, len(seq), b"GATTACA") == (0, 11)
rows = interop.u64_to_tensor(api.n_to_bits(seq * 2))[:32].view(2, 16)
q = rows[:, :1].contiguous()
lens = torch.tensor([16, 16])
assert align.edit_distance_packed(q, lens, rows, [256, 256]).tolist() == [240, 240]
assert align.best_match_packed(q, lens, rows, [256, 256])[0].tolist() == [0, 0]
assert align.prefix_distance_packed(q, lens, rows, [256, 256])[0].tolist() == [0, 0]
assert align.match_ends_packed(q, lens, rows, [256, 256], [0, 0]).sum().item() > 0
assert distance.hamming_packed(rows, rows).tolist() == [0, 0]
assert distance.pairwise_hamming(interop.to_tensor(np.frombuffer(seq, np.uint8).reshape(4, -1))).shape == (4, 4)
assert all(fn.launches == 0 for fn in kernels.WRAPPERS)
peq = torch.zeros((1, 4, 1), dtype=torch.uint32, device="meta")
lens = torch.zeros(1, dtype=torch.int32, device="meta")
try:
    kernels.myers_scan(peq, lens, torch.zeros(1, dtype=torch.uint32, device="meta"), lens, 1, 1, mode="global")
except ValueError as e:
    assert str(e) == "no kernel for device meta", e
    print("refused")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cute_nucleotides_tpu"))
print("LOADED", loaded)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout and "refused" in proc.stdout


def test_cuda_tier_without_cuda_raises():
    code = """
import numpy as np, torch
from cute_nucleotides_tpu_torch import api, models
from cute_nucleotides_tpu_torch.ops import kernels
assert not torch.cuda.is_available()
for call in (lambda: api.n_to_bits(b"ACGT", tier="cuda"),
             lambda: api.bits_to_n(np.zeros(1, np.uint64), 4, tier="cuda"),
             lambda: models.TwoBitCodec(tier="cuda"),
             lambda: models.TwoBitCodec(tier="cuda", device="cpu"),
             lambda: api.n_to_bits(b"ACGT", tier="auto", device="cuda"),
             lambda: api.n_to_bits2(b"ACGTN", tier="cuda"),
             lambda: api.bits_to_n2(np.zeros(1, np.uint64), 5, tier="cuda"),
             lambda: models.Base5Codec(tier="cuda")):
    try:
        call()
    except (RuntimeError, ValueError) as e:
        print("raised", type(e).__name__)
    else:
        raise SystemExit("no error")
print("auto resolves to", models.TwoBitCodec().tier, models.Base5Codec().tier)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("raised") == 8
    assert "auto resolves to torch torch" in proc.stdout


def test_bench_loads_neither_jax_nor_the_reference():
    """The bench and its roofline module are scanned with the rest of the
    port; its CPU path (the row table, every step once, the headline) and
    the planar kernels' plain versions leave no jax and no
    cute_nucleotides_tpu module loaded and launch nothing."""
    sources = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"bench.py", "utils/profiling.py"} <= sources
    for name in ("bench.py", "utils/profiling.py"):
        assert not IMPORTS_REFERENCE.search((PORT / name).read_text())
        assert not re.search(r"^\s*(import jax|from jax\b)", (PORT / name).read_text(), re.M)
    code = """
import sys
from cute_nucleotides_tpu_torch import bench
from cute_nucleotides_tpu_torch.ops import kernels
rows = bench.build_rows("cpu", scale=4096, full=True)
kernels.reset_launch_counts()
results = bench.run_rows(rows, lambda row: (row.step(), (1e-3, 0.0))[1], bench.Results())
assert len(results.gibs) == 49 and not results.failed
assert all(fn.launches == 0 for fn in kernels.WRAPPERS)
print(bench.headline(results, "detail.json"))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cute_nucleotides_tpu"))
print("LOADED", loaded)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout and '"metric": "encode_2bit_throughput"' in proc.stdout


def test_chip_smoke_fails_without_cuda():
    proc = _run([str(REPO / "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA is not available" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_search_wrappers_run_plain_only_for_cpu_tensors():
    code = """
import torch
from cute_nucleotides_tpu_torch import api, interop
from cute_nucleotides_tpu_torch.ops import kernels, kmer, search
hay = b"ACGTNGATTACAN" * 2200
w2 = interop.u64_to_tensor(api.n_to_bits(hay))
w5 = interop.u64_to_tensor(api.n_to_bits2(hay))
q, care, m = search.compile_query(b"GATTACA")
qc = search.compile_query_b5(b"GAT?ACA")
kernels.reset_launch_counts()
assert torch.equal(kernels.match_bits_stream(w2, q, care, len(hay) - 6),
                   kernels.match_bits_stream_plain(w2, q, care, len(hay) - 6))
assert torch.equal(kernels.match_b5_bits_stream(w5, qc, len(hay) - 6),
                   kernels.match_b5_bits_stream_plain(w5, qc, len(hay) - 6))
panels = w2[:1024].view(2, 512)
codes = kernels.kmer_codes_planar(panels, panels, 8)
assert torch.equal(codes, kernels.kmer_codes_planar_plain(panels, panels, 8))
assert all(torch.equal(a, b) for a, b in zip(kernels.kmer_codes_planar_pair(panels, panels, panels, 21),
                                             kernels.kmer_codes_planar_pair_plain(panels, panels, panels, 21)))
assert torch.equal(kernels.hist_codes(codes), kernels.hist_codes_plain(codes))
assert torch.equal(kernels.kmer_hashes_planar_pair(w2, 21, 9000), kernels.kmer_hashes_planar_pair_plain(w2, 21, 9000))
assert torch.equal(kernels.minimizer_bits_stream(w2, 9000, 15, 10), kernels.minimizer_bits_stream_plain(w2, 9000, 15, 10))
assert all(fn.launches == 0 for fn in kernels.WRAPPERS)
meta = panels.to("meta")
for call in (lambda: kernels.match_bits_stream(w2.to("meta"), q, care, 10),
             lambda: kernels.match_b5_bits_stream(w5.to("meta"), qc, 10),
             lambda: search.match_count(w2.to("meta"), len(hay), b"GATTACA"),
             lambda: search.match_positions_b5(w5.to("meta"), len(hay), b"GAT?ACA"),
             lambda: kernels.kmer_codes_planar(meta, meta, 8),
             lambda: kernels.kmer_codes_planar_pair(meta, meta, meta, 21),
             lambda: kernels.hist_codes(codes.to("meta")),
             lambda: kmer.kmer_histogram(w2.to("meta"), len(hay), 8),
             lambda: kmer.kmer_counts(w2.to("meta"), len(hay), 21),
             lambda: kernels.kmer_hashes_planar_pair(w2.to("meta"), 21, 100),
             lambda: kernels.minimizer_bits_stream(w2.to("meta"), 100, 15, 10),
             lambda: kmer.minimizer_bits(w2.to("meta"), len(hay), 15, 10)):
    try:
        call()
    except ValueError as e:
        assert str(e) == "no kernel for device meta", e
        print("refused")
    else:
        raise SystemExit("computed on a device without kernels")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("refused") == 12


def test_chip_smoke_holds_search_plain_versions_only_as_references():
    """In chip_smoke.py a search kernel's plain version is only ever the
    reference a kernel is compared with or timed beside, never a stand-in
    on the path it drives."""
    lines = (REPO / "chip_smoke.py").read_text().splitlines()
    calls = [i for i, line in enumerate(lines) if re.search(r"match_(b5_)?bits_stream_plain\(", line)]
    assert len(calls) >= 6
    for i in calls:
        assert "lambda" in lines[i] or "errors.compare(" in lines[i - 1] + lines[i], lines[i]


def test_stream_runtime_loads_neither_jax_nor_the_reference(tmp_path):
    """The streaming runtime and its host layers (``parallel``,
    ``utils/metrics.py``, ``utils/checkpoint.py``, ``fastq_batches``) driven
    on the CPU tier in one process: both codecs through FASTQ -> encoder ->
    decoder with a manifest; afterwards no jax and no cute_nucleotides_tpu
    module is loaded, and without CUDA the default stream raises."""
    code = f"""
import sys
from cute_nucleotides_tpu_torch.parallel import runtime
from cute_nucleotides_tpu_torch.ops import spec
from cute_nucleotides_tpu_torch.utils import io
d = {str(tmp_path)!r}
seqs = [b"ACGTNACGTTGCA" * (i % 7 + 1) for i in range(40)]
with open(d + "/r.fq", "wb") as f:
    f.write(b"".join(b"@r%d\\n%s\\n+\\n%s\\n" % (i, s, b"I" * len(s)) for i, s in enumerate(seqs)))
for codec, per in (("2bit", 32), ("base5", 27)):
    entries = []
    def keep(w, b):
        for i in range(b.count):
            n = int(b.lengths[i])
            entries.append((b"r%d" % b.indices[i], n, spec.u32_pairs_to_u64(w[i])[: -(-n // per)]))
    enc = runtime.StreamingEncoder(batch_size=8, max_len=96, codec=codec, device="cpu",
                                   manifest_path=d + "/" + codec + ".json")
    agg = enc.run_batches(io.fastq_batches(d + "/r.fq", 8, 96, block=per), keep)
    assert agg["total_reads"] == 40, agg
    got = {{}}
    runtime.StreamingDecoder(batch_size=8, codec=codec, tier="torch").run(entries, lambda n, s: got.__setitem__(n, s))
    want = {{b"r%d" % i: (s if codec == "base5" else s.replace(b"N", b"G")) for i, s in enumerate(seqs)}}
    assert got == want
try:
    runtime.StreamingEncoder()
except RuntimeError as e:
    print("raised", e)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cute_nucleotides_tpu"))
print("LOADED", loaded)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout and "raised device cuda requested but CUDA is not available" in proc.stdout
