"""The port's parallel layer on a mesh that spans processes, against the
JAX package's on the CPU (tolerance 0).

Two gloo groups run at once, with the cards hidden: 4 ranks of one CPU
shard each, and 2 ranks of 2 logical CPU shards each
(``mesh.devices([cpu] * 2)``).  Every rank calls every form of
``parallel/data_parallel.py`` and every function of ``parallel/longseq.py``
with the same whole numpy-seeded inputs (the parent writes them to disk) on
meshes of 4 devices -- (4, 1), (2, 2) and (1, 4) -- and writes what it holds:
a replicated result whole, a sharded one as its own shards with their
positions, and whether ``np.asarray`` of it raised.  The parent holds each
rank's results to the JAX function on a 4-device mesh of the same shape,
taken from the conftest's 8 virtual devices (``tier="xla"`` where a tier is
asked for), as ``tests/test_torch_parallel.py`` holds the mesh of one
controller; the long-sequence mode at the word seams (that file's
``SEAM_LENGTHS_*``) against the oracle and the one-stream search, as there.
The workers import only the port; where they ask for the ``cuda`` tier, the
kernel wrappers run their plain versions (CPU tensors)."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cute_nucleotides_tpu import parallel as ref_parallel
from cute_nucleotides_tpu.ops import oracle, spec
from cute_nucleotides_tpu.parallel import longseq as ref_longseq
from cute_nucleotides_tpu_torch.ops import align as port_align, search as port_search

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import SEAM_LENGTHS_2BIT, SEAM_LENGTHS_B5  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHABET = np.frombuffer(b"ACGTUacgtu", dtype=np.uint8)
ALPHABET_N = np.frombuffer(b"ACGTUNacgtun", dtype=np.uint8)
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
#: (ranks, logical CPU shards a rank): both groups span 4 devices
GROUPS = {"4x1": (4, 1), "2x2": (2, 2)}
LONG_NT = 40_013
Q2, Q5 = b"GATTACA", b"GAT?ACN"
BEST2, BEST5 = b"GATTACAGATTACAGATTACA", b"GATTACANGATTACANGATTA"

_WORKER = r"""
import json, sys
import numpy as np
import torch

rank, world, shards, coord, outdir = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
torch.distributed.init_process_group("gloo", init_method="tcp://" + coord, world_size=world, rank=rank)

from cute_nucleotides_tpu_torch import models, parallel
from cute_nucleotides_tpu_torch.parallel import longseq, mesh as mesh_lib, runtime

# the cuda tier on CPU tensors: its kernel wrappers run their plain versions
models.resolve_device = lambda tier, device=None: torch.device(device or "cpu")
info = runtime.initialize()
default = parallel.default_mesh()
devs = mesh_lib.devices([torch.device("cpu")] * shards)
meshes = {"data4": parallel.make_mesh(4, 1, devices=devs), "mesh22": parallel.make_mesh(2, 2, devices=devs),
          "seq4": parallel.make_mesh(1, 4, devices=devs)}
inp = dict(np.load(outdir + "/inputs.npz"))
dp = parallel.data_parallel
out = {"info": np.array(json.dumps(info)), "default_size": np.array(default.size),
       "default_ranks": np.array([d.process_index for row in default.devices for d in row])}


def keep(name, r):
    if isinstance(r, tuple):
        keep(name, r[0])
        keep(name + ".flag", r[1])
        return
    if r.replicated:
        out[name] = np.asarray(r)
        return
    out[name + ".shards"] = np.stack([s.numpy() for s in r.shards])
    out[name + ".pos"] = np.asarray(r.axis.mine)
    try:
        np.asarray(r)
        out[name + ".raises"] = np.array("")
    except RuntimeError as e:
        out[name + ".raises"] = np.array(str(e))


for mn in ("data4", "mesh22"):
    m = meshes[mn]
    keep(mn + "/encode", dp.data_parallel_encode(inp["batch2"], mesh=m))
    keep(mn + "/encode_gather", dp.data_parallel_encode(inp["batch2"], mesh=m, gather=True))
    keep(mn + "/kmer_spectrum", parallel.kmer_spectrum(inp["words2"], inp["lens2"], 6, mesh=m))
    keep(mn + "/match_counts", parallel.match_counts(inp["words2"], inp["lens2"], b"GANA", mesh=m))
m = meshes["data4"]
keep("data4/edit_distances", parallel.edit_distances(inp["qw"], 40, inp["tw"], 70, mesh=m))
keep("data4/encode_b5", dp.data_parallel_encode(inp["batch5"], mesh=m, codec="base5"))
keep("data4/encode_b5_gather", dp.data_parallel_encode(inp["batch5"], mesh=m, codec="base5", gather=True))
keep("data4/encode_mxu", dp.data_parallel_encode(inp["batch2"], mesh=m, tier="cuda", variant="mxu", gather=True))
keep("data4/decode", dp.data_parallel_decode(inp["words2"], mesh=m))
keep("data4/decode_gather", dp.data_parallel_decode(inp["words2"], mesh=m, gather=True))
keep("data4/decode_b5", dp.data_parallel_decode(inp["words5"], mesh=m, codec="base5"))
keep("data4/decode_b5_gather", dp.data_parallel_decode(inp["words5"], mesh=m, codec="base5", gather=True))
keep("data4/encode_checked", dp.data_parallel_encode_checked(inp["bad2"], mesh=m))
keep("data4/encode_checked_gather", dp.data_parallel_encode_checked(inp["bad2"], mesh=m, tier="cuda", gather=True))
keep("data4/encode_checked_b5", dp.data_parallel_encode_checked(inp["bad5"], mesh=m, codec="base5"))
keep("data4/decode_checked", dp.data_parallel_decode_checked(inp["corrupt5"], mesh=m))
keep("data4/decode_checked_cuda", dp.data_parallel_decode_checked(inp["corrupt5"], mesh=m, tier="cuda"))
keep("data4/kmer_spectrum_canonical", parallel.kmer_spectrum(inp["words2"], inp["lens2"], 6, mesh=m, canonical=True))
keep("data4/match_counts_b5", parallel.match_counts(inp["words5"], inp["lens5"], b"A?N", mesh=m, codec="base5"))
keep("data4/sketch_sharded", parallel.sketch_sharded(inp["words2"], inp["lens2"], 21, 16, mesh=m))
keep("data4/sketch_sharded_k9", parallel.sketch_sharded(inp["words2"], inp["lens2"], 9, 16, mesh=m, canonical=False))
keep("data4/edit_distances_b5", parallel.edit_distances(inp["qw5"], 40, inp["tw5"], 70, mesh=m, codec="base5"))
sc = parallel.ShardedCodec(mesh=m)
placed = sc.shard(inp["batch2"])
keep("data4/codec_shard", placed)
words = sc.encode(placed)
keep("data4/codec_encode", words)
keep("data4/codec_decode_gather", sc.decode(words, gather=True))
sc5 = parallel.ShardedCodec("base5", mesh=m)
keep("data4/codec_encode_checked_b5", sc5.encode_checked(inp["bad5"], gather=True))
keep("data4/codec_decode_checked_b5", sc5.decode_checked(inp["corrupt5"]))
try:
    dp.data_parallel_encode(inp["batch2"][:6], mesh=m)
    out["indivisible"] = np.array("")
except ValueError as e:
    out["indivisible"] = np.array(str(e))

n, m = int(inp["long_n"]), meshes["seq4"]
out["seq4/encode_long_2bit"] = longseq.encode_long_2bit(inp["long2"], mesh=m)
out["seq4/encode_long_b5"] = longseq.encode_long_b5(inp["long5"], mesh=m)
out["seq4/decode_long_2bit"] = longseq.decode_long_2bit(inp["bits2"], n, mesh=m)
out["seq4/decode_long_b5"] = longseq.decode_long_b5(inp["bits5"], n, mesh=m)
out["seq4/best_match_long"] = np.array(longseq.best_match_long(inp["bits2"], n, b"GATTACAGATTACAGATTACA", mesh=m))
out["seq4/best_match_long_b5"] = np.array(longseq.best_match_long_b5(inp["bits5"], n, b"GATTACANGATTACANGATTA", mesh=m))
for mn in ("seq4", "mesh22"):  # 2 seq shards replicated over 2 data rows on the (2, 2) mesh
    out[mn + "/encode_long_2bit"] = longseq.encode_long_2bit(inp["long2"], mesh=meshes[mn])
    out[mn + "/match_long"] = longseq.match_long(inp["bits2"], n, b"GATTACA", mesh=meshes[mn])
    out[mn + "/match_long_b5"] = longseq.match_long_b5(inp["bits5"], n, b"GAT?ACN", mesh=meshes[mn])
for key in [k for k in inp if k.startswith("seam/") and k.count("/") == 2]:
    codec, n = key.split("/")[1:]
    s, n = inp[key], int(n)
    if codec == "2bit":
        bits = longseq.encode_long_2bit(s, mesh=m)
        out[key + "/encode"] = bits
        out[key + "/decode"] = longseq.decode_long_2bit(bits, n, mesh=m)
        for i, q in enumerate((b"G", b"GNA", b"ACGTNACGTNACGTNACGTNACGTNACGTNACG"[: min(n, 33)])):
            out[key + f"/match{i}"] = longseq.match_long(bits, n, q, mesh=m)
        out[key + "/best"] = np.array(longseq.best_match_long(bits, n, bytes(inp[key + "/query"]), mesh=m))
    else:
        bits = longseq.encode_long_b5(s, mesh=m)
        out[key + "/encode"] = bits
        out[key + "/decode"] = longseq.decode_long_b5(bits, n, mesh=m)
        for i, q in enumerate((b"N", b"A?C", bytes(inp[key + "/query5"]))):
            out[key + f"/match{i}"] = longseq.match_long_b5(bits, n, q, mesh=m)
        out[key + "/best"] = np.array(longseq.best_match_long_b5(bits, n, bytes(inp[key + "/query"]), mesh=m))
out["collectives"] = np.array(mesh_lib._COLLECTIVES["gloo"])
np.savez(f"{outdir}/r{rank}.npz", **out)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rows(seqs, enc) -> np.ndarray:
    return np.stack([spec.u64_to_u32_pairs(enc(s)).reshape(-1) for s in seqs])


def _upper_t(s: np.ndarray) -> bytes:
    return s.tobytes().upper().replace(b"U", b"T")


def _inputs() -> dict:
    rng = np.random.default_rng(0x5EED)
    batch2 = rng.choice(ALPHABET, size=(16, 128))
    batch5 = rng.choice(ALPHABET_N, size=(16, 108))
    bad2, bad5 = batch2.copy(), batch5.copy()
    bad2[5, 100] = ord("X")
    bad5[3, 7] = bad5[12, 0] = ord("X")
    reads = rng.choice(ACGT, size=(16, 160))
    lens2 = np.array([160, 0, 5, 31, 32, 33, 100, 159, 1, 64, 65, 120, 16, 17, 150, 2], np.int32)
    for b in range(16):
        reads[b, lens2[b]:] = ord("A")
    words2 = _rows(reads, oracle.n_to_bits_lut)
    words5 = _rows(reads[:, :135], oracle.n_to_bits2_lut)
    corrupt5 = words5.copy()
    corrupt5[9, 1] |= np.uint32(1 << 31)  # bit 63 of row 9's first word
    qs = [rng.choice(ACGT, size=40) for _ in range(16)]
    ts = [rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=70) for _ in range(16)]
    long2 = rng.choice(ACGT, size=LONG_NT)
    long5 = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=LONG_NT)
    for k in range(1, 4):  # hits across each seam of a 4-way split, both codecs
        p2 = 16 * k * -(-2 * spec.num_words_2bit(LONG_NT) // 4) - 3
        long2[p2 : p2 + 7] = np.frombuffer(Q2, np.uint8)
        p5 = 27 * k * -(-spec.num_words_b5(LONG_NT) // 4) - 3
        long5[p5 : p5 + 7] = np.frombuffer(b"GATCACN", np.uint8)
    mut2, mut5 = bytearray(BEST2), bytearray(BEST5)
    mut2[10], mut5[2] = ord("C"), ord("C")
    p2 = 16 * 2 * -(-2 * spec.num_words_2bit(LONG_NT) // 4) - 5
    long2[p2 : p2 + 21] = np.frombuffer(bytes(mut2), np.uint8)
    p5 = 27 * 2 * -(-spec.num_words_b5(LONG_NT) // 4) - 5
    long5[p5 : p5 + 21] = np.frombuffer(bytes(mut5), np.uint8)
    inp = dict(batch2=batch2, batch5=batch5, bad2=bad2, bad5=bad5, words2=words2, words5=words5,
               lens2=lens2, lens5=np.minimum(lens2, 135), corrupt5=corrupt5,
               qw=_rows(qs, oracle.n_to_bits_lut), tw=_rows(ts, oracle.n_to_bits_lut),
               qw5=_rows(qs, oracle.n_to_bits2_lut), tw5=_rows(ts, oracle.n_to_bits2_lut),
               long_n=np.array(LONG_NT), long2=long2, long5=long5, bits2=oracle.n_to_bits_lut(long2),
               bits5=oracle.n_to_bits2_lut(long5))
    for n in SEAM_LENGTHS_2BIT:  # as tests/test_torch_parallel.py's seam cases
        s = rng.choice(ALPHABET_N, size=n)
        s[np.arange(0, n, 37)] = ord("G")
        inp[f"seam/2bit/{n}"] = s
        inp[f"seam/2bit/{n}/query"] = np.frombuffer(
            bytes(s[n // 3 : n // 3 + 4]) + b"N" + bytes(s[n // 3 + 5 : n // 3 + 9]), np.uint8)
    for n in SEAM_LENGTHS_B5:
        s = rng.choice(ALPHABET_N, size=n)
        inp[f"seam/base5/{n}"] = s
        inp[f"seam/base5/{n}/query5"] = np.frombuffer(_upper_t(s[n // 2 : n // 2 + 5]), np.uint8)
        inp[f"seam/base5/{n}/query"] = np.frombuffer(b"ACNT" + _upper_t(s[n // 4 : n // 4 + 3]), np.uint8)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups, run at once: {group: (inputs, [each rank's results])}."""
    inp = _inputs()
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    started = {}
    for group, (world, shards) in GROUPS.items():
        d = tmp_path_factory.mktemp(group)
        np.savez(d / "inputs.npz", **inp)
        coord = f"localhost:{_free_port()}"
        started[group] = (d, [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(shards), coord,
                                                str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                               text=True) for r in range(world)])
    out = {}
    for group, (d, procs) in started.items():
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"{group} rank {r} failed rc={p.returncode}:\n{err[-3000:]}"
        out[group] = (inp, [dict(np.load(d / f"r{r}.npz")) for r in range(len(procs))])
    return out


_REF: dict = {}


def _ref_mesh(name: str):
    shape = {"data4": (4, 1), "mesh22": (2, 2), "seq4": (1, 4)}[name]
    return ref_parallel.make_mesh(*shape, devices=jax.devices()[:4])


def _reference(inp: dict, key: str):
    """The JAX package's result for a worker's key, on a 4-device mesh of the
    same shape (computed once)."""
    if key in _REF:
        return _REF[key]
    mesh_name, form = key.split("/")
    m = _ref_mesh(mesh_name)
    j = jnp.asarray
    dp = ref_parallel.data_parallel
    n = LONG_NT
    calls = {
        "encode": lambda: dp.data_parallel_encode(j(inp["batch2"]), mesh=m, tier="xla"),
        "encode_gather": lambda: dp.data_parallel_encode(j(inp["batch2"]), mesh=m, tier="xla", gather=True),
        "encode_b5": lambda: dp.data_parallel_encode(j(inp["batch5"]), mesh=m, codec="base5", tier="xla"),
        "encode_b5_gather": lambda: dp.data_parallel_encode(j(inp["batch5"]), mesh=m, codec="base5", tier="xla",
                                                            gather=True),
        "encode_mxu": lambda: dp.data_parallel_encode(j(inp["batch2"]), mesh=m, tier="xla", gather=True),
        "decode": lambda: dp.data_parallel_decode(j(inp["words2"]), mesh=m, tier="xla"),
        "decode_gather": lambda: dp.data_parallel_decode(j(inp["words2"]), mesh=m, tier="xla", gather=True),
        "decode_b5": lambda: dp.data_parallel_decode(j(inp["words5"]), mesh=m, codec="base5", tier="xla"),
        "decode_b5_gather": lambda: dp.data_parallel_decode(j(inp["words5"]), mesh=m, codec="base5", tier="xla",
                                                            gather=True),
        "encode_checked": lambda: dp.data_parallel_encode_checked(j(inp["bad2"]), mesh=m, tier="xla"),
        "encode_checked_gather": lambda: dp.data_parallel_encode_checked(j(inp["bad2"]), mesh=m, tier="xla",
                                                                         gather=True),
        "encode_checked_b5": lambda: dp.data_parallel_encode_checked(j(inp["bad5"]), mesh=m, codec="base5",
                                                                     tier="xla"),
        "decode_checked": lambda: dp.data_parallel_decode_checked(j(inp["corrupt5"]), mesh=m, tier="xla"),
        "kmer_spectrum": lambda: ref_parallel.kmer_spectrum(j(inp["words2"]), j(inp["lens2"]), 6, mesh=m),
        "kmer_spectrum_canonical": lambda: ref_parallel.kmer_spectrum(j(inp["words2"]), j(inp["lens2"]), 6, mesh=m,
                                                                      canonical=True),
        "match_counts": lambda: ref_parallel.match_counts(j(inp["words2"]), j(inp["lens2"]), b"GANA", mesh=m),
        "match_counts_b5": lambda: ref_parallel.match_counts(j(inp["words5"]), j(inp["lens5"]), b"A?N", mesh=m,
                                                             codec="base5"),
        "sketch_sharded": lambda: ref_parallel.sketch_sharded(j(inp["words2"]), j(inp["lens2"]), 21, 16, mesh=m),
        "sketch_sharded_k9": lambda: ref_parallel.sketch_sharded(j(inp["words2"]), j(inp["lens2"]), 9, 16, mesh=m,
                                                                 canonical=False),
        "edit_distances": lambda: ref_parallel.edit_distances(inp["qw"], 40, inp["tw"], 70, mesh=m),
        "edit_distances_b5": lambda: ref_parallel.edit_distances(inp["qw5"], 40, inp["tw5"], 70, mesh=m,
                                                                 codec="base5"),
        "encode_long_2bit": lambda: ref_longseq.encode_long_2bit(inp["long2"], mesh=m),
        "encode_long_b5": lambda: ref_longseq.encode_long_b5(inp["long5"], mesh=m),
        "decode_long_2bit": lambda: ref_longseq.decode_long_2bit(inp["bits2"], n, mesh=m),
        "decode_long_b5": lambda: ref_longseq.decode_long_b5(inp["bits5"], n, mesh=m),
        "match_long": lambda: ref_longseq.match_long(inp["bits2"], n, Q2, mesh=m),
        "match_long_b5": lambda: ref_longseq.match_long_b5(inp["bits5"], n, Q5, mesh=m),
        "best_match_long": lambda: np.array(ref_longseq.best_match_long(inp["bits2"], n, BEST2, mesh=m)),
        "best_match_long_b5": lambda: np.array(ref_longseq.best_match_long_b5(inp["bits5"], n, BEST5, mesh=m)),
    }
    got = calls[form]()
    _REF[key] = tuple(np.asarray(g) for g in got) if isinstance(got, tuple) else np.asarray(got)
    return _REF[key]


def _same(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape, want.dtype, want.shape)
    assert np.array_equal(got, want)


def _own_shards(res: dict, key: str, want: np.ndarray, D: int, rows=None) -> None:
    """A rank's own shards, each against its block of the whole array, and
    ``np.asarray`` of the array raising."""
    pos, shards = res[key + ".pos"], res[key + ".shards"]
    b = want.shape[0] // D
    assert len(pos) and len(pos) == len(shards) < D
    for i, s in zip(pos.tolist(), shards):
        block = want[i * b : (i + 1) * b]
        keep = slice(None) if rows is None else rows[i * b : (i + 1) * b]
        _same(s[keep], block[keep])
    assert "spans other ranks" in str(res[key + ".raises"])


REPLICATED = ("data4/encode_gather", "mesh22/encode_gather", "data4/encode_b5_gather", "data4/encode_mxu",
              "data4/decode_gather", "data4/decode_b5_gather", "data4/kmer_spectrum", "mesh22/kmer_spectrum",
              "data4/kmer_spectrum_canonical", "data4/match_counts", "mesh22/match_counts", "data4/match_counts_b5",
              "data4/sketch_sharded", "data4/sketch_sharded_k9", "data4/edit_distances", "data4/edit_distances_b5")
SHARDED = ("data4/encode", "mesh22/encode", "data4/encode_b5", "data4/decode", "data4/decode_b5")
LONG = tuple(f"seq4/{f}" for f in ("encode_long_2bit", "encode_long_b5", "decode_long_2bit", "decode_long_b5",
                                    "match_long", "match_long_b5", "best_match_long", "best_match_long_b5")) + (
    "mesh22/encode_long_2bit", "mesh22/match_long", "mesh22/match_long_b5")


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("key", REPLICATED)
def test_replicated_results_on_every_rank(runs, group, key):
    inp, ranks = runs[group]
    want = _reference(inp, key)
    for res in ranks:
        _same(res[key], want)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("key", SHARDED)
def test_each_rank_holds_its_own_shards(runs, group, key):
    inp, ranks = runs[group]
    want = _reference(inp, key)
    D = 2 if key.startswith("mesh22") else 4
    seen = set()
    for res in ranks:
        _own_shards(res, key, want, D)
        seen |= set(res[key + ".pos"].tolist())
    assert seen == set(range(D))


@pytest.mark.parametrize("group", GROUPS)
def test_checked_forms(runs, group):
    """Both checked forms and their flags (one psum over the group): the
    words, sharded and gathered, against the reference's; the flags on every
    rank; the decoded rows but the corrupt one (a corrupt word decodes per
    the native oracle, ROADMAP §3)."""
    inp, ranks = runs[group]
    words, flag = _reference(inp, "data4/encode_checked")
    gwords, gflag = _reference(inp, "data4/encode_checked_gather")
    words5, flag5 = _reference(inp, "data4/encode_checked_b5")
    dec, dflag = _reference(inp, "data4/decode_checked")
    assert (int(flag), int(gflag), int(flag5), int(dflag)) == (1, 1, 2, 1)
    keep = np.arange(16) != 9
    for res in ranks:
        _own_shards(res, "data4/encode_checked", words, 4)
        _same(res["data4/encode_checked_gather"], gwords)
        _own_shards(res, "data4/encode_checked_b5", words5, 4)
        for name in ("decode_checked", "decode_checked_cuda"):
            _own_shards(res, f"data4/{name}", dec, 4, rows=keep)
            _same(res[f"data4/{name}.flag"], dflag)
        _same(res["data4/encode_checked.flag"], flag)
        _same(res["data4/encode_checked_gather.flag"], gflag)
        _same(res["data4/encode_checked_b5.flag"], flag5)


@pytest.mark.parametrize("group", GROUPS)
def test_sharded_codec_over_the_process_mesh(runs, group):
    """``ShardedCodec(mesh=)``: ``shard`` places each rank's own rows, the
    encode takes them as they lie, the gathered decode and the checked base-5
    forms against the reference's."""
    inp, ranks = runs[group]
    words = _reference(inp, "data4/encode")
    words5, flag5 = _reference(inp, "data4/encode_checked_b5")
    dec, dflag = _reference(inp, "data4/decode_checked")
    for res in ranks:
        _own_shards(res, "data4/codec_shard", inp["batch2"], 4)
        _own_shards(res, "data4/codec_encode", words, 4)
        _same(res["data4/codec_decode_gather"], np.frombuffer(_upper_t(inp["batch2"]), np.uint8).reshape(16, 128))
        _same(res["data4/codec_encode_checked_b5"], words5)
        _same(res["data4/codec_encode_checked_b5.flag"], flag5)
        _own_shards(res, "data4/codec_decode_checked_b5", dec, 4, rows=np.arange(16) != 9)
        _same(res["data4/codec_decode_checked_b5.flag"], dflag)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("key", LONG)
def test_long_sequence_mode(runs, group, key):
    """Every function of the long-sequence mode returns the reference's host
    result on every rank, seq = 4 across the ranks (and 2 seq shards
    replicated over 2 data rows); hits planted across every seam."""
    inp, ranks = runs[group]
    want = _reference(inp, key)
    for res in ranks:
        _same(res[key], want)
    if "match_long" in key and "best" not in key:
        assert len(want) >= 3


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("codec,n", [("2bit", n) for n in SEAM_LENGTHS_2BIT] + [("base5", n) for n in SEAM_LENGTHS_B5])
def test_long_sequence_mode_at_the_seams(runs, group, codec, n):
    """Lengths at the word seams times the shard count and below one word a
    shard, on 4 seq shards across the ranks: the oracle's words and bytes,
    the one-stream search's positions, the DP oracle's best match."""
    inp, ranks = runs[group]
    key = f"seam/{codec}/{n}"
    s = inp[key]
    b5 = codec == "base5"
    bits = (oracle.n_to_bits2_lut if b5 else oracle.n_to_bits_lut)(s)
    w32 = torch.from_numpy(spec.u64_to_u32_pairs(bits).reshape(-1))
    if b5:
        queries = (b"N", b"A?C", bytes(inp[key + "/query5"]))
        wants = [port_search.match_positions_b5(w32, n, q) for q in queries]
        best = port_align.best_match_reference_b5(bytes(inp[key + "/query"]), bytes(s))
    else:
        queries = (b"G", b"GNA", b"ACGTNACGTNACGTNACGTNACGTNACGTNACG"[: min(n, 33)])
        wants = [port_search.match_positions(w32, n, q) for q in queries]
        best = port_align.best_match_reference(bytes(inp[key + "/query"]), bytes(s))
    for res in ranks:
        _same(res[key + "/encode"], bits)
        _same(res[key + "/decode"], (oracle.bits_to_n2_lut if b5 else oracle.bits_to_n_lut)(bits, n))
        for i, want in enumerate(wants):
            _same(res[key + f"/match{i}"], want)
        assert tuple(res[key + "/best"].tolist()) == best


@pytest.mark.parametrize("group", GROUPS)
def test_default_mesh_spans_the_group(runs, group):
    """``default_mesh()`` in a group: one device a rank, in rank order, its
    size ``initialize``'s ``global_devices``; the indivisible batch keeps the
    port's ValueError; every form ran collectives over the group."""
    _, ranks = runs[group]
    world = GROUPS[group][0]
    for r, res in enumerate(ranks):
        info = json.loads(str(res["info"]))
        assert info == {"process_index": r, "process_count": world, "local_devices": 1, "global_devices": world}
        assert int(res["default_size"]) == world and res["default_ranks"].tolist() == list(range(world))
        assert str(res["indivisible"]) == "batch of 6 rows does not divide over the data axis of size 4"
        assert int(res["collectives"]) > 0
