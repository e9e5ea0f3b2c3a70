"""On-card gate of the PyTorch/CUDA port (cute_nucleotides_tpu_torch).

Builds the CUDA kernels from ``cute_nucleotides_tpu_torch/csrc``, holds each
against its plain PyTorch version bit for bit on the card, then drives the
main paths of both codecs at full size through the entry points a user
calls:

  2. each kernel vs its plain version at ragged shapes, all 256 bytes and
     (base-5 decode) all 128 triplet values with and without bit 63; the
     pext encode (#4) also at its thread and block edges (``PEXT_EDGES``);
  3. ``TwoBitCodec(device="cuda")`` on a resident u8[4096, 262144] batch
     (1 Gnt): every encode variant, ``encode_checked`` and ``decode``;
     ``Base5Codec(device="cuda")`` on u8[4096, 262143] (1.07 Gnt):
     ``encode``, ``encode_checked``, ``decode``, ``decode_checked``;
  4. ``api.n_to_bits``/``bits_to_n`` and ``n_to_bits2``/``bits_to_n2``
     (tier "auto") on one 248,956,422-nt sequence, and the 13 compat names
     on 1 Mnt;
  5. the CLI: FASTQ of 200,000 x 150 nt -> ``encode --batch 8192
     --validate`` -> ``decode --batch 8192`` -> FASTA, for ``--codec 2bit``
     and for ``--codec base5`` (decode with ``--verify-stream``, and a
     corrupted copy refused);
  6. launch counts of phases 3-5, read per path (each codec's path, the
     search path, the k-mer path, the sketch path, the seqops, sort, planar
     and align paths run with the counts set to 0 just before them), then
     each kernel's time beside its plain version's (CUDA events);
  7. the port's bench, ``python -m cute_nucleotides_tpu_torch bench``, in a
     child process at ``BENCH_SCALE=8 BENCH_FULL=1``: exit 0, its last line
     shaped as the reference's with ``edit_distance_gcups`` above 0, its 52
     rows above 0 (the three stream rows among them), and its planar rows'
     launches of #15-#17 and its Myers rows' of #19 read from its detail
     file;
  8. the stream path (run after the planar path, before the timing of
     phase 6), with its own launch counts: #1, #2, #3, #5 and #6 must each
     launch on it;
  9. the parallel layer (run after phase 8, before the timing of phase 6),
     with its own launch counts, taken from the layer's own calls alone (the
     one-device calls its checks compare against and its timing loops count
     nothing): #1-#6, #8-#10, #12, #13 and #19 must each launch on it, in
     this process and in each of the two rank processes.

The parallel layer (``parallel/mesh.py``, ``data_parallel.py``,
``longseq.py`` and ``runtime.initialize``), every result against the
one-device call on the same input, bit for bit: ``data_parallel_encode`` /
``_decode`` and their checked forms (and the ``mxu`` variant) on phase 3's
resident batches, on the default mesh (one card) and on 4 logical shards
of cuda:0 (``make_mesh(4, 1, devices=[cuda:0] * 4)``), gathered and not,
against ``TwoBitCodec``/``Base5Codec``; the one-card encode timed beside
``TwoBitCodec.encode`` (within 2%: no copy); ``kmer_spectrum`` (k = 8),
``sketch_sharded`` (k = 21), ``match_counts`` and ``edit_distances`` (the
align batch) on 4 shards; ``encode_long_*``/``decode_long_*`` on a
248,956,422-nt sequence with seq = 1 and 4 against ``api.n_to_bits`` /
``n_to_bits2``, and ``match_long(_b5)`` with hits planted across every
seam against ``search.match_positions(_b5)`` on the whole stream;
``best_match_long`` on one 2,200,000,007-nt 2-bit stream (550 MB of random
words from the seed, past 2^31, which ``best_match_stream`` refuses) on 2
seq shards, a 32-nt query planted with one substitution across the seam
and past 2^31 and another only past 2^31, each (1, the planted end) and the
host Myers agreeing on its window; and a two-rank ``StreamingEncoder`` run
on cuda:0 (two processes joined by ``runtime.initialize``, 10,000 x 150-nt
reads), each rank's residue class, the union against the host oracle.
The same two ranks, a gloo group on cuda:0 (NCCL takes one rank a card),
then run every form on their process mesh -- data = 2 (``default_mesh()``)
and seq = 2, one entry a rank -- with the whole input: the codec forms
(sharded and gathered, both codecs, the checked forms, ``ShardedCodec``) on
phase 3's batch shapes, the analyses, and the long-sequence mode at chr1
length, each rank's own shard or whole result against its own one-device
call, bit for bit, each timed beside it; each rank's own launches of #1-#6,
#8-#10, #12, #13 and #19 must be above 0, and its collectives are counted
by backend.  A one-rank NCCL group in this process runs
``data_parallel_encode(gather=True)``, ``kmer_spectrum`` and
``best_match_long`` over its process mesh and is destroyed before phase 6
times anything.  Each step's seconds and the SM clock are printed.

The stream path (``parallel/runtime.py``: ``StreamingEncoder`` and
``StreamingDecoder`` on the card, pinned copies on their own upload and
download streams): 1,000,000 x 150-nt reads (an Illumina-style run, about
300 MiB of FASTQ in the work directory) through ``fastq_batches`` ->
``StreamingEncoder(validate=True).run_batches`` in batches of 8192, for
``codec="2bit"`` and for ``"base5"`` on ACGTN reads: every sunk batch
against a ``tier="torch"`` encode of its reads on the card, the first and
last batch row by row against the host oracle, every kept array unchanged
after the run; then ``StreamingDecoder`` on the sunk words (base-5 with
``verify=True``) against the upper-case, U->T source.  The faults: a
planted ``@`` in batch 3 raises the reference's message and nothing from
batch 3 on is sunk; bit 63 in one base-5 entry raises ``corrupt base-5 word
0 in record ...``; a sink that raises on its fourth batch, then a resume
from the manifest, deliver every record index exactly once, each sunk batch
against the torch tier.  The long-read shape of the reference bench (32,768
x 2,048 nt, batches of 4096): the bench's unchecked encoder (#1), every
batch against the torch tier and the first and last against the oracle;
one encode run under ``torch.profiler`` in a fresh process (device ms;
:func:`profile_stream_encode`, run as ``chip_smoke.py
--profile-stream-encode FASTQ``), then the
bench's three stream rows (``bench.run_stream_rows``: median of 3, the
stage seconds, the same-run pinned H2D rate), with the SM clock beside them.

The align path (kernel #19, the Myers bit-vector scan, the base-5 Peq build
beside it, and the ``approx`` command; its data from its own seed): phase 2
holds the Peq build against its plain version on the query lengths' block
and word seams, corrupt triplets and random words at 1, 2, 3 and 9 blocks,
on contiguous, row-sliced, stride-0 and unaligned words, and phase 3 at the
adapter scan's 1,048,576 queries of 4 u32; phase 2 holds #19 against its plain
version in both alphabets and every mode (global, semiglobal, prefix and,
2-bit, every end within a threshold) on 37 pairs at m in {1, 2, 31, 32, 33,
63, 64, 65, 150, 300} against ragged 0..700-nt texts, with N / ? wildcards,
base-5 triplets 125..127 in texts and queries, max_errors 0, 2 and
INT32_MAX, a stride-0 Peq, and stream rows whose halo spans several rows;
phase 3 runs ``edit_distance_packed`` and ``best_match_packed`` at the
bench's shape (8192 pairs of 128 x 2048 nt) against the host Myers scan
(``native.edit_distance`` / ``native.best_match``) on every pair, and
``best_match_packed_b5`` and ``edit_distance_packed_b5`` at the adapter
scan's shape (1,048,576 pairs of 20..54 x 150 nt, one Peq build and one #19
launch a call) against the same on 4096 rows; phase 4
runs ``best_match_stream`` on the chr1-length 2-bit stream with a 21-nt
query (a substring with 2 edits) against ``native.best_match`` on the
decoded stream, and ``best_match_stream_b5`` on the same sequence encoded
base-5, which must agree; phase 5 runs ``approx`` on the 200,000 phase-5
reads of each codec with PRIMER planted with 0-2 edits in every tenth
(``--both``, ``--both --max-errors 2``, ``--both --cigar``, and ``--all
--max-errors 1``, which base-5 refuses), against ``native.best_match`` per
record and strand (2-bit), the DP oracle on a sample (base-5), a numpy DP
of every end (``--all``), and each CIGAR applied to its window.  The timing
phase takes #19 at the bench's shape beside its bound, and beside its plain
version at a phase-2 size (the plain version would take hundreds of
thousands of launches at the bench's), and the Peq build at the adapter
scan's shape.

The planar path (kernels #15-#17, the base-5 codec's planar (lo, hi)
layout): phase 2 holds #15 against its plain version at 1, 2, 37 and 128
rows of 3456 nt and on all 256 byte values, and #16 (padded and compact)
and #17 on random words and every triplet value in every slot with and
without bit 63, also against #6 on the interleaved words; phase 3 runs the
base-5 batch viewed as u8[310688, 3456] through ``encode_b5_planar`` (its
planes reinterleaved against the batch's words) and back through both
decodes (the padded one de-padded on the host by ``depad_nt4_host``),
against the batch's bytes.

The search path: phase 2 holds both search kernels against their plain
versions at the word seams, with wildcards, planted hits, a poly-A query
on a poly-A stream, a query over 8192 nt, all-N queries, a 4800-nt query
anchored past the lookahead #8 stages and word counts off its 8-word run
(2-bit), and every triplet value with and without bit 63 (base-5); phase
3 runs ``search.match_bits`` / ``match_count`` and their ``_b5`` twins on
the flattened 1-Gnt and 1.07-Gnt batches (7 nt, 45 nt with wildcards, a
planted 20-nt primer);
phase 5 runs ``grep --both`` on one chr1-length record of each codec with a
45-nt query planted on both strands, and ``grep --count --both --batch
8192`` on the 200,000-read files, each against a numpy scan of the bytes.

The k-mer path (the ``stats`` command): phase 2 holds kernels #10 and #11
against their plain versions at every k (1..15, 16..31) and W in {1, 511,
512, 513}, and #13 on all-zero, all-65535, one repeated, masked, random and
out-of-range codes; phase 3 runs ``kmer_histogram_batch(k=8,
canonical=True)`` on the 1-Gnt batch's words u32[4096, 16384]; phase 4
runs ``kmer_histogram(k=8)``, ``kmer_counts(k=15)`` and ``kmer_counts(k=21,
canonical=True)`` on a chr1-length stream, each against the same function
built from the plain versions; phase 5 runs ``stats`` on a chr1-length
FASTA (``-k 8 --canonical --top 10``), a 5,000-read ``.nup`` (``-k 8``)
and a 4-Mnt record (``-k 21 --canonical --top 10``), each stdout against a
numpy count of the bytes.

The sketch path (MinHash sketches, minimizers, the ``sketch`` command):
phase 2 holds #12 against its plain version at every k in 16..31, canonical
and forward, W in {1, 511, 512, 513, 3000} as one stream and as 37-word
read rows, ``n_valid`` at word and row seams, with a planted k-mer whose
hash is 0xFFFFFFFF, and #14 at k in {1, 7, 15}, w in {2, 3, 8, 9, 10, 16,
17, 33, 64, 1024, 1025, 2049 - k} on 16389-, 32768- and 100,003-nt random
and poly-A streams; phase 4 runs
``bottom_k_sketch(k=21, s=1000)``, ``frac_sketch(k=21, scale=1000)``,
``minimizers(k=15, w=10)``, ``minimizer_bits`` and ``kmer_hashes_planar``
on the chr1-length stream against their plain-built twins; phase 5 runs
``sketch`` on the 200,000 reads against a copy with 1% substitutions and
some N (bottom-s, then ``--scale 200``), each stdout against a numpy sketch
of the bytes, and on the chr1-length FASTA with ``--batch 1`` against
``bottom_k_sketch`` of its words.

The seqops path (kernel #7 and the ``region``, ``translate`` and ``dedup``
commands): phase 2 holds #7 against its plain version at 1, 2, 127, 128,
129 and 1001 random words and on every triplet value in every slot with and
without bit 63; phase 3 runs ``seqops.gc_content_packed_b5`` on the base-5
batch's words flattened (kernel #7's route) and phase 4 on a chr1-length
base-5 stream, each against a count of C and G bytes made on the card;
phase 5 runs ``region`` (FASTA and ``--packed``) on a chr1-length record of
each codec with windows at word seams and one over 1 Mnt, ``translate
--frames all`` on a 4-Mnt record of each codec and ``dedup`` on the
200,000 reads of each codec with one record in ten planted as a duplicate,
each output against numpy on the bytes.

The sort path (kernel #18, a radix sort): phase 2 holds it against its
plain version and ``prefer="lax"`` at 4096, 4097, 4133, 16383, 37 * 4096 +
5, 2^20 + 1, 2^22 + 3 and 2^23 pairs (random, all equal, descending, ties
on hi, keys straddling the sign bit, k-mer keys with and without
sentinels); phase 4 runs ``sort.sort_pairs(hi, lo, prefer="bitonic")``
on the chr1-length stream's k = 21 canonical k-mer pairs (the keys
``kmer_counts`` sorts) against ``prefer="lax"``.

Phases 4 and 5 run their calls under ``torch.profiler`` (CUDA activity) and
print the device time of the port's kernels, of copies and of other device
work beside each call's wall time; the chr1 sketch calls are profiled in a
fresh process (``python3 chip_smoke.py --profile-sketch-chr1``), since a
long process loses their device events.  The script imports only the port,
torch and numpy; the host oracle it checks against is the port's own
(``ops/native.py``, through the api's ``oracle`` tier).

The line before the last lists every kernel with its launches on its path,
its largest difference from its plain version, its time (CUDA events) beside
the plain version's and, for the histogram and the sort, ``torch.bincount``'s
and ``torch.sort``'s, and its
bound: the least time the card could take, the larger of the bytes it must
move at 3.35 TB/s and the integer instructions its data needs at the
card's issue rate.  Phase 1 prints the SASS instruction mix of the sketch,
GC, radix sort, both search kernels and the pext encode (#4), with their
registers, stack, shared and local bytes (``cuobjdump``), the check on
those counts.

All data comes from seeds.  Exits non-zero, without the final line, on any
failure or without CUDA.  Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# the card's peaks and the bound rule, shared with the port's bench
from cute_nucleotides_tpu_torch.utils.profiling import HBM_BYTES_PER_S, bound as _bound, myers_ops

SEED = 0x5EED
ALPHABET = b"ACGTUacgtu"
ALPHABET_N = b"ACGTUNacgtun"
INVALID = (ord("N"), ord("X"), 0, 0x80, 0xFF, ord("B"), ord("n"), ord("@"))
BATCH_ROWS, BATCH_NT = 4096, 262144  # 1 Gnt, 1 GiB in, 256 MiB of words out
B5_NT = 27 * 9709  # 262143: u8[4096, 262143] is 1.07 Gnt in, 318 MB of words out
CHR1_NT = 248_956_422  # GRCh38 chr1
MNT = 1 << 20
MNT_B5 = MNT // 27 * 27  # the whole words of 1 Mnt
CLI_READS, CLI_READ_NT, CLI_BATCH = 200_000, 150, 8192
RAGGED = (1, 15, 16, 17, 31, 32, 33)
RAGGED_B5 = (1, 26, 27, 28, 53, 54, 55)  # nt, through the api
B5_WORDS = (1, 2, 127, 128, 129)  # words, straight into the kernels
SEARCH_NT = (1, 15, 16, 17, 31, 32, 33, 5000, 100_003)  # 2-bit stream lengths, nt
#: base-5 stream lengths, nt: ragged short streams, 1-5 words, and word counts
#: at and beside #9's block span (512 words, 4 a thread) and two spans
SEARCH_NT_B5 = (1, 15, 16, 17, 26, 27, 28, 31, 32, 33, 54, 81, 27 * 4, 27 * 5, 27 * 127, 27 * 128, 27 * 129,
                27 * 129 + 13, 27 * 511, 27 * 512, 27 * 513 + 13, 27 * 1024 + 5)
SEARCH_M = (1, 7, 16, 17, 32, 33, 45, 141)  # query lengths, nt
LONG_QUERY, B5_MAX_QUERY = 8200, 1024
#: 2-bit stream word counts for #8's edges, none a multiple of its 8-word
#: run: a few words, and beside its block's 1024 words and two blocks
SEARCH_W2 = (3, 5, 9, 1021, 1025, 2053)
#: (rows, lanes) edges of #4 (2 groups of 16 nt a thread, 512 a block): odd
#: u32 totals (a last thread with 1 group), rows of 16 and 48 nt that split a
#: thread's groups, totals just past one, two and four blocks' span
PEXT_EDGES = ((1, 4), (2, 4), (3, 4), (3, 12), (7, 12), (64, 4), (1, 2052), (3, 684), (41, 100), (1, 4100),
              (1, 8204))
PRIMER = b"GTTCAGAGTTCTACAGTCCG"  # 20 nt
#: the align path: phase 2 of #19 holds ALIGN_PAIRS pairs at each query
#: length of ALIGN_M; phase 3 runs the bench's edit_distance_m128_n2048 shape
#: (ALIGN_B pairs of ALIGN_QM x ALIGN_TN nt); phase 4 a query of
#: ALIGN_STREAM_M nt over the chr1-length stream; phase 5 plants PRIMER in
#: every APPROX_EVERY-th read and holds base-5 lines to the DP oracle on
#: every APPROX_B5_EVERY-th record; ``--cigar`` runs on the first
#: APPROX_CIGAR_READS of them (its host tracebacks took 29 s on all 200,000).
#: ALIGN_M holds the block seams and
#: each edge of #19's lane forms at 37 pairs (1 block solo; 2, 4, 8, 16 and
#: 32 lanes of one block up to 64, 128, 256, 512 and 1024 nt; the scratch
#: form past that)
ALIGN_M = (1, 2, 20, 21, 31, 32, 33, 63, 64, 65, 128, 129, 256, 257, 512, 513, 1024, 1025)
ALIGN_PAIRS, ALIGN_B, ALIGN_QM, ALIGN_TN, ALIGN_STREAM_M = 37, 8192, 128, 2048, 21
#: pairs of phase 2's stride-0 runs at the long lane forms' edges
MYERS_LONG_PAIRS = 8
APPROX_EVERY, APPROX_B5_EVERY, APPROX_CIGAR_READS = 10, 997, 25_000
#: phase 2's rows of the approx CLI's shape: reads of APPROX_NT nt in rows of
#: 16 u32 (2-bit) or 6 u32 pairs (base-5), PRIMER's 20 nt as one broadcast Peq
APPROX_ROWS, APPROX_NT = 4096, 150
#: rows of the chr1-length stream held to #19's plain version at each end
STREAM_CHECK_ROWS = 256
_PK = "cute_nucleotides_tpu/ops/pallas_kernels.py"
REPLACES = {
    "encode_2bit_nt4": f"{_PK}:216",
    "decode_2bit_nt4": f"{_PK}:233",
    "encode_2bit_nt4_checked": f"{_PK}:301",
    "encode_2bit_nt4_mxu": f"{_PK}:819",
    "encode_b5_stream": f"{_PK}:1067",
    "decode_b5_stream": f"{_PK}:1423",
    "match_bits_stream": "cute_nucleotides_tpu/ops/search.py:263",
    "match_b5_bits_stream": f"{_PK}:1986",
    "kmer_codes_planar": "cute_nucleotides_tpu/ops/kmer.py:225",
    "kmer_codes_planar_pair": "cute_nucleotides_tpu/ops/kmer.py:295",
    "hist_codes": "cute_nucleotides_tpu/ops/kmer.py:502",
    "kmer_hashes_planar_pair": "cute_nucleotides_tpu/ops/kmer.py:438",
    "minimizer_bits_stream": f"{_PK}:1714",
    "gc_b5_stream": f"{_PK}:1496",
    "sort_pairs_bitonic": "cute_nucleotides_tpu/ops/sort.py:158",
    "encode_b5_planar": f"{_PK}:898",
    "decode_b5_nt4_panels": f"{_PK}:2087",
    "decode_b5_panels": f"{_PK}:607",
    # not a Pallas kernel: the lax.scan Myers scans (2-bit :336, base-5 :385)
    "myers_scan": "cute_nucleotides_tpu/ops/align.py:336",
    # not a Pallas kernel: the jnp base-5 Peq build (digits :573, one-hot sum :605)
    "peq_b5": "cute_nucleotides_tpu/ops/align.py:573",
}
#: what a kernel line's "replaces" points at, where it is no Pallas kernel
NOT_PALLAS = {"myers_scan": "lax.scan word scans _myers_scan_words (align.py:336) and _myers_scan_words_b5 "
                            "(align.py:385), not Pallas kernels",
              "peq_b5": "jnp Peq build _unpack_digits_b5_t (align.py:573) and _peq_from_codes (align.py:605), "
                        "not a Pallas kernel"}
B5_KERNELS = ("encode_b5_stream", "decode_b5_stream", "match_b5_bits_stream")
PLANAR_KERNELS = ("encode_b5_planar", "decode_b5_nt4_panels", "decode_b5_panels")
SEARCH_KERNELS = ("match_bits_stream", "match_b5_bits_stream")
KMER_KERNELS = ("kmer_codes_planar", "kmer_codes_planar_pair", "hist_codes")
SKETCH_KERNELS = ("kmer_hashes_planar_pair", "minimizer_bits_stream")
SEQOPS_KERNELS = ("gc_b5_stream",)
SORT_KERNELS = ("sort_pairs_bitonic",)
ALIGN_KERNELS = ("myers_scan", "peq_b5")
#: (kernels, source file, path) in the order a kernel's first group wins
_GROUPS = ((PLANAR_KERNELS, "codec_b5.cu", "planar"), (SORT_KERNELS, "sort.cu", "sort"),
           (ALIGN_KERNELS, "align.cu", "align"),
           (SEQOPS_KERNELS, "seqops.cu", "seqops"),
           (SKETCH_KERNELS, "sketch.cu", "sketch"), (KMER_KERNELS, "kmer.cu", "k-mer"),
           (SEARCH_KERNELS, "search.cu", "search"), (B5_KERNELS, "codec_b5.cu", "base-5"))
_CSRC = "cute_nucleotides_tpu_torch/csrc"
SOURCES = {k: f"{_CSRC}/" + next((src for ks, src, _ in _GROUPS if k in ks), "codec2bit.cu") for k in REPLACES}
PATH_OF = {k: next((path for ks, _, path in _GROUPS if k in ks), "2-bit") for k in REPLACES}
GC_B5_WORDS = B5_WORDS + (1001,)  # phase-2 word counts of #7, one odd
#: phase-2 pair counts of #18: one tile of its passes (4096 keys), one tile +
#: 1, ragged, many tiles, and sizes past the look-back's first tiles
SORT_N = (4096, 4097, 4133, 16383, 37 * 4096 + 5, (1 << 20) + 1, (1 << 22) + 3, 1 << 23)
DEDUP_EVERY = 10  # one read in ten is planted as a duplicate of an earlier one
PLANAR_R = (1, 2, 37, 128)  # phase-2 rows of #15-#17
#: the bench child: scale, full table, its time limit, its rows, the keys of its last line
BENCH_ENV = {"BENCH_SCALE": "8", "BENCH_FULL": "1"}
BENCH_TIMEOUT_S, BENCH_ROWS = 600, 52
BENCH_LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "gbps_per_chip", "vs_device_memcpy",
                   "vs_reference_memcpy", "chips", "champions_gibs", "detail_file")
#: bench rows that run #15-#17, and the wrapper each must launch
BENCH_PLANAR_ROWS = {"encode_b5_cuda_planar": "encode_b5_planar", "decode_b5_cuda_nt4": "decode_b5_nt4_panels",
                     "decode_b5_cuda_nt4_padded": "decode_b5_nt4_panels", "decode_b5_cuda_u8": "decode_b5_panels"}
#: bench rows that run #19
BENCH_ALIGN_ROWS = {"edit_distance_m128_n2048": "myers_scan", "approx_stream_m21": "myers_scan"}
KMER_W = (1, 511, 512, 513)  # word lanes per row in phase 2; 37 rows, a multiple of no block
STATS_READS, STATS_REC_NT = 5_000, 4_000_000
MZ_NT = (16384 + 5, 32768, 100_003)  # stream lengths of the minimizer kernel's phase-2 cases, nt
#: its windows: powers of two and their neighbours move the doubling's last
#: offset; 2049 - k (the largest) is added per k
MZ_W = (2, 3, 8, 9, 10, 16, 17, 33, 64, 1024, 1025)
SKETCH_K, SKETCH_S, SKETCH_SCALE, SKETCH_CAP = 21, 1000, 1000, 1 << 19
SENTINEL = 0xFFFFFFFF
SORT_KERNEL_LAUNCHES = 9  # #18: the histogram kernel and eight radix passes per call
#: the stream path: an Illumina-style run of short reads in batches of 8192,
#: the reference bench's long-read shape (its 2048-nt reads and batch of 4096
#: are the bench's), and the fault checks' file of 6 batches
STREAM_SHORT_READS, STREAM_SHORT_NT, STREAM_BATCH = 1_000_000, 150, 8192
STREAM_LONG_READS, STREAM_FAULT_BATCHES = 32768, 6
#: the kernels the stream path must launch: 2-bit encode (#1 without and #3
#: with validate), 2-bit decode (#2), base-5 encode (#5) and decode (#6)
STREAM_KERNELS = ("encode_2bit_nt4", "decode_2bit_nt4", "encode_2bit_nt4_checked", "encode_b5_stream",
                  "decode_b5_stream")
#: phase 9, the parallel layer: logical shards of the data and seq axes on the
#: one card; one 2-bit stream past 2^31 nt (550 MB of words) for
#: best_match_long on 2 seq shards; the two-rank stream's reads
PAR_SHARDS, BIG_NT = 4, 2_200_000_007
RANK_READS, RANK_NT, RANK_BATCH = 10_000, 150, 1024
#: the kernels the parallel layer's path must launch: #1-#6, #8-#10, #12, #13, #19
PARALLEL_KERNELS = ("encode_2bit_nt4", "decode_2bit_nt4", "encode_2bit_nt4_checked", "encode_2bit_nt4_mxu",
                    "encode_b5_stream", "decode_b5_stream", "match_bits_stream", "match_b5_bits_stream",
                    "kmer_codes_planar", "kmer_hashes_planar_pair", "hist_codes", "myers_scan")


class SmokeFailure(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(line: str) -> None:
    print(line, flush=True)


def _i64(t):
    """Any integer tensor (uint32 through its int32 view) -> int64 values."""
    import torch

    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


class Errors:
    """Largest |kernel - plain| seen per kernel over every comparison."""

    def __init__(self):
        self.max = {name: 0 for name in REPLACES}
        self.count = 0

    def compare(self, name: str, got, want, what: str) -> None:
        import torch

        self.count += 1
        check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        if got.numel():
            err = int((_i64(got) - _i64(want)).abs().max())
            self.max[name] = max(self.max[name], err)
            check(err == 0, f"{what}: kernel differs from plain version (max abs err {err})")
        else:
            check(torch.equal(_i64(got), _i64(want)), what)


# --- phase 0 / 1 --------------------------------------------------------------

def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"phase 0 device: {name}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s); python {sys.version.split()[0]}")
    say(card)
    return name, card


def phase_build():
    from cute_nucleotides_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load()
    say(f"phase 1 build: nvcc {' '.join(_build.NVCC_FLAGS)} {os.path.relpath(_build.CSRC_DIR)}/*.cu; "
        f"build and load {time.perf_counter() - t0:.1f} s")
    _sass_mix(_build._nvcc(), lib._name, ("kmer_hashes_pair_kernel", "minimizer_kernel", "gc_b5_kernel",
                                          "radix_hist_kernel", "radix_pass_kernel", "match_b5_kernel",
                                          "match_2bit_kernel", "encode_2bit_pext_kernel", "myers_lanes",
                                          "myers_scratch", "myers_stream", "peq_b5_kernel"))


def _kernel_label(name: str, kernels):
    """``kernel<args>`` for a mangled function name holding one of
    ``kernels``, else None."""
    hit = next((k for k in kernels if k in name), None)
    # the template arguments from the mangled name: Lb1E is true, Li256E 256
    targs = re.search(f"{hit}I((?:L[a-z]+[0-9]+E)+)E", name) if hit else None
    args = ", ".join(("true" if v == "1" else "false") if t == "b" else v
                     for t, v in re.findall(r"L([a-z]+)([0-9]+)E", targs.group(1))) if targs else ""
    return (f"{hit}<{args}>" if args else hit) if hit else None


#: #19's template modes, as csrc/align.cu numbers them
MYERS_MODE_NAMES = ("global", "semiglobal", "prefix", "ends")


def _steady_loop(lines) -> tuple:
    """(instructions, LDS) of the smallest loop of a function's SASS that
    loads Eq (``LDS``): #19's word loop with no char test, from a backward
    branch to its target; (0, 0) when there is none."""
    at = []
    for line in lines:
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?);", line)
        if m and not m.group(2).strip().startswith("NOP"):
            at.append((int(m.group(1), 16), m.group(2)))
    best = (0, 0)
    for addr, text in at:
        target = re.search(r"BRA\b.*?0x([0-9a-f]+)", text)
        if target and int(target.group(1), 16) < addr:
            body = [t for a, t in at if int(target.group(1), 16) <= a <= addr]
            lds = sum(bool(re.search(r"\bLDS\b", t)) for t in body)
            if lds and (best == (0, 0) or len(body) < best[0]):
                best = (len(body), lds)
    return best


def _myers_floor_check(mixes: dict, loops: dict) -> None:
    """#19's lane forms, ``myers_lanes<BPL, MODE, B5, WAVE>``: the steady
    word loop (every char of every lane inside its row, no char test) runs
    its instructions over its chars a lane step, so a pair of L lanes runs
    L times that a nt; a floor (utils.profiling.myers_ops in the form's own
    mode at nb = L * BPL, the most blocks the form holds) above that would
    be no floor: fails if so, and if a form has no steady loop to read.
    Prints both for every L the plan can give the form, beside the whole
    function's static count over its chars (prologue, fill and drain
    included, so no bound on the loop)."""
    out = []
    for fn, mix in sorted(mixes.items()):
        m = re.fullmatch(r"myers_lanes<(\d+), (\d+), (true|false), (true|false)>", fn)
        if not m:
            continue
        bpl, mode, b5, wave = int(m.group(1)), MYERS_MODE_NAMES[int(m.group(2))], m.group(3) == "true", \
            m.group(4) == "true"
        unroll = 27 if b5 else 16
        whole = sum(mix.values()) / unroll
        body, lds = loops.get(fn, (0, 0))
        steady = body / (lds / bpl) if lds else float("nan")
        parts = []
        for lanes in ((2, 4, 8, 16, 32) if bpl == 1 else (2, 4, 8, 16)) if wave else (1,):
            floor = myers_ops(unroll, lanes * bpl, b5=b5, mode=mode) / unroll
            parts.append(f"L={lanes} steady {lanes * steady:.1f} vs {floor:.1f} (whole function {lanes * whole:.1f})")
            check(floor <= lanes * steady, f"{fn} at {lanes} lanes: floor {floor:.1f} instructions a nt above "
                                           f"its steady loop's {lanes * steady:.1f}")
        out.append(f"{fn} ({mode}{', base-5' if b5 else ''}, {bpl} block(s) a lane): {'; '.join(parts)}")
    if out:
        say("phase 1 SASS #19 floor check (a pair's instructions a nt: lanes x the steady word loop's count a "
            "lane step, vs the form's own mode's floor a nt at nb = lanes x blocks a lane, "
            "utils.profiling.myers_ops): " + " | ".join(out))


def _sass_mix(nvcc: str, path: str, kernels) -> None:
    """Print the SASS instruction count of each instance of ``kernels`` in the
    library at ``path`` (``cuobjdump -sass`` beside ``nvcc``, NOPs left out),
    with its opcodes by frequency, then its registers per thread and its
    static shared and local bytes (``cuobjdump -res-usage``); a missing
    cuobjdump is reported, not fatal."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    try:
        dump = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True, timeout=120)
        res = subprocess.run([cuobjdump, "-res-usage", path], capture_output=True, text=True, timeout=120)
    except OSError as e:
        say(f"phase 1 SASS: {cuobjdump} did not run ({e})")
        return
    if dump.returncode != 0:
        say(f"phase 1 SASS: cuobjdump exit {dump.returncode}: {dump.stderr.strip()[:300]}")
        return
    fn, mixes, lines = None, {}, {}
    for line in dump.stdout.splitlines():
        if "Function :" in line:
            fn = _kernel_label(line.split("Function :", 1)[1].strip(), kernels)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn and m and m.group(1) != "NOP":
            mixes.setdefault(fn, {}).setdefault(m.group(1), 0)
            mixes[fn][m.group(1)] += 1
            lines.setdefault(fn, []).append(line)
    for fn, mix in sorted(mixes.items()):
        top = sorted(mix.items(), key=lambda kv: -kv[1])
        say(f"phase 1 SASS {fn}: {sum(mix.values())} instructions: {dict(top)}")
    _myers_floor_check(mixes, {fn: _steady_loop(ls) for fn, ls in lines.items() if fn.startswith("myers_lanes")})
    for name, usage in re.findall(r"Function (\S+?):\s*(REG:[^\n]*)", res.stdout):
        fn = _kernel_label(name, kernels)
        if fn:
            u = dict(re.findall(r"(\w+):(\d+)", usage))
            say(f"phase 1 resources {fn}: {u.get('REG')} registers a thread, stack {u.get('STACK')} B, "
                f"static shared {u.get('SHARED')} B, local {u.get('LOCAL')} B")


# --- phase 2: each kernel vs its plain version ---------------------------------

def phase_kernels(errors: Errors, rng) -> None:
    import torch

    from cute_nucleotides_tpu_torch.ops import kernels as K

    alpha = np.frombuffer(ALPHABET, np.uint8)
    dev = "cuda"
    for lanes in RAGGED:
        for rows in (1, 3, 64):
            s = rng.choice(alpha, size=(rows, 4 * lanes))
            nt4 = torch.from_numpy(s).to(dev).view(torch.uint32)
            for v in ("mul", "shift", "interleave"):
                errors.compare("encode_2bit_nt4", K.encode_2bit_nt4(nt4, v),
                               K.encode_2bit_nt4_plain(nt4, v), f"encode[{v}] {rows}x{lanes}")
            p = torch.from_numpy(rng.integers(0, 256, (rows, lanes), dtype=np.uint8)).to(dev)
            for v in ("swar", "shuffle", "select"):
                errors.compare("decode_2bit_nt4", K.decode_2bit_nt4(p, v),
                               K.decode_2bit_nt4_plain(p, v), f"decode[{v}] {rows}x{lanes}")
            # checked and pext rows hold whole 16-nt groups: C = 4 * lanes
            s = rng.choice(alpha, size=(rows, 16 * lanes))
            bad_rows = sorted(rng.choice(rows, size=max(rows // 3, 1), replace=False).tolist())
            for r in bad_rows:
                s[r, rng.integers(0, s.shape[1])] = INVALID[r % len(INVALID)]
            nt4 = torch.from_numpy(s).to(dev).view(torch.uint32)
            for v in ("mul", "shift", "interleave"):
                out, flags = K.encode_2bit_nt4_checked(nt4, v)
                pout, pflags = K.encode_2bit_nt4_checked_plain(nt4, v)
                errors.compare("encode_2bit_nt4_checked", out, pout, f"checked[{v}] {rows}x{lanes}")
                errors.compare("encode_2bit_nt4_checked", flags, pflags, f"checked flags[{v}]")
                got_rows = torch.nonzero(flags.view(torch.int32)).flatten().tolist()
                check(got_rows == bad_rows, f"checked[{v}] flags rows {got_rows} != {bad_rows}")
            errors.compare("encode_2bit_nt4_mxu", K.encode_2bit_nt4_mxu(nt4),
                           K.encode_2bit_nt4_mxu_plain(nt4), f"mxu {rows}x{lanes}")
            words, flags = K.encode_2bit_nt4_mxu(nt4, checked=True)
            pwords, pflags = K.encode_2bit_nt4_mxu_plain(nt4, checked=True)
            errors.compare("encode_2bit_nt4_mxu", words, pwords, f"mxu checked {rows}x{lanes}")
            errors.compare("encode_2bit_nt4_mxu", flags, pflags, f"mxu checked flags {rows}x{lanes}")
            got_rows = torch.nonzero(flags.view(torch.int32)).flatten().tolist()
            check(got_rows == bad_rows, f"mxu checked flags rows {got_rows} != {bad_rows}")
    # every byte value at every position of a lane, for all four kernels
    s = np.full((8, 2048), ord("A"), np.uint8)
    for pos in range(4):
        s[pos % 8, pos * 256 : (pos + 1) * 256] = np.arange(256, dtype=np.uint8)
    s[5, 1024 : 1024 + 4 * 256 : 4] = np.arange(256, dtype=np.uint8)
    valid = np.frombuffer(ALPHABET, np.uint8)
    want_rows = [r for r in range(8) if np.any(~np.isin(s[r], valid))]
    nt4 = torch.from_numpy(s).to(dev).view(torch.uint32)
    for v in ("mul", "shift", "interleave"):
        errors.compare("encode_2bit_nt4", K.encode_2bit_nt4(nt4, v),
                       K.encode_2bit_nt4_plain(nt4, v), f"encode[{v}] all bytes")
        _, flags = K.encode_2bit_nt4_checked(nt4, v)
        got_rows = torch.nonzero(flags.view(torch.int32)).flatten().tolist()
        check(got_rows == want_rows, f"checked[{v}] all bytes: rows {got_rows} != {want_rows}")
    errors.compare("encode_2bit_nt4_mxu", K.encode_2bit_nt4_mxu(nt4),
                   K.encode_2bit_nt4_mxu_plain(nt4), "mxu all bytes")
    _, flags = K.encode_2bit_nt4_mxu(nt4, checked=True)
    got_rows = torch.nonzero(flags.view(torch.int32)).flatten().tolist()
    check(got_rows == want_rows, f"mxu checked all bytes: rows {got_rows} != {want_rows}")
    # #4's edges, a bad byte at the first nt of rows 0, 3, ... and at the last of rows 2, 5, ...
    for rows, lanes in PEXT_EDGES:
        s = rng.choice(alpha, size=(rows, 4 * lanes))
        s[::3, 0] = ord("N")
        s[2::3, -1] = 0xFF
        bad_rows = [r for r in range(rows) if r % 3 != 1]
        nt4 = torch.from_numpy(s).to(dev).view(torch.uint32)
        errors.compare("encode_2bit_nt4_mxu", K.encode_2bit_nt4_mxu(nt4),
                       K.encode_2bit_nt4_mxu_plain(nt4), f"mxu edge {rows}x{lanes}")
        words, flags = K.encode_2bit_nt4_mxu(nt4, checked=True)
        pwords, pflags = K.encode_2bit_nt4_mxu_plain(nt4, checked=True)
        errors.compare("encode_2bit_nt4_mxu", words, pwords, f"mxu checked edge {rows}x{lanes}")
        errors.compare("encode_2bit_nt4_mxu", flags, pflags, f"mxu checked flags edge {rows}x{lanes}")
        got_rows = torch.nonzero(flags.view(torch.int32)).flatten().tolist()
        check(got_rows == bad_rows, f"mxu checked edge {rows}x{lanes}: rows {got_rows} != {bad_rows}")
    p = torch.arange(256, dtype=torch.uint8, device=dev).view(2, 128)
    for v in ("swar", "shuffle", "select"):
        errors.compare("decode_2bit_nt4", K.decode_2bit_nt4(p, v),
                       K.decode_2bit_nt4_plain(p, v), f"decode[{v}] all bytes")
    # a misaligned view is refused, never copied
    x = torch.zeros(64, dtype=torch.uint8, device=dev)[4:20].view(torch.uint32).view(1, 4)
    try:
        K.encode_2bit_nt4(x)
    except ValueError:
        pass
    else:
        raise SmokeFailure("encode_2bit_nt4 took a view that is not 16-byte aligned")
    torch.cuda.synchronize()
    say(f"phase 2 kernels: {errors.count} comparisons bit-identical to the plain versions; "
        f"max abs err {errors.max}")


def _flag(f) -> int:
    import torch

    return int(f.view(torch.int32)[0])


def phase_kernels_b5(errors: Errors, rng) -> None:
    """The base-5 kernels, every mode, against their plain versions; the
    checked flags exact on every byte value and every triplet value."""
    import torch

    from cute_nucleotides_tpu_torch.ops import kernels as K

    dev = "cuda"
    enc, dec = "encode_b5_stream", "decode_b5_stream"
    alpha = np.frombuffer(ALPHABET_N, np.uint8)
    modes = ((False, False), (True, False), (False, True))  # chars, checked, digits
    for n in B5_WORDS:
        x = torch.from_numpy(rng.choice(alpha, size=27 * n)).to(dev)
        errors.compare(enc, K.encode_b5_stream(x), K.encode_b5_stream_plain(x), f"b5 encode {n} words")
        for inject in (False, True):
            if inject:
                x[int(rng.integers(0, x.numel()))] = ord("X")
            words, flag = K.encode_b5_stream(x, checked=True)
            pwords, pflag = K.encode_b5_stream_plain(x, checked=True)
            errors.compare(enc, words, pwords, f"b5 checked encode {n} words")
            errors.compare(enc, flag, pflag, f"b5 checked encode flag {n} words")
            check(_flag(flag) == int(inject), f"b5 checked encode {n} words: flag {_flag(flag)}")
        words = K.encode_b5_stream_plain(x)
        for corrupt in (False, True):
            if corrupt:  # bit 63 of the last word
                words.view(torch.int32)[-1] |= -(1 << 31)
            for checked, digits in modes:
                got = K.decode_b5_stream(words, checked, digits)
                want = K.decode_b5_stream_plain(words, checked, digits)
                what = f"b5 decode checked={checked} digits={digits} {n} words"
                if checked:
                    errors.compare(dec, got[0], want[0], what)
                    errors.compare(dec, got[1], want[1], what + " flag")
                    check(_flag(got[1]) == int(corrupt), f"{what}: flag {_flag(got[1])}")
                else:
                    errors.compare(dec, got, want, what)
    # every byte value at every position of a word, then the flag of each
    # byte value alone
    x = torch.arange(256, dtype=torch.uint8, device=dev).repeat_interleave(27)
    errors.compare(enc, K.encode_b5_stream(x), K.encode_b5_stream_plain(x), "b5 encode all bytes")
    valid = set(ALPHABET_N)
    for v in range(256):
        x = torch.full((27 * 3,), ord("A"), dtype=torch.uint8, device=dev)
        x[27 + v % 27] = v
        words, flag = K.encode_b5_stream(x, checked=True)
        errors.compare(enc, flag, K.encode_b5_stream_plain(x, checked=True)[1], f"b5 flag of byte {v}")
        check(_flag(flag) == int(v not in valid), f"b5 checked encode flag of byte {v}: {_flag(flag)}")
    # every triplet value in every slot, with and without bit 63; then each
    # value alone for the checked flag
    t = np.arange(128, dtype=np.uint64)
    w64 = np.concatenate([(t << np.uint64(7 * j)) | (np.uint64(b) << np.uint64(63))
                          for j in range(9) for b in (0, 1)])
    words = torch.from_numpy(w64.view(np.uint32).copy()).to(dev)
    for checked, digits in modes:
        got = K.decode_b5_stream(words, checked, digits)
        want = K.decode_b5_stream_plain(words, checked, digits)
        if checked:
            errors.compare(dec, got[0], want[0], "b5 decode all triplets")
            errors.compare(dec, got[1], want[1], "b5 decode all triplets flag")
        else:
            errors.compare(dec, got, want, f"b5 decode all triplets digits={digits}")
    for v in range(128):
        for b in (0, 1):
            j = v % 9
            w = np.array([0, (v << (7 * j)) | (b << 63), 0], dtype=np.uint64)
            _, flag = K.decode_b5_stream(torch.from_numpy(w.view(np.uint32).copy()).to(dev), checked=True)
            check(_flag(flag) == int(v >= 125 or b == 1),
                  f"b5 checked decode flag of triplet {v} bit63={b}: {_flag(flag)}")
    try:
        K.decode_b5_stream(words, checked=True, digits=True)
    except ValueError:
        pass
    else:
        raise SmokeFailure("decode_b5_stream took checked together with digits")
    x = torch.zeros(64, dtype=torch.uint8, device=dev)[4:31]
    try:
        K.encode_b5_stream(x)
    except ValueError:
        pass
    else:
        raise SmokeFailure("encode_b5_stream took a view that is not 16-byte aligned")
    torch.cuda.synchronize()
    say(f"phase 2 base-5 kernels: bit-identical to the plain versions at {B5_WORDS} words, all 256 "
        f"bytes and all 128 triplets; checked flags exact on each byte and each triplet +- bit 63 "
        f"({errors.count} comparisons in phase 2; max abs err {errors.max})")


def _planted(rng, n: int, alpha: bytes, m: int, wildcard: bytes):
    """A seeded n-nt stream over alpha and an m-nt query taken from it with
    every fifth byte a wildcard, planted at the last start, in the middle
    and at 0."""
    a = np.frombuffer(alpha, np.uint8)
    q = bytearray(rng.choice(a, m).tobytes())
    q[::5] = wildcard * len(q[::5])
    s = rng.choice(a, n)
    concrete = np.frombuffer(bytes(q).replace(wildcard, alpha[:1]), np.uint8)
    for p in (n - m, n // 2, 0):  # 0 last: its hit survives any overlap
        if 0 <= p <= n - m:
            s[p : p + m] = concrete
    return s, bytes(q)


def phase_kernels_search(errors: Errors, rng) -> None:
    """Both search kernels against their plain versions at the word seams,
    every query length, wildcards and planted hits; poly-A on poly-A (every
    anchor fires); a query over 8192 nt, all-N queries and a query anchored
    past #8's staged lookahead at word counts off its run (2-bit); random
    queries with 10% '?' at #9's block seams, A?A?.. on poly-A, and every
    triplet value with and without bit 63 against literal-N queries
    (base-5)."""
    import torch

    from cute_nucleotides_tpu_torch import api, interop
    from cute_nucleotides_tpu_torch.ops import kernels as K, search

    dev = "cuda"
    k2, k5 = SEARCH_KERNELS

    def one_2bit(w, n, query, what):
        q, care, m = search.compile_query(query)
        errors.compare(k2, K.match_bits_stream(w, q, care, n - m + 1),
                       K.match_bits_stream_plain(w, q, care, n - m + 1), what)

    def one_b5(w, n, query, what):
        qc = search.compile_query_b5(query)
        errors.compare(k5, K.match_b5_bits_stream(w, qc, n - len(query) + 1),
                       K.match_b5_bits_stream_plain(w, qc, n - len(query) + 1), what)

    cases = 0
    for n in SEARCH_NT:
        for m in SEARCH_M + (LONG_QUERY,):
            if m <= n:
                s, query = _planted(rng, n, b"ACGT", m, b"N")
                w = interop.u64_to_tensor(api.n_to_bits(s, tier="oracle"), dev)
                one_2bit(w, n, query, f"2-bit search {n} nt, {m}-nt query")
                check(0 in search.match_positions(w, n, query).tolist(), f"2-bit search {n}/{m}: hit at 0 missed")
                cases += 1
        w = interop.u64_to_tensor(api.n_to_bits(np.full(n, ord("A"), np.uint8), tier="oracle"), dev)
        for m in (1, 17, 45):
            if m <= n:
                one_2bit(w, n, b"A" * m, f"2-bit poly-A {n} nt, {m} nt")
                check(int(search.match_count(w, n, b"A" * m)) == n - m + 1, f"2-bit poly-A {n}/{m} count")
    # #8: all-N queries (no step: every start matches), and a 4800-nt query
    # whose anchor is its last word (the only one without an N), so its
    # anchor steps read 300 words past a thread's own: past the 256 that a
    # block stages
    long_q = bytearray(rng.choice(np.frombuffer(b"ACGT", np.uint8), 300 * 16).tobytes())
    long_q[: 299 * 16 : 5] = b"N" * len(long_q[: 299 * 16 : 5])
    check(K._match_table(*search.compile_query(bytes(long_q))[:2])[3] == 299,
          "the long query's anchor is not its last word")
    for W in SEARCH_W2:
        n = 16 * W - 5
        for query in (b"N", b"N" * 16, b"N" * 17, bytes(long_q)):
            m = len(query)
            if m <= n:
                s = rng.choice(np.frombuffer(b"ACGT", np.uint8), n)
                for p in (n - m, n // 3, 0):
                    s[p : p + m] = np.frombuffer(query.replace(b"N", b"A"), np.uint8)
                w = interop.u64_to_tensor(api.n_to_bits(s, tier="oracle"), dev)[:W]
                one_2bit(w, n, query, f"2-bit search {W} words, {m}-nt query {query[:4]!r}..")
                hits = search.match_positions(w, n, query)
                check(set(hits.tolist()) >= {0, n // 3, n - m}, f"2-bit search {W} words, {m} nt: a planted hit missed")
                if set(query) == {ord("N")}:
                    check(hits.size == n - m + 1, f"2-bit all-N query {m} nt on {W} words: {hits.size} hits")
                cases += 1
    for n in SEARCH_NT_B5:
        for m in SEARCH_M + (B5_MAX_QUERY,):
            if m <= n:
                s, query = _planted(rng, n, b"ACGTN", m, b"?")
                w = interop.u64_to_tensor(api.n_to_bits2(s, tier="oracle"), dev)
                one_b5(w, n, query, f"base-5 search {n} nt, {m}-nt query")
                check(0 in search.match_positions_b5(w, n, query).tolist(), f"base-5 search {n}/{m}: hit at 0 missed")
                cases += 1
        for m in rng.integers(1, min(n, B5_MAX_QUERY) + 1, 3).tolist():  # random, 10% '?'
            q = rng.choice(np.frombuffer(b"ACGTN", np.uint8), m)
            q[rng.random(m) < 0.1] = ord("?")
            one_b5(w, n, q.tobytes(), f"base-5 search {n} nt, random {m}-nt query")
        w = interop.u64_to_tensor(api.n_to_bits2(np.full(n, ord("A"), np.uint8), tier="oracle"), dev)
        for query in (b"A", b"A" * 17, b"A" * 45, (b"A?" * 23)[:45], (b"A?" * 512)[:1023]):
            m = len(query)
            if m <= n:  # poly-A: every anchor fires
                one_b5(w, n, query, f"base-5 poly-A {n} nt, {query[:4]!r}.. ({m} nt)")
                check(int(search.match_count_b5(w, n, query)) == n - m + 1, f"base-5 poly-A {n}/{m} count")
    t = np.arange(128, dtype=np.uint64)
    w64 = np.concatenate([(t << np.uint64(7 * j)) | (np.uint64(b) << np.uint64(63)) for j in range(9) for b in (0, 1)])
    w = interop.u64_to_tensor(w64, dev)
    n = 27 * w64.size
    corrupt = {27 * k + 3 * j + 2 for k, word in enumerate(w64.tolist()) for j in range(9)
               if (word >> (7 * j)) & 0x7F >= 125}
    for query in (b"N", b"NN", b"?N", b"N?A", b"AAN", b"CAN", b"?", b"ACGTN?" * 7 + b"ACG"):
        one_b5(w, n, query, f"base-5 search, all triplets, query {query!r}")
    hits = set(search.match_positions_b5(w, n, b"N").tolist())
    check(not hits & corrupt, "a literal-N query matched the high digit of a corrupt triplet")
    torch.cuda.synchronize()
    say(f"phase 2 search kernels: {cases} planted (stream, query) cases at {SEARCH_NT} nt and {SEARCH_W2} "
        f"words (2-bit, with all-N queries and a 4800-nt query anchored in its last word) and "
        f"{SEARCH_NT_B5} nt (base-5), queries {SEARCH_M} + {LONG_QUERY} (2-bit) / {B5_MAX_QUERY} (base-5) "
        f"nt, random base-5 queries with 10% '?', poly-A against A.. and A?A?.., all 128 triplets +- bit 63: "
        f"bit-identical to the plain versions "
        f"({errors.count} comparisons in phase 2; max abs err {errors.max})")


def _hist_cases(rng) -> dict:
    """Codes i32[1, n] for #13: n = 2^23 + 3 puts over 32768 codes of one
    value in each block's counters on 132 SMs (the carry to global) and
    leaves a ragged tail of 3."""
    n = (1 << 23) + 3
    masked = rng.integers(0, 1 << 16, n)
    masked[np.arange(n) % 8192 >= 143] = 0  # a 150-nt read's 143 k-mers per 8192 codes (8-mers)
    return {"all zero": np.zeros(n), "all 65535": np.full(n, 65535), "one code": np.full(n, 4242),
            "masked read": masked, "random": rng.integers(0, 1 << 16, n),
            "out of range": rng.integers(-70000, 140000, n)}


def phase_kernels_kmer(errors: Errors, rng) -> None:
    """#10 at every k in 1..15 and #11 at every k in 16..31, at W in KMER_W
    with 37 rows; #13 on the _hist_cases codes; each bit for bit against
    its plain version."""
    import torch

    from cute_nucleotides_tpu_torch.ops import kernels as K

    dev = "cuda"
    k10, k11, k13 = KMER_KERNELS
    for W in KMER_W:
        w, n, n2 = (torch.from_numpy(rng.integers(0, 2**32, (37, W), dtype=np.uint32)).to(dev) for _ in range(3))
        for k in range(1, 16):
            errors.compare(k10, K.kmer_codes_planar(w, n, k), K.kmer_codes_planar_plain(w, n, k),
                           f"kmer codes k={k} W={W}")
        for k in range(16, 32):
            lo, hi = K.kmer_codes_planar_pair(w, n, n2, k)
            plo, phi = K.kmer_codes_planar_pair_plain(w, n, n2, k)
            errors.compare(k11, lo, plo, f"kmer pair lo k={k} W={W}")
            errors.compare(k11, hi, phi, f"kmer pair hi k={k} W={W}")
    cases = _hist_cases(rng)
    for label, codes in cases.items():
        t = torch.from_numpy(codes.astype(np.int32).reshape(1, -1)).to(dev)
        got = K.hist_codes(t)
        errors.compare(k13, got, K.hist_codes_plain(t), f"hist {label}")
        inside = codes[(codes >= 0) & (codes < 1 << 16)].astype(np.int64)
        check(np.array_equal(got.cpu().numpy().reshape(-1), np.bincount(inside, minlength=1 << 16)),
              f"hist {label} != numpy bincount")
    torch.cuda.synchronize()
    say(f"phase 2 k-mer kernels: #10 at k 1..15 and #11 at k 16..31 on u32[37, W], W in {KMER_W}; #13 on "
        f"{len(cases)} code sets of 2^23 + 3: bit-identical to the plain versions "
        f"({errors.count} comparisons in phase 2; max abs err {errors.max})")


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) % 2**32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) % 2**32
    return h ^ (h >> 16)


def _sentinel_code(k: int) -> int:
    """A canonical 2k-bit code (16 <= k <= 31) whose pair hash
    fmix32(lo ^ fmix32(hi)) is 0xFFFFFFFF: fmix32 is invertible, so lo
    follows from hi."""
    h = SENTINEL ^ (SENTINEL >> 16)  # fmix32 inverted, step by step
    h = (h * pow(0xC2B2AE35, -1, 2**32)) % 2**32
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * pow(0x85EBCA6B, -1, 2**32)) % 2**32
    unmixed = h ^ (h >> 16)
    for hi in range(1 << min(2 * k - 32, 16)):
        code = (unmixed ^ _fmix32(hi)) | hi << 32
        rc = sum((((code >> (2 * j)) & 3) ^ 2) << (2 * (k - 1 - j)) for j in range(k))
        if code <= rc:
            return code
    raise SmokeFailure(f"no canonical k-mer hashes to 0xFFFFFFFF at k={k}")


def _plant_code(words: np.ndarray, pos: int, code: int, k: int) -> None:
    """Write a 2k-bit code at nt ``pos`` of a flat u32 stream, in place."""
    q, s = divmod(pos, 16)
    v = sum(int(words[q + j]) << (32 * j) for j in range(3))
    v = (v & ~(((1 << (2 * k)) - 1) << (2 * s))) | code << (2 * s)
    for j in range(3):
        words[q + j] = (v >> (32 * j)) & 0xFFFFFFFF


def phase_kernels_sketch(errors: Errors, rng) -> None:
    """#12 at every k in 16..31, canonical and forward, W in KMER_W (one
    stream, and rows of 37 words as a read batch), n_valid at the end, at a
    word seam and at a row seam, with a planted k-mer whose hash is
    0xFFFFFFFF; #14 at k in {1, 7, 15} and w in MZ_W and 2049 - k,
    canonical and forward, on MZ_NT-long random and poly-A streams (n a
    multiple of neither block span); each bit for bit against its plain
    version."""
    import torch

    from cute_nucleotides_tpu_torch.ops import kernels as K

    dev = "cuda"
    k12, k14 = SKETCH_KERNELS
    planted = 0
    for W in KMER_W + (3000,):
        flat = rng.integers(0, 2**32, W + 2, dtype=np.uint32)
        pos = 16 * (W // 2) + 5 if W > 2 else None
        if pos is not None:
            _plant_code(flat, pos, _sentinel_code(SKETCH_K), SKETCH_K)
        w = torch.from_numpy(flat[:W].copy()).to(dev)
        seams = sorted({16 * W - 31 + 1, 16 * W, 16 * (W // 2), 16 * 512 + 3})
        for k in range(16, 32):
            for canonical in (False, True):
                for seg in (0, 37):
                    for n_valid in seams:
                        got = K.kmer_hashes_planar_pair(w, k, n_valid, canonical=canonical, seg=seg)
                        want = K.kmer_hashes_planar_pair_plain(w, k, n_valid, canonical=canonical, seg=seg)
                        errors.compare(k12, got, want, f"kmer hashes k={k} W={W} canonical={canonical} "
                                       f"seg={seg} n_valid={n_valid}")
        if pos is not None:  # the planted k-mer's slot holds 0xFFFFFFFF as a hash, not as padding
            h = K.kmer_hashes_planar_pair(w, SKETCH_K, 16 * W, canonical=True).view(torch.int32).view(-1)
            r, c = divmod(pos // 16, 512)
            check(int(h[r * 16 * 512 + 512 * (pos % 16) + c]) == -1, f"planted 0xFFFFFFFF k-mer, W={W}")
            planted += 1
    cases = 0
    for nt in MZ_NT:
        words = rng.integers(0, 2**32, -(-nt // 16), dtype=np.uint32)
        for label, stream in (("random", words), ("poly-A", np.zeros_like(words))):
            w = torch.from_numpy(stream).to(dev)
            for k in (1, 7, 15):
                for win in MZ_W + (2048 - k + 1,):
                    for canonical in (False, True):
                        n = nt - k + 1
                        got = K.minimizer_bits_stream(w, n, k, win, canonical=canonical)
                        want = K.minimizer_bits_stream_plain(w, n, k, win, canonical=canonical)
                        errors.compare(k14, got, want, f"minimizers {label} {nt} nt k={k} w={win} "
                                       f"canonical={canonical}")
                        cases += 1
            if label == "poly-A":  # every hash ties: every position is a minimizer
                n = nt - 15 + 1
                bits = K.minimizer_bits_stream(w, n, 15, 10).view(torch.int32)
                check(int(bits[:-1].eq(0xFFFF).sum()) == bits.numel() - 1, f"poly-A minimizers {nt} nt")
    torch.cuda.synchronize()
    say(f"phase 2 sketch kernels: #12 at k 16..31 on W in {KMER_W + (3000,)} (one stream and 37-word rows, "
        f"n_valid at the end and at word and row seams, a planted 0xFFFFFFFF k-mer in {planted} streams); #14 "
        f"in {cases} cases (w in {MZ_W} and 2049 - k) on {MZ_NT}-nt random and poly-A streams: bit-identical to the plain versions "
        f"({errors.count} comparisons in phase 2; max abs err {errors.max})")


def _every_triplet_words() -> np.ndarray:
    """u64 words holding every triplet value 0..127 in every slot, with and
    without bit 63."""
    t = np.arange(128, dtype=np.uint64)
    return np.concatenate([(t << np.uint64(7 * j)) | (np.uint64(b) << np.uint64(63)) for j in range(9) for b in (0, 1)])


def _sort_cases(rng, n: int) -> dict:
    """(hi, lo) u32[n] key planes of the shapes #18 must order: random, all
    equal, descending, ties on hi, values straddling the int32 sign bit,
    and k-mer keys (a 10-bit hi, heavy lo duplication, the last fifth the
    (0xFFFFFFFF, 0xFFFFFFFF) sentinel), and k-mer keys without sentinels,
    whose digits 2, 3, 6 and 7 each hold a single value."""
    asc = np.arange(n, dtype=np.uint32)
    kmer_hi = rng.integers(0, 1 << 10, n, dtype=np.uint64).astype(np.uint32)
    kmer_lo = rng.integers(0, 5000, n, dtype=np.uint64).astype(np.uint32)
    kmer_hi[-(n // 5):] = kmer_lo[-(n // 5):] = SENTINEL
    plain = (rng.integers(0, 1 << 10, n, dtype=np.uint64).astype(np.uint32),
             rng.integers(0, 5000, n, dtype=np.uint64).astype(np.uint32))
    straddle = (rng.integers(2**31 - 4, 2**31 + 4, n, dtype=np.uint64).astype(np.uint32),
                rng.integers(2**31 - 4, 2**31 + 4, n, dtype=np.uint64).astype(np.uint32))
    return {"random": (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
                       rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)),
            "k-mer keys": (kmer_hi, kmer_lo), "descending": (asc[::-1].copy(), asc.copy()),
            "all equal": (np.full(n, 7, np.uint32), np.full(n, 3, np.uint32)),
            "ties on hi": (np.zeros(n, np.uint32), asc[::-1].copy()), "sign bit": straddle,
            "k-mer keys, no sentinels": plain}


def phase_kernels_seqops(errors: Errors, rng) -> None:
    """#7 on GC_B5_WORDS random words (any triplet value, bit 63 on about
    half) and on every triplet value in every slot with and without bit 63;
    #18 at SORT_N pairs on the _sort_cases shapes (the four most telling
    above 2^16), against its plain version and prefer="lax"; each bit for
    bit."""
    import torch

    from cute_nucleotides_tpu_torch import interop
    from cute_nucleotides_tpu_torch.ops import kernels as K, sort

    dev = "cuda"
    (k7,), (k18,) = SEQOPS_KERNELS, SORT_KERNELS
    streams = {f"{n} random words": rng.integers(0, 2**63, n, dtype=np.uint64)
               | (rng.integers(0, 2, n, dtype=np.uint64) << np.uint64(63)) for n in GC_B5_WORDS}
    streams["every triplet in every slot +- bit 63"] = _every_triplet_words()
    for label, w64 in streams.items():
        w = interop.u64_to_tensor(w64, dev)
        errors.compare(k7, K.gc_b5_stream(w), K.gc_b5_stream_plain(w), f"gc_b5 {label}")
    # the reference's formula on corrupt triplets: t = 125, 126, 127 count 1, 2, 1
    w = interop.u64_to_tensor(np.array([125, 126 << 7, (127 << 14) | (1 << 63)], np.uint64), dev)
    check(int(K.gc_b5_stream(w)) == 4, f"gc_b5 of triplets 125, 126, 127: {int(K.gc_b5_stream(w))} != 4")
    cases = 0
    for n in SORT_N:
        for label, (hi, lo) in _sort_cases(rng, n).items():
            if n > 1 << 16 and label not in ("random", "k-mer keys", "descending", "k-mer keys, no sentinels"):
                continue
            th, tl = torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev)
            got = K.sort_pairs_bitonic(th, tl)
            for ref, by in ((K.sort_pairs_bitonic_plain(th, tl), "plain version"), (sort.sort_pairs(th, tl), "lax")):
                for plane, a, b in zip(("hi", "lo"), got, ref):
                    errors.compare(k18, a, b, f"#18 {label} n={n} {plane} vs {by}")
            cases += 1
            del th, tl, got, ref
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    say(f"phase 2 seqops and sort kernels: #7 on {GC_B5_WORDS} random words and every triplet in every slot +- "
        f"bit 63; #18 in {cases} cases at {SORT_N} pairs against its plain version and prefer='lax': "
        f"bit-identical ({errors.count} comparisons in phase 2; max abs err {errors.max})")


def _planes(w64: np.ndarray, dev: str):
    """u64 words (a multiple of 128) -> the (lo, hi) planes u32[R, 128] on dev."""
    import torch

    pair = w64.view(np.uint32).reshape(-1, 128, 2)
    return tuple(torch.from_numpy(np.ascontiguousarray(pair[..., i])).to(dev) for i in (0, 1))


def phase_kernels_planar(errors: Errors, rng) -> None:
    """#15 at PLANAR_R rows of random ACGTUN bytes and on all 256 byte values
    (in runs of 27, and at every position of a word), reinterleaved against
    #5; #16 (padded and compact) and #17 at PLANAR_R rows of random words and
    on every triplet value in every slot with and without bit 63, against
    their plain versions and against #6 (``decode_b5_stream``) on the
    interleaved words; the pad lanes 'AAAA'; a misaligned view refused."""
    import torch

    from cute_nucleotides_tpu_torch import interop
    from cute_nucleotides_tpu_torch.ops import kernels as K

    dev = "cuda"
    k15, k16, k17 = PLANAR_KERNELS
    alpha = np.frombuffer(ALPHABET_N, np.uint8)
    rows = {f"{R} rows": rng.choice(alpha, size=(R, K.B5_ROW_NT)) for R in PLANAR_R}
    rows["all 256 bytes in runs"] = np.arange(256, dtype=np.uint8).repeat(27).reshape(2, K.B5_ROW_NT)
    rows["all 256 bytes at every position"] = np.tile(np.arange(256, dtype=np.uint8), 27).reshape(2, K.B5_ROW_NT)
    for label, host in rows.items():
        x = torch.from_numpy(host).to(dev)
        lo, hi = K.encode_b5_planar(x)
        for plane, got, want in zip(("lo", "hi"), (lo, hi), K.encode_b5_planar_plain(x)):
            errors.compare(k15, got, want, f"planar encode {plane}, {label}")
        check(torch.equal(K._interleave(lo, hi).view(torch.int32), K.encode_b5_stream(x.view(-1)).view(torch.int32)),
              f"planar encode {label}: the planes reinterleaved != encode_b5_stream")
    words = {f"{R} rows of random words": rng.integers(0, 2**64, R * K.B5_ROW_WORDS, dtype=np.uint64)
             for R in PLANAR_R}
    words["every triplet in every slot +- bit 63"] = _every_triplet_words()
    for label, w64 in words.items():
        lo, hi = _planes(w64, dev)
        R = lo.shape[0]
        want = K.decode_b5_stream(interop.u64_to_tensor(w64, dev))
        got = K.decode_b5_panels(lo, hi)
        errors.compare(k17, got, K.decode_b5_panels_plain(lo, hi), f"planar decode {label}")
        check(torch.equal(got.view(-1), want), f"planar decode {label} != decode_b5_stream")
        for padded in (True, False):
            got = K.decode_b5_nt4_panels(lo, hi, padded=padded)
            errors.compare(k16, got, K.decode_b5_nt4_panels_plain(lo, hi, padded=padded),
                           f"nt4 decode padded={padded} {label}")
        check(torch.equal(K.decode_b5_nt4_panels(lo, hi, padded=False).view(torch.uint8).view(-1), want),
              f"compact nt4 decode {label} != decode_b5_stream")
        lanes = K.decode_b5_nt4_panels(lo, hi).view(torch.int32).view(R, K.B5_SLICES, 112)
        check(torch.equal(lanes[:, :, :108].contiguous().view(torch.uint8).view(-1), want),
              f"padded nt4 decode {label}: data lanes != decode_b5_stream")
        check(bool((lanes[:, :, 108:] == 0x41414141).all()), f"padded nt4 decode {label}: a pad lane is not 'AAAA'")
    x = torch.zeros(2 * K.B5_ROW_NT + 16, dtype=torch.uint8, device=dev)[4 : 4 + K.B5_ROW_NT].view(1, K.B5_ROW_NT)
    try:
        K.encode_b5_planar(x)
    except ValueError:
        pass
    else:
        raise SmokeFailure("encode_b5_planar took a view that is not 16-byte aligned")
    torch.cuda.synchronize()
    say(f"phase 2 planar kernels: #15 on {PLANAR_R} rows and all 256 bytes, #16 (padded, compact) and #17 on "
        f"{PLANAR_R} rows of random words and every triplet in every slot +- bit 63: bit-identical to the plain "
        f"versions and to #5/#6 on the interleaved words; pad lanes 'AAAA' ({errors.count} comparisons in "
        f"phase 2; max abs err {errors.max})")


# --- phase 3: the resident 1-Gnt batch -----------------------------------------

def _make_batch(seed: int, nt: int = BATCH_NT, alphabet: bytes = ALPHABET):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    lut = torch.tensor(list(alphabet), dtype=torch.uint8, device="cuda")
    x = torch.empty((BATCH_ROWS, nt), dtype=torch.uint8, device="cuda")
    step = 256
    for r in range(0, BATCH_ROWS, step):
        x[r : r + step] = lut[torch.randint(0, len(alphabet), (step, nt), generator=g, device="cuda")]
    return x


def _by_rows(fn, *tensors, step: int = 256):
    """Apply a plain version row-chunk by row-chunk (bounds its int64 temporaries)."""
    import torch

    def cat(parts):  # uint32 through its int32 view: cat may lack uint32 on the card
        return torch.cat([p.view(torch.int32) if p.dtype == torch.uint32 else p for p in parts])

    outs = [fn(*(t[r : r + step] for t in tensors)) for r in range(0, tensors[0].shape[0], step)]
    if isinstance(outs[0], tuple):
        return tuple(cat(parts) for parts in zip(*outs))
    return cat(outs)


def _upper_t(x):
    y = x & 0xDF
    return y.masked_fill(y == ord("U"), ord("T"))


def phase_batch(errors: Errors, rng):
    import torch

    from cute_nucleotides_tpu_torch import compat
    from cute_nucleotides_tpu_torch.models import TwoBitCodec
    from cute_nucleotides_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    x = _make_batch(SEED)
    nt4 = x.view(torch.uint32)
    codec = TwoBitCodec(device="cuda")
    check(codec.tier == "cuda", f"auto on a CUDA device resolved to {codec.tier}")
    words = codec.encode(x)
    check(words.shape == (BATCH_ROWS, BATCH_NT // 16), f"encode shape {tuple(words.shape)}")
    for v in ("mul", "shift", "interleave", "mxu"):
        got = words if v == "mul" else TwoBitCodec(device="cuda", encode_variant=v).encode(x)
        if v == "mxu":
            want = _by_rows(K.encode_2bit_nt4_mxu_plain, nt4)
            errors.compare("encode_2bit_nt4_mxu", got.view(torch.int32), want, "batch mxu vs plain")
        else:
            want = _by_rows(lambda t: K.encode_2bit_nt4_plain(t, v), nt4).view(torch.int32)
            errors.compare("encode_2bit_nt4", got.view(torch.int32), want, f"batch {v} vs plain")
        check(torch.equal(got.view(torch.int32), words.view(torch.int32)), f"batch {v} != mul")
        del got, want
    pext = TwoBitCodec(device="cuda", encode_variant="mxu")
    checked = (("encode_2bit_nt4_checked", codec), ("encode_2bit_nt4_mxu", pext))
    _, pflags = _by_rows(lambda t: K.encode_2bit_nt4_checked_plain(t, "mul"), nt4)
    for kname, c in checked:
        out, bad = c.encode_checked(x)
        check(torch.equal(out.view(torch.int32), words.view(torch.int32)),
              f"encode_checked[{c.encode_variant}] words != encode")
        check(not bool(bad.any()), f"encode_checked[{c.encode_variant}] flagged a row of valid input")
        errors.compare(kname, bad.to(torch.int64), _i64(pflags), f"batch flags[{c.encode_variant}] vs plain")
        del out
    # inject bad bytes into known rows, check exactly those are flagged, restore
    bad_rows = sorted(rng.choice(BATCH_ROWS, size=37, replace=False).tolist())
    cols = rng.integers(0, BATCH_NT, size=len(bad_rows)).tolist()
    saved = [int(x[r, c]) for r, c in zip(bad_rows, cols)]
    for i, (r, c) in enumerate(zip(bad_rows, cols)):
        x[r, c] = INVALID[i % len(INVALID)]
    _, pflags = _by_rows(lambda t: K.encode_2bit_nt4_checked_plain(t, "mul"), nt4)
    for kname, c in checked:
        _, bad = c.encode_checked(x)
        got_rows = torch.nonzero(bad).flatten().tolist()
        check(got_rows == bad_rows, f"encode_checked[{c.encode_variant}] flagged rows {got_rows[:8]}..., "
              f"want {bad_rows[:8]}...")
        errors.compare(kname, bad.to(torch.int64), _i64(pflags),
                       f"injected flags[{c.encode_variant}] vs plain")
    for (r, c), b in zip(zip(bad_rows, cols), saved):
        x[r, c] = b
    dec = codec.decode(words)
    check(torch.equal(dec, _upper_t(x)), "decode(encode(x)) != upper(x) with U->T")
    packed = words.view(torch.uint8)
    want = _by_rows(lambda t: K.decode_2bit_nt4_plain(t, "swar"), packed)
    errors.compare("decode_2bit_nt4", dec.view(torch.int32), want, "batch decode vs plain")
    del want
    for v in ("shuffle", "select"):
        got = TwoBitCodec(device="cuda", decode_variant=v).decode(words)
        check(torch.equal(got, dec), f"decode[{v}] != decode[swar]")
        del got
    flat, wflat = x.view(-1), words.view(-1)
    for label, xs, ws in (("head", flat[:MNT], wflat[: MNT // 16]), ("tail", flat[-MNT:], wflat[-MNT // 16 :])):
        want_w = compat.n_to_bits_lut(xs.cpu().numpy())
        check(np.array_equal(ws.cpu().numpy().view("<u8"), want_w), f"1 Mnt {label} window != oracle")
    torch.cuda.synchronize()
    say(f"phase 3 batch: u8[{BATCH_ROWS}, {BATCH_NT}] encode x4 variants, encode_checked "
        f"[mul, mxu] (clean + {len(bad_rows)} injected rows), decode x3 variants bit-identical; "
        f"1 Mnt windows == oracle ({time.perf_counter() - t0:.1f} s)")
    return x, words, dec


def _any_flag(flags) -> bool:
    """The per-chunk u32[1] flags of a plain version, OR-ed."""
    return bool((flags != 0).any())


def phase_batch_b5(errors: Errors, rng):
    import torch

    from cute_nucleotides_tpu_torch import compat
    from cute_nucleotides_tpu_torch.models import Base5Codec
    from cute_nucleotides_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    x = _make_batch(SEED + 5, B5_NT, ALPHABET_N)
    codec = Base5Codec(device="cuda")
    check(codec.tier == "cuda", f"auto on a CUDA device resolved to {codec.tier}")
    words = codec.encode(x)
    W = B5_NT // 27
    check(words.shape == (BATCH_ROWS, 2 * W), f"base-5 encode shape {tuple(words.shape)}")
    enc_plain = lambda t: K.encode_b5_stream_plain(t.reshape(-1))  # noqa: E731
    errors.compare("encode_b5_stream", words.view(torch.int32).view(-1), _by_rows(enc_plain, x),
                   "base-5 batch encode vs plain")
    checked_plain = lambda t: K.encode_b5_stream_plain(t.reshape(-1), checked=True)[1]  # noqa: E731
    out, bad = codec.encode_checked(x)
    check(torch.equal(out.view(torch.int32), words.view(torch.int32)),
          "base-5 encode_checked words != encode")
    check(bad.shape == () and not bool(bad), "base-5 encode_checked flagged valid input")
    check(not _any_flag(_by_rows(checked_plain, x)), "plain checked encode flagged valid input")
    del out
    r, c = int(rng.integers(0, BATCH_ROWS)), int(rng.integers(0, B5_NT))
    saved = int(x[r, c])
    x[r, c] = ord("X")
    _, bad = codec.encode_checked(x)
    check(bool(bad), f"base-5 encode_checked missed an 'X' at [{r}, {c}]")
    check(_any_flag(_by_rows(checked_plain, x)), "plain checked encode missed the 'X'")
    x[r, c] = saved
    dec = codec.decode(words)
    check(torch.equal(dec, _upper_t(x)), "base-5 decode(encode(x)) != upper(x) with U->T")
    # compared as int32 lanes (each 256-row chunk holds a multiple of 4 bytes)
    dec_plain = lambda w: K.decode_b5_stream_plain(w.reshape(-1)).view(torch.int32)  # noqa: E731
    errors.compare("decode_b5_stream", dec.view(-1).view(torch.int32), _by_rows(dec_plain, words),
                   "base-5 batch decode vs plain")
    got, bad = codec.decode_checked(words)
    check(torch.equal(got, dec) and bad.shape == () and not bool(bad), "base-5 decode_checked on clean words")
    del got
    r, w = int(rng.integers(0, BATCH_ROWS)), int(rng.integers(0, W))
    lane = words.view(torch.int32)[r, 2 * w]
    saved = int(lane)
    lane |= 0x7F << 7  # triplet 1 of the word reads 127
    _, bad = codec.decode_checked(words)
    check(bool(bad), f"base-5 decode_checked missed a corrupt word at [{r}, {w}]")
    words.view(torch.int32)[r, 2 * w] = saved
    flat, wflat, dflat = x.view(-1), words.view(-1), dec.view(-1)
    nw = MNT_B5 // 27
    for label, sl, wsl in (("head", slice(0, MNT_B5), slice(0, 2 * nw)),
                           ("tail", slice(-MNT_B5, None), slice(-2 * nw, None))):
        want_w = compat.n_to_bits2_lut(flat[sl].cpu().numpy())
        ws = wflat[wsl].cpu().numpy().view("<u8")
        check(np.array_equal(ws, want_w), f"base-5 {MNT_B5}-nt {label} window != oracle")
        check(np.array_equal(dflat[sl].cpu().numpy(), compat.bits_to_n2_lut(want_w, MNT_B5)),
              f"base-5 {MNT_B5}-nt {label} decode window != oracle")
    del dec
    torch.cuda.synchronize()
    say(f"phase 3 base-5 batch: u8[{BATCH_ROWS}, {B5_NT}] encode, encode_checked (clean + one 'X'), "
        f"decode, decode_checked (clean + one corrupt word) bit-identical; {MNT_B5}-nt windows == "
        f"oracle ({time.perf_counter() - t0:.1f} s)")
    return x, words


def _plain_by_chunks(errors: Errors, name: str, got, plain, words, n_starts: int, per_word: int,
                     halves: int, look: int, what: str, step: int = 1 << 22) -> int:
    """Hold kernel bits u32[W] against a plain version run on chunks of
    ``step`` words (plus ``look`` words it reads past each), so that its
    int64 temporaries stay small; returns the plain version's bit count."""
    import torch

    W = got.numel()
    total = 0
    for a in range(0, W, step):
        b = min(a + step, W)
        want = plain(words[halves * a : halves * min(b + look, W)], n_starts - per_word * a)[: b - a]
        errors.compare(name, got[a:b], want, f"{what} words {a}..{b}")
        total += int(torch.sum(_popcount(_i64(want))))
    return total


def _popcount(v):
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _plant(x, starts, pattern: bytes) -> None:
    import torch

    idx = torch.as_tensor(starts, device=x.device)[:, None] + torch.arange(len(pattern), device=x.device)
    x.view(-1)[idx.flatten()] = torch.tensor(list(pattern), dtype=torch.uint8, device=x.device).repeat(len(starts))


def phase_search_batch(errors: Errors, rng, x, x5):
    """Search on the phase-3 batches flattened into streams: the primer is
    planted at seeded starts and the batches re-encoded, then match_bits and
    match_count (and the _b5 twins) for 7 nt, 45 nt with wildcards and the
    primer, each against its plain version."""
    from cute_nucleotides_tpu_torch.models import Base5Codec, TwoBitCodec
    from cute_nucleotides_tpu_torch.ops import kernels as K, search

    t0 = time.perf_counter()
    k2, k5 = SEARCH_KERNELS
    out = []
    for label, batch, codec, alpha, wildcard in (("2-bit", x, TwoBitCodec, b"ACGT", b"N"),
                                                 ("base-5", x5, Base5Codec, b"ACGTN", b"?")):
        n = batch.numel()
        span = n // 64  # one primer per span: no two overlap
        starts = [i * span + int(rng.integers(0, span - len(PRIMER))) for i in range(64)]
        _plant(batch, starts, PRIMER)
        words = codec(device="cuda").encode(batch)
        wf = words.view(-1)
        q45 = bytearray(rng.choice(np.frombuffer(alpha, np.uint8), 45).tobytes())
        q45[3::7] = wildcard * len(q45[3::7])
        reads = []
        for query in (b"GATTACA", bytes(q45), PRIMER):
            m = len(query)
            if codec is TwoBitCodec:
                bits, count = search.match_bits(wf, n, query), search.match_count(wf, n, query)
                q, care, _ = search.compile_query(query)
                total = _plain_by_chunks(errors, k2, bits, lambda w, ns: K.match_bits_stream_plain(w, q, care, ns),
                                         wf, n - m + 1, 16, 1, q.size + 1, f"{label} search {query!r}")
                hits = search.match_positions(wf, n, query) if query == PRIMER else None
            else:
                bits, count = search.match_bits_b5(wf, n, query), search.match_count_b5(wf, n, query)
                qc = search.compile_query_b5(query)
                total = _plain_by_chunks(errors, k5, bits, lambda w, ns: K.match_b5_bits_stream_plain(w, qc, ns),
                                         wf, n - m + 1, 27, 2, 40, f"{label} search {query!r}")
                hits = search.match_positions_b5(wf, n, query) if query == PRIMER else None
            check(int(count) == total, f"{label} match_count {int(count)} != plain bit count {total}")
            if hits is not None:
                check(set(starts) <= set(hits.tolist()), f"{label}: a planted primer was not found")
            reads.append(f"{m} nt: {total} hits")
        say(f"phase 3 search {label}: {n} nt stream ({wf.numel()} u32): {', '.join(reads)}; kernel bits "
            f"== plain version (chunked); 64 planted primers found")
        out.append(words)
    say(f"phase 3 search: {time.perf_counter() - t0:.1f} s with the checks")
    return out


# --- phase 4: host API and compat names ----------------------------------------

def _upper_t_np(s: np.ndarray) -> np.ndarray:
    y = s & 0xDF
    y[y == ord("U")] = ord("T")
    return y


def _profiled(fn):
    """Run fn under torch.profiler (CUDA activity only).  Returns its result,
    the wall seconds, and the device ms of the port's kernels, of copies
    (memcpy) and of other device work, summed over the profiler's raw
    device events (``key_averages()`` would build a Python object per event,
    minutes for the 20,000-read ``stats`` of earlier runs), with the five largest device
    event names by total under "top".  The port's kernel events are counted
    against the launches its wrappers counted during the call: a profile
    that saw fewer (the profiler loses events in a long process, PERF.md)
    is marked under "lost", and :func:`_breakdown` then gives no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cute_nucleotides_tpu_torch.ops import kernels as K

    launched = -sum(f.launches for f in K.WRAPPERS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched += sum(f.launches for f in K.WRAPPERS)
    device = {"kernels": 0.0, "copies": 0.0, "other": 0.0}
    by_name: dict[str, float] = {}
    seen = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        key, ms = ev.name(), ev.duration_ns() / 1e6
        if any(tag in key for tag in ("_2bit_", "_b5_", "kmer_codes", "hist_codes", "kmer_hashes",
                                      "minimizer_kernel", "radix_", "myers_")):
            kind = "kernels"
            seen += 1
        else:
            kind = "copies" if key.startswith("Memcpy") else "other"
        device[kind] += ms
        by_name[key] = by_name.get(key, 0.0) + ms
    device["top"] = sorted(((ms, key[:64]) for key, ms in by_name.items()), reverse=True)[:5]
    device["seen"] = seen
    device["lost"] = (seen, launched) if seen < launched else None
    return out, wall, device


def _breakdown(wall: float, device: dict) -> str:
    busy = (device["kernels"] + device["copies"] + device["other"]) / 1e3
    if device["lost"]:
        seen, launched = device["lost"]
        return (f"{wall:.4f} s wall; device time not measured (the profiler saw {seen} of the {launched} kernel "
                f"launches)")
    if busy == 0:
        return f"{wall:.4f} s wall; device time not measured (the profiler saw no device events)"
    return (f"{wall:.4f} s wall; device: kernels {device['kernels']:.4f} ms, copies "
            f"{device['copies']:.3f} ms, other {device['other']:.3f} ms")


def phase_api(rng) -> None:
    from cute_nucleotides_tpu_torch import api, compat

    t0 = time.perf_counter()
    alpha = np.frombuffer(ALPHABET, np.uint8)
    seq = alpha[rng.integers(0, len(alpha), CHR1_NT, dtype=np.uint8)]
    words, enc_wall, enc_dev = _profiled(lambda: api.n_to_bits(seq, tier="auto"))
    want = api.n_to_bits(seq, tier="oracle")
    check(words.dtype == np.uint64 and np.array_equal(words, want), "chr1 n_to_bits != host oracle")
    back, dec_wall, dec_dev = _profiled(lambda: api.bits_to_n(words, CHR1_NT, tier="auto"))
    check(np.array_equal(back, _upper_t_np(seq)), "chr1 bits_to_n(n_to_bits(x)) != upper(x)")
    t_chr1 = time.perf_counter() - t0
    for n in RAGGED:
        s = alpha[rng.integers(0, len(alpha), n)]
        w = api.n_to_bits(s)
        check(np.array_equal(w, api.n_to_bits(s, tier="oracle")), f"n_to_bits length {n}")
        check(np.array_equal(api.bits_to_n(w, n), _upper_t_np(s)), f"bits_to_n length {n}")
    check(api.n_to_bits(b"").size == 0 and api.bits_to_n(np.zeros(0, np.uint64), 0).size == 0,
          "empty input")
    n = MNT + 3
    s = alpha[rng.integers(0, len(alpha), n)]
    w = api.n_to_bits(s, tier="oracle")
    s_ref = api.bits_to_n(w, n, tier="oracle")
    for name in ("n_to_bits_lut", "n_to_bits_pext", "n_to_bits_shift", "n_to_bits_movemask", "n_to_bits_mul"):
        check(np.array_equal(getattr(compat, name)(s), w), f"compat.{name} != oracle")
    for name in ("bits_to_n_lut", "bits_to_n_shuffle", "bits_to_n_pdep", "bits_to_n_clmul"):
        check(np.array_equal(getattr(compat, name)(w, n), s_ref), f"compat.{name} != oracle")
    say(f"phase 4 api: chr1-length {CHR1_NT} nt encode == host oracle and round-trips "
        f"({t_chr1:.1f} s with the checks); ragged lengths {RAGGED} ok; nine compat names == "
        f"oracle on {n} nt")
    say(f"  api.n_to_bits, chr1 length: {_breakdown(enc_wall, enc_dev)}")
    say(f"  api.bits_to_n, chr1 length: {_breakdown(dec_wall, dec_dev)}")


def phase_api_b5(rng) -> None:
    from cute_nucleotides_tpu_torch import api, compat

    t0 = time.perf_counter()
    alpha = np.frombuffer(ALPHABET_N, np.uint8)
    seq = alpha[rng.integers(0, len(alpha), CHR1_NT, dtype=np.uint8)]
    words, enc_wall, enc_dev = _profiled(lambda: api.n_to_bits2(seq, tier="auto"))
    want = api.n_to_bits2(seq, tier="oracle")
    check(words.dtype == np.uint64 and np.array_equal(words, want), "chr1 n_to_bits2 != host oracle")
    back, dec_wall, dec_dev = _profiled(lambda: api.bits_to_n2(words, CHR1_NT, tier="auto"))
    check(np.array_equal(back, _upper_t_np(seq)), "chr1 bits_to_n2(n_to_bits2(x)) != upper(x)")
    t_chr1 = time.perf_counter() - t0
    for n in RAGGED_B5:
        s = alpha[rng.integers(0, len(alpha), n)]
        w = api.n_to_bits2(s)
        check(np.array_equal(w, api.n_to_bits2(s, tier="oracle")), f"n_to_bits2 length {n}")
        check(np.array_equal(api.bits_to_n2(w, n), _upper_t_np(s)), f"bits_to_n2 length {n}")
    check(api.n_to_bits2(b"").size == 0 and api.bits_to_n2(np.zeros(0, np.uint64), 0).size == 0,
          "base-5 empty input")
    n = MNT + 3
    s = alpha[rng.integers(0, len(alpha), n)]
    w = api.n_to_bits2(s, tier="oracle")
    s_ref = api.bits_to_n2(w, n, tier="oracle")
    for name in ("n_to_bits2_lut", "n_to_bits2_pext"):
        check(np.array_equal(getattr(compat, name)(s), w), f"compat.{name} != oracle")
    for name in ("bits_to_n2_lut", "bits_to_n2_pdep"):
        check(np.array_equal(getattr(compat, name)(w, n), s_ref), f"compat.{name} != oracle")
    say(f"phase 4 base-5 api: chr1-length {CHR1_NT} nt (not a multiple of 27) encode == host oracle "
        f"and round-trips ({t_chr1:.1f} s with the checks); ragged lengths {RAGGED_B5} ok; four "
        f"base-5 compat names == oracle on {n} nt")
    say(f"  api.n_to_bits2, chr1 length: {_breakdown(enc_wall, enc_dev)}")
    say(f"  api.bits_to_n2, chr1 length: {_breakdown(dec_wall, dec_dev)}")


# --- phase 5: the CLI ----------------------------------------------------------

def _write_fastq(path: str, rng, alphabet: bytes = ALPHABET) -> list[tuple[bytes, bytes]]:
    alpha = np.frombuffer(alphabet, np.uint8)
    seqs = alpha[rng.integers(0, len(alpha), (CLI_READS, CLI_READ_NT), dtype=np.uint8)]
    qual = b"I" * CLI_READ_NT
    records = [(b"read%d" % i, seqs[i].tobytes()) for i in range(CLI_READS)]
    with open(path, "wb") as f:
        f.write(b"".join(b"@%s\n%s\n+\n%s\n" % (name, s, qual) for name, s in records))
    return records


def _fasta(records) -> bytes:
    """FASTA of (name, seq) records, sequence lines of 80 characters."""
    out = io.BytesIO()
    for name, s in records:
        out.write(b">" + name + b"\n")
        for i in range(0, len(s), 80):
            out.write(s[i : i + 80] + b"\n")
    return out.getvalue()


def phase_cli(rng, workdir: str) -> list[tuple[bytes, bytes]]:
    from cute_nucleotides_tpu_torch import cli

    t0 = time.perf_counter()
    fq = os.path.join(workdir, "reads.fq")
    nup, nup_oracle, fa = (os.path.join(workdir, f) for f in ("reads.nup", "oracle.nup", "reads.fa"))
    records = _write_fastq(fq, rng)
    rc, enc_wall, enc_dev = _profiled(lambda: cli.main(
        ["encode", fq, nup, "--codec", "2bit", "--batch", str(CLI_BATCH), "--validate"]))
    check(rc == 0, f"encode --batch --validate exit {rc}")
    rc, dec_wall, dec_dev = _profiled(lambda: cli.main(["decode", nup, fa, "--batch", str(CLI_BATCH)]))
    check(rc == 0, f"decode --batch exit {rc}")
    want = _fasta((name, _upper_t_np(np.frombuffer(s, np.uint8).copy()).tobytes()) for name, s in records)
    with open(fa, "rb") as f:
        check(f.read() == want, "decoded FASTA != upper(input) with U->T")
    rc = cli.main(["encode", fq, nup_oracle, "--codec", "2bit", "--tier", "oracle"])
    check(rc == 0, f"encode --tier oracle exit {rc}")
    with open(nup, "rb") as a, open(nup_oracle, "rb") as b:
        check(a.read() == b.read(), ".nup of encode --batch differs from the per-record oracle's")
    say(f"phase 5 cli: {CLI_READS} x {CLI_READ_NT} nt FASTQ -> encode --batch {CLI_BATCH} --validate "
        f"-> decode --batch {CLI_BATCH} == input; .nup == oracle's ({time.perf_counter() - t0:.1f} s "
        f"with the checks)")
    say(f"  encode --batch {CLI_BATCH} --validate: {_breakdown(enc_wall, enc_dev)}")
    say(f"  decode --batch {CLI_BATCH}: {_breakdown(dec_wall, dec_dev)}")
    return records


def phase_cli_b5(rng, workdir: str) -> list[tuple[bytes, bytes]]:
    from cute_nucleotides_tpu_torch import cli

    t0 = time.perf_counter()
    fq = os.path.join(workdir, "reads_b5.fq")
    nup, nup_oracle, fa, bad_nup, bad_fa = (os.path.join(workdir, f) for f in (
        "reads_b5.nup", "oracle_b5.nup", "reads_b5.fa", "bad_b5.nup", "bad_b5.fa"))
    records = _write_fastq(fq, rng, b"ACGTN")
    batch = ["--batch", str(CLI_BATCH)]
    rc, enc_wall, enc_dev = _profiled(lambda: cli.main(
        ["encode", fq, nup, "--codec", "base5", *batch, "--validate"]))
    check(rc == 0, f"encode --codec base5 --batch --validate exit {rc}")
    rc, dec_wall, dec_dev = _profiled(lambda: cli.main(["decode", nup, fa, *batch, "--verify-stream"]))
    check(rc == 0, f"base-5 decode --batch --verify-stream exit {rc}")
    with open(fa, "rb") as f:
        check(f.read() == _fasta(records), "base-5 decoded FASTA != input")
    rc = cli.main(["encode", fq, nup_oracle, "--codec", "base5", "--tier", "oracle"])
    check(rc == 0, f"encode --codec base5 --tier oracle exit {rc}")
    with open(nup, "rb") as a, open(nup_oracle, "rb") as b:
        check(a.read() == b.read(), "base-5 .nup of encode --batch differs from the per-record oracle's")
    # one corrupt word (triplet 3 reads 127) in one record: refused, named
    codec, entries = cli.read_nup(nup)
    k, j = int(rng.integers(0, CLI_READS)), int(rng.integers(0, 6))
    words = [w.copy() for _, _, w in entries]
    words[k][j] |= np.uint64(0x7F << 21)
    cli.write_nup(bad_nup, [e[0] for e in entries], words, [e[1] for e in entries], codec)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["decode", bad_nup, bad_fa, *batch, "--verify-stream"])
    msg = err.getvalue().strip()
    check(rc == 1, f"decode --verify-stream of a corrupt .nup exit {rc}")
    check(msg == f"error: corrupt base-5 word {j} in record read{k}", f"corrupt .nup message: {msg!r}")
    check(not os.path.exists(bad_fa), "decode of a corrupt .nup left an output file")
    say(f"phase 5 base-5 cli: {CLI_READS} x {CLI_READ_NT} nt ACGTN FASTQ -> encode --codec base5 "
        f"--batch {CLI_BATCH} --validate -> decode --batch {CLI_BATCH} --verify-stream == input; "
        f".nup == oracle's; one corrupt word refused ({msg!r}) ({time.perf_counter() - t0:.1f} s "
        f"with the checks)")
    say(f"  encode --codec base5 --batch {CLI_BATCH} --validate: {_breakdown(enc_wall, enc_dev)}")
    say(f"  decode --batch {CLI_BATCH} --verify-stream: {_breakdown(dec_wall, dec_dev)}")
    return records


def _revcomp(pattern: bytes) -> bytes:
    """Reverse complement of a grep pattern; the wildcard ? keeps its place."""
    return pattern[::-1].translate(bytes.maketrans(b"ACGTN", b"TGCAN"))


def _find_all(hay: bytes, needle: bytes) -> list[int]:
    out, i = [], hay.find(needle)
    while i >= 0:
        out.append(i)
        i = hay.find(needle, i + 1)
    return out


def _count_rows(seqs: np.ndarray, pattern: bytes, wildcard: int) -> np.ndarray:
    """Occurrences of pattern in each row of u8[R, L], by a byte compare."""
    k, L = len(pattern), seqs.shape[1]
    ok = np.ones((seqs.shape[0], L - k + 1), dtype=bool)
    for j, c in enumerate(pattern):
        if c != wildcard:
            ok &= seqs[:, j : j + L - k + 1] == c
    return ok.sum(1)


def _run_cli(argv) -> tuple[int, str, float, dict]:
    from cute_nucleotides_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, wall, dev = _profiled(lambda: cli.main(argv))
    return rc, out.getvalue(), wall, dev


def phase_grep(rng, workdir: str, reads2: list, reads5: list) -> None:
    """``grep --both`` on one chr1-length record per codec, with a 45-nt query
    planted on both strands, and ``grep --count --both --batch`` on the
    200,000-read files; every expected line comes from a numpy scan of the
    ASCII bytes."""
    from cute_nucleotides_tpu_torch import api, cli

    for label, codec, alpha, encode in (("2-bit", "2bit", b"ACGT", api.n_to_bits),
                                        ("base-5", "base5", b"ACGTN", api.n_to_bits2)):
        t0 = time.perf_counter()
        a = np.frombuffer(alpha, np.uint8)
        seq = a[rng.integers(0, len(a), CHR1_NT, dtype=np.uint8)]
        query = bytearray(rng.choice(a[:4], 45).tobytes())
        if codec == "base5":
            query[10] = query[30] = ord("N")  # a literal N on base-5
        query = bytes(query)
        span = CHR1_NT // 12
        for i in range(12):  # six planted per strand, one at each end
            start = 0 if i == 0 else CHR1_NT - 45 if i == 11 else i * span + int(rng.integers(0, span - 45))
            seq[start : start + 45] = np.frombuffer(query if i % 2 == 0 else _revcomp(query), np.uint8)
        nup = os.path.join(workdir, f"chr1_{codec}.nup")
        cli.write_nup(nup, [b"chr1"], [encode(seq)], [CHR1_NT], codec)
        hay = seq.tobytes()
        want = sorted([(p, "+") for p in _find_all(hay, query)] + [(p, "-") for p in _find_all(hay, _revcomp(query))])
        check(sum(s == "+" for _, s in want) >= 6 and sum(s == "-" for _, s in want) >= 6,
              f"{label}: the planted hits are not in the byte scan")
        rc, text, wall, dev = _run_cli(["grep", nup, query.decode(), "--both"])
        got = [json.loads(line) for line in text.splitlines()]
        check(rc == 0, f"{label} grep --both exit {rc}")
        check(got == [{"record": "chr1", "pos": p, "strand": st} for p, st in want],
              f"{label} grep --both hits {got[:4]}... != byte scan {want[:4]}...")
        say(f"phase 5 grep {label}: one {CHR1_NT}-nt record, 45-nt query {query.decode()} --both: "
            f"{len(got)} hits == numpy byte scan ({time.perf_counter() - t0:.1f} s with the checks)")
        say(f"  grep --both, chr1 length, {label}: {_breakdown(wall, dev)}; top device events (ms) "
            f"{dev['top']}")
        del seq, hay
    for label, nup, records, pattern, wildcard in (
            ("2-bit", "reads.nup", reads2, b"GANTACA", ord("N")),
            ("base-5", "reads_b5.nup", reads5, b"GAT?AN", ord("?"))):
        t0 = time.perf_counter()
        seqs = np.frombuffer(b"".join(seq for _, seq in records), np.uint8).reshape(len(records), -1)
        seqs = _upper_t_np(seqs.copy())
        fwd, rev = _count_rows(seqs, pattern, wildcard), _count_rows(seqs, _revcomp(pattern), wildcard)
        want = "".join(json.dumps({"record": name.decode(), "fwd": int(f), "rev": int(r)}) + "\n"
                       for (name, _), f, r in zip(records, fwd, rev))
        rc, text, wall, dev = _run_cli(["grep", os.path.join(workdir, nup), pattern.decode(), "--count", "--both",
                                     "--batch", str(CLI_BATCH)])
        check(rc == 0, f"{label} grep --count --batch exit {rc}")
        check(text == want, f"{label} grep --count --both --batch: output != numpy byte counts")
        say(f"phase 5 grep {label}: --count --both --batch {CLI_BATCH} on {len(records)} x {CLI_READ_NT} nt, "
            f"pattern {pattern.decode()}: {int(fwd.sum())} + {int(rev.sum())} hits == numpy byte counts "
            f"({time.perf_counter() - t0:.1f} s with the checks)")
        say(f"  grep --count --both --batch {CLI_BATCH}, {label}: {_breakdown(wall, dev)}; top device "
            f"events (ms) {dev['top']}")


# --- the k-mer path: phases 3-5 -------------------------------------------------

@contextlib.contextmanager
def _plain_kmer_kernels():
    """Inside, ``ops.kmer`` (and ``ops.sketch`` through it) runs the plain
    versions of #10-#14: the same function built from the plain versions,
    which the path's output is held to.  The wrappers are back on exit."""
    import types

    from cute_nucleotides_tpu_torch.ops import kernels as K, kmer

    saved = kmer.kernels
    kmer.kernels = types.SimpleNamespace(
        kmer_codes_planar=K.kmer_codes_planar_plain, kmer_codes_planar_pair=K.kmer_codes_planar_pair_plain,
        hist_codes=K.hist_codes_plain, kmer_hashes_planar_pair=K.kmer_hashes_planar_pair_plain,
        minimizer_bits_stream=K.minimizer_bits_stream_plain)
    try:
        yield
    finally:
        kmer.kernels = saved


def phase_kmer_batch(errors: Errors, words) -> None:
    """``kmer_histogram_batch(k=8, canonical=True)`` on the 1-Gnt batch's
    words u32[4096, 16384]: 1.07 G codes through #10 and #13."""
    import torch

    from cute_nucleotides_tpu_torch.ops import kmer

    k = 8
    t0 = time.perf_counter()
    hist = kmer.kmer_histogram_batch(words, BATCH_NT, k, canonical=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with _plain_kmer_kernels():
        want = kmer.kmer_histogram_batch(words, BATCH_NT, k, canonical=True)
    errors.compare("hist_codes", hist, want, "kmer_histogram_batch k=8 canonical vs its plain-built twin")
    total = int(hist.to(torch.int64).sum())
    check(total == BATCH_ROWS * (BATCH_NT - k + 1), f"kmer_histogram_batch mass {total}")
    del want
    torch.cuda.empty_cache()
    say(f"phase 3 k-mer batch: kmer_histogram_batch(u32{tuple(words.shape)}, {BATCH_NT}, k=8, canonical) == "
        f"its plain-built twin; mass {total} == {BATCH_ROWS} x ({BATCH_NT} - 7) ({wall:.3f} s wall)")


def _chr1_words():
    """A random 2-bit chr1-length stream on the card: u32[cdiv(CHR1_NT, 16)],
    the bits past the last nt zero ('A' padding, as the encoder leaves it)."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 21)
    nw = -(-CHR1_NT // 16)
    w = torch.randint(0, 1 << 32, (nw,), dtype=torch.int64, device="cuda", generator=g).to(torch.int32)
    if CHR1_NT % 16:
        w[-1] &= (1 << (2 * (CHR1_NT % 16))) - 1
    return w.view(torch.uint32)


def phase_kmer_chr1(errors: Errors):
    """``kmer_histogram(k=8)``, ``kmer_counts(k=15)`` and ``kmer_counts(k=21,
    canonical=True)`` on a chr1-length stream, each under torch.profiler and
    against its plain-built twin; the mass of each is length - k + 1."""
    import torch

    from cute_nucleotides_tpu_torch.ops import kmer

    w = _chr1_words()
    runs = (("kmer_histogram k=8", "hist_codes", 8, lambda: kmer.kmer_histogram(w, CHR1_NT, 8)),
            ("kmer_counts k=15", "kmer_codes_planar", 15, lambda: kmer.kmer_counts(w, CHR1_NT, 15)),
            ("kmer_counts k=21 canonical", "kmer_codes_planar_pair", 21,
             lambda: kmer.kmer_counts(w, CHR1_NT, 21, canonical=True)))
    for label, kname, k, fn in runs:
        got, wall, dev = _profiled(fn)
        with _plain_kmer_kernels():
            want = fn()
        parts = got if isinstance(got, tuple) else (got,)
        for i, (a, b) in enumerate(zip(parts, want if isinstance(want, tuple) else (want,))):
            errors.compare(kname, a, b, f"chr1 {label} output {i} vs its plain-built twin")
        mass = int(parts[-1].to(torch.int64).sum())
        check(mass == CHR1_NT - k + 1, f"chr1 {label}: mass {mass} != {CHR1_NT - k + 1}")
        extra = f", {int((parts[-1] > 0).sum())} distinct" if len(parts) == 3 else ""
        say(f"phase 4 k-mer chr1: {label} on {CHR1_NT} nt == its plain-built twin; mass {mass}{extra}")
        say(f"  {label}, chr1 length: {_breakdown(wall, dev)}; top device events (ms) {dev['top']}")
        del got, want, parts
        torch.cuda.empty_cache()
    return w


def _nt_codes(seq: np.ndarray) -> np.ndarray:
    """2-bit codes of ASCII bytes ((b >> 1) & 3: A, C, T, G = 0..3)."""
    return (seq >> 1) & 3


def _kmers_np(c: np.ndarray, k: int, canonical: bool) -> np.ndarray:
    """k-mer codes of code rows c[..., L] (first nt in the low bits), and with
    ``canonical`` the min with the reverse complement (complement: c ^ 2)."""
    dt = np.uint16 if k <= 8 else np.uint32 if k <= 15 else np.uint64
    n = c.shape[-1] - k + 1
    fwd = np.zeros(c.shape[:-1] + (n,), dt)
    rc = np.zeros_like(fwd)
    for j in range(k):
        part = c[..., j : j + n].astype(dt)
        if canonical:
            rc |= np.left_shift(part ^ dt(2), dt(2 * (k - 1 - j)))
        fwd |= np.left_shift(part, dt(2 * j), out=part)
    return np.minimum(fwd, rc, out=fwd) if canonical else fwd


def _stats_expected(seqs: list[np.ndarray], k: int, top: int, canonical: bool) -> str:
    """The reference CLI's ``stats`` line, counted from the ASCII bytes; a
    2-D entry of ``seqs`` holds one record per row."""
    total = sum(s.size for s in seqs)
    comp = sum(np.bincount(_nt_codes(s).ravel(), minlength=4) for s in seqs)
    out = {"records": sum(s.shape[0] if s.ndim == 2 else 1 for s in seqs), "nt": total, "gc_fraction": round(int(comp[1] + comp[3]) / max(total, 1), 6),
           "composition": dict(zip("ACTG", (int(c) for c in comp))), "k": k, "canonical": canonical}

    def word(c: int) -> str:
        return "".join("ACTG"[(c >> (2 * j)) & 3] for j in range(k))

    codes = np.concatenate([_kmers_np(_nt_codes(s), k, canonical).ravel() for s in seqs if s.shape[-1] >= k])
    if k > 12:
        uniq, cnt = np.unique(codes, return_counts=True)  # ascending codes: the dict's order
        out["distinct_kmers"] = int(uniq.size)
        order = np.argsort(-cnt, kind="stable")[:top]
        out["top_kmers"] = [{"kmer": word(int(uniq[i])), "count": int(cnt[i])} for i in order]
    else:
        hist = np.bincount(codes, minlength=4**k).astype(np.int32)
        out["top_kmers"] = [{"kmer": word(int(c)), "count": int(hist[c])}
                            for c in np.argsort(hist)[::-1][:top] if hist[c] > 0]
    return json.dumps(out) + "\n"


def _write_fasta_record(path: str, name: bytes, seq: np.ndarray) -> None:
    full = seq.size // 80 * 80
    lines = np.concatenate([seq[:full].reshape(-1, 80), np.full((full // 80, 1), ord("\n"), np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(b">" + name + b"\n")
        f.write(lines.tobytes())
        if seq.size > full:
            f.write(seq[full:].tobytes() + b"\n")


def _chr1_fasta(rng, workdir: str) -> np.ndarray:
    """A random chr1-length record over ACGTacgt, written to chr1.fa in
    ``workdir`` (the FASTA that ``stats`` and ``sketch`` read)."""
    chr1 = np.frombuffer(b"ACGTacgt", np.uint8)[rng.integers(0, 8, CHR1_NT, dtype=np.uint8)]
    _write_fasta_record(os.path.join(workdir, "chr1.fa"), b"chr1", chr1)
    return chr1


def phase_stats(rng, workdir: str, reads2: list, chr1: np.ndarray) -> None:
    """``stats`` through the CLI, under torch.profiler, each stdout against
    :func:`_stats_expected`: the chr1-length FASTA record ``chr1`` (-k 8
    --canonical --top 10), the first STATS_READS phase-5 reads as a .nup (-k 8),
    and a 4-Mnt record with a planted 30-nt repeat (-k 21 --canonical --top
    10)."""
    from cute_nucleotides_tpu_torch import api, cli

    prefix = reads2[:STATS_READS]
    cli.write_nup(os.path.join(workdir, "stats_reads.nup"), [n for n, _ in prefix],
                  [api.n_to_bits(s, tier="oracle") for _, s in prefix], [len(s) for _, s in prefix], "2bit")
    rec = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, STATS_REC_NT, dtype=np.uint8)]
    motif = rec[:30].copy()
    for i in range(1, 26):  # the first 30 nt again 25 times: their 21-mers count 26
        rec[i * (STATS_REC_NT // 26) : i * (STATS_REC_NT // 26) + 30] = motif
    _write_fasta_record(os.path.join(workdir, "rec.fa"), b"rec", rec)
    reads = np.frombuffer(b"".join(s for _, s in prefix), np.uint8).reshape(len(prefix), -1)
    runs = (("chr1.fa", ["-k", "8", "--canonical", "--top", "10"], [chr1], 8, 10, True),
            ("stats_reads.nup", ["-k", "8"], [reads], 8, 5, False),
            ("rec.fa", ["-k", "21", "--canonical", "--top", "10"], [rec], 21, 10, True))
    for name, args, seqs, k, top, canonical in runs:
        t0 = time.perf_counter()
        rc, text, wall, dev = _run_cli(["stats", os.path.join(workdir, name), *args])
        check(rc == 0, f"stats {name} exit {rc}")
        want = _stats_expected(seqs, k, top, canonical)
        check(text == want, f"stats {name} {' '.join(args)}: {text[:300]!r} != numpy {want[:300]!r}")
        say(f"phase 5 stats {name} {' '.join(args)}: stdout == numpy count of the bytes "
            f"({time.perf_counter() - t0:.1f} s with the checks): {text.strip()[:200]}")
        say(f"  stats {name}: {_breakdown(wall, dev)}; top device events (ms) {dev['top']}")


# --- the sketch path: phases 4 and 5 ----------------------------------------------

PROFILE_SKETCH_CHR1 = "--profile-sketch-chr1"


def _sketch_chr1_runs(w) -> tuple:
    """(label, kernel, call) of the phase-4 sketch calls on the chr1-length
    stream ``w``."""
    from cute_nucleotides_tpu_torch.ops import kmer, sketch

    k12, k14 = SKETCH_KERNELS
    k, s, scale, cap = SKETCH_K, SKETCH_S, SKETCH_SCALE, SKETCH_CAP
    return (("bottom_k_sketch k=21 s=1000", k12, lambda: sketch.bottom_k_sketch(w, CHR1_NT, k, s)),
            ("frac_sketch k=21 scale=1000", k12, lambda: sketch.frac_sketch(w, CHR1_NT, k, scale=scale, cap=cap)),
            ("minimizers k=15 w=10", k14, lambda: kmer.minimizers(w, CHR1_NT, 15, 10)),
            ("minimizer_bits k=15 w=10", k14, lambda: kmer.minimizer_bits(w, CHR1_NT, 15, 10)),
            ("kmer_hashes_planar k=21", k12, lambda: kmer.kmer_hashes_planar(w, CHR1_NT, k)))


def profile_sketch_chr1() -> int:
    """The phase-4 sketch calls under torch.profiler in this (fresh) process,
    each once to warm up (a kernel's first launch loads its module) and once
    profiled; prints one breakdown line per call."""
    import torch

    try:
        w = _chr1_words()
        for label, _, fn in _sketch_chr1_runs(w):
            fn()
            torch.cuda.synchronize()
            _, wall, dev = _profiled(fn)
            say(f"  {label}, chr1 length (fresh process): {_breakdown(wall, dev)}; "
                f"top device events (ms) {dev['top']}")
            torch.cuda.empty_cache()
    except Exception:
        traceback.print_exc()
        return 1
    return 0


def phase_sketch_chr1(errors: Errors, w) -> None:
    """``sketch.bottom_k_sketch(k=21, s=1000)``, ``sketch.frac_sketch(k=21,
    scale=1000, cap=2^19)``, ``kmer.minimizers(k=15, w=10)``,
    ``kmer.minimizer_bits(k=15, w=10)`` and ``kmer.kmer_hashes_planar(k=21)``
    on the chr1-length stream, each against its plain-built twin; then the
    sketches' and minimizers' own invariants.  The same calls are profiled
    in a child process (:func:`profile_sketch_chr1`): this process has run
    large profiles by now, after which the profiler loses short calls'
    device events."""
    import torch

    from cute_nucleotides_tpu_torch.ops import kmer

    k, s, scale, cap = SKETCH_K, SKETCH_S, SKETCH_SCALE, SKETCH_CAP
    out = {}
    for label, kname, fn in _sketch_chr1_runs(w):
        got = fn()
        with _plain_kmer_kernels():
            want = fn()
        parts, wparts = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for i, (a, b) in enumerate(zip(parts, wparts)):
            errors.compare(kname, a, b, f"chr1 {label} output {i} vs its plain-built twin")
        out[label] = got
        del want, wparts
        torch.cuda.empty_cache()
    child = subprocess.run([sys.executable, os.path.abspath(__file__), PROFILE_SKETCH_CHR1],
                           capture_output=True, text=True, timeout=600)
    for line in child.stdout.splitlines():
        say(line)
    check(child.returncode == 0, f"the chr1 sketch profile exited {child.returncode}: {child.stderr[-2000:]}")
    bottom = _i64(out["bottom_k_sketch k=21 s=1000"])
    frac, n_kept = out["frac_sketch k=21 scale=1000"]
    frac, n_kept = _i64(frac), int(n_kept)
    check(bottom.shape == (s,) and bool((bottom[1:] > bottom[:-1]).all()) and int(bottom[-1]) < SENTINEL,
          "bottom-s sketch: not 1000 distinct ascending hashes")
    check(0 < n_kept < cap and int((frac < SENTINEL).sum()) == n_kept and int(frac[n_kept - 1]) < 2**32 // scale,
          f"frac sketch: {n_kept} kept, buffer {int((frac < SENTINEL).sum())}")
    check(torch.equal(frac[:s], bottom), "the 1000 least of the frac sketch != the bottom-s sketch")
    n = CHR1_NT - 15 + 1
    mask, h = out["minimizers k=15 w=10"]
    bits = out["minimizer_bits k=15 w=10"]
    check(mask.shape == (n,) and h.shape == (n,) and bits.shape == (-(-n // 16),), "minimizer shapes")
    check(torch.equal(kmer._unpack_bits(bits, n), mask), "minimizer_bits != the packed minimizers mask")
    density = float(mask.sum()) / n
    check(0.17 < density < 0.19, f"minimizer density {density:.4f}, expected about 2 / (w + 1) = 0.1818")
    hp = out["kmer_hashes_planar k=21"]
    # every valid k-mer's slot, but for the 0.06 k-mers expected to hash to 0xFFFFFFFF
    valid = int((hp.view(torch.int32) != -1).sum())
    check(CHR1_NT - k + 1 - 3 <= valid <= CHR1_NT - k + 1, f"planar hashes: {valid} valid slots")
    say(f"phase 4 sketch chr1: bottom_k_sketch, frac_sketch ({n_kept} distinct hashes kept; its {s} least == the "
        f"bottom-s sketch), minimizers and minimizer_bits (density {density:.4f}) and kmer_hashes_planar on "
        f"{CHR1_NT} nt == their plain-built twins")


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _kmer_hashes_np(seqs: np.ndarray, k: int) -> np.ndarray:
    """The canonical k-mer hashes (16 <= k <= 31) of the rows of ASCII
    u8[R, L] whose k-mers touch no byte outside ACGTUacgtu, flattened."""
    codes = _kmers_np(_nt_codes(seqs), k, True)
    bad = ~np.isin(seqs, np.frombuffer(ALPHABET, np.uint8))
    cs = np.concatenate([np.zeros((seqs.shape[0], 1), np.int32), np.cumsum(bad, axis=1, dtype=np.int32)], axis=1)
    c = codes[cs[:, k:] == cs[:, :-k]]
    return _fmix32_np((c & 0xFFFFFFFF).astype(np.uint32) ^ _fmix32_np((c >> 32).astype(np.uint32)))


def _first_distinct(h: np.ndarray, s: int) -> np.ndarray:
    """The s least distinct values of h, padded with SENTINEL.  The 8 s least
    elements (np.partition) hold every value below the (8 s)-th; when s of
    those are distinct they are the answer, else the whole of h is sorted."""
    m = 8 * s
    if h.size > m:
        part = np.partition(h, m)
        u = np.unique(part[:m][part[:m] < part[m]])
        if u.size >= s:
            return u[:s]
    u = np.unique(h)[:s]
    return np.concatenate([u, np.full(s - u.size, SENTINEL, np.uint32)])


def _ratio_np(num: np.ndarray, den: np.ndarray) -> float:
    return float(np.float32(num.sum()) / np.float32(max(int(den.sum()), 1)))


def _sketch_expected(datasets, k: int, s: int, scale: int) -> tuple[str, str]:
    """The reference CLI's ``sketch`` stdout and stderr for (path, records,
    nt, hashes) datasets, computed with numpy: Mash's Jaccard over the
    bottom-s of the union, containment, the Mash distance."""
    sketches, rows, err = [], [], ""
    for path, records, nt, h in datasets:
        sk = _first_distinct(h[h < min(2**32 // scale, SENTINEL)] if scale else h, s)
        row = {"path": path, "records": records, "nt": nt, "hashes": int((sk != SENTINEL).sum())}
        if scale:
            row["saturated"] = row["hashes"] >= s
            if row["saturated"]:
                err += (f"warning: {path}: FracMinHash buffer saturated at {s} hashes — containment/Jaccard "
                        f"will be underestimated; raise -s or --scale\n")
        sketches.append(sk)
        rows.append(row)
    out = {"k": k, "scheme": {"name": "fracminhash", "scale": scale, "cap": s} if scale else {"name": "bottom-s", "s": s},
           "canonical": True, "datasets": rows}
    pairs = []
    for i in range(len(datasets)):
        for j in range(i + 1, len(datasets)):
            sa, sb = sketches[i], sketches[j]
            u = _first_distinct(np.concatenate([sa, sb]), s)
            valid = u != SENTINEL
            jac = _ratio_np(np.isin(u, sa) & np.isin(u, sb) & valid, valid)
            dist = 1.0 if jac <= 0 else min(-math.log(2.0 * jac / (1.0 + jac)) / k, 1.0)
            cont = [_ratio_np(np.isin(x, y) & (x != SENTINEL), x != SENTINEL) for x, y in ((sa, sb), (sb, sa))]
            pairs.append({"a": datasets[i][0], "b": datasets[j][0], "jaccard": round(jac, 6),
                          "mash_distance": round(dist, 6), "containment_a_in_b": round(cont[0], 6),
                          "containment_b_in_a": round(cont[1], 6)})
    if pairs:
        out["pairs"] = pairs
    return json.dumps(out) + "\n", err


def _mutated(rng, seqs: np.ndarray) -> np.ndarray:
    """The reads with 1% substitutions (another base of ACGT) and an N in
    every 50th read."""
    out = seqs.copy()
    hit = rng.random(out.shape) < 0.01
    codes = np.frombuffer(b"ACGT", np.uint8)
    out[hit] = codes[(np.searchsorted(codes, _upper_t_np(out[hit].copy())) + rng.integers(1, 4, int(hit.sum()))) % 4]
    out[::50, 75] = ord("N")
    return out


@contextlib.contextmanager
def _recording(module, name: str, into: list):
    """Inside, each result of ``module.name`` is also appended to ``into``."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        into.append(fn(*args, **kwargs))
        return into[-1]

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def phase_sketch_cli(rng, workdir: str, reads2: list, chr1: np.ndarray) -> None:
    """``sketch`` through the CLI, under torch.profiler: the phase-5 reads
    against a copy with 1% substitutions and some N (``-k 21 -s 1000``, then
    ``--scale 200 -s 65536``), each stdout and stderr against a numpy
    sketch of the bytes; and the chr1-length FASTA (``chr1``) with
    ``--batch 1``, its dataset sketch against ``sketch.bottom_k_sketch`` of
    the same sequence's words."""
    import torch

    from cute_nucleotides_tpu_torch import api, cli, interop
    from cute_nucleotides_tpu_torch.ops import sketch

    t0 = time.perf_counter()
    reads = np.frombuffer(b"".join(seq for _, seq in reads2), np.uint8).reshape(len(reads2), -1)
    mut = _mutated(rng, reads)
    fq, mfq = os.path.join(workdir, "reads.fq"), os.path.join(workdir, "mutated.fq")
    qual = b"I" * CLI_READ_NT
    with open(mfq, "wb") as f:
        f.write(b"".join(b"@%s\n%s\n+\n%s\n" % (name, mut[i].tobytes(), qual) for i, (name, _) in enumerate(reads2)))
    hashes = [_kmer_hashes_np(x, SKETCH_K) for x in (reads, mut)]
    datasets = [(p, len(reads2), reads.size, h) for p, h in zip((fq, mfq), hashes)]
    modes = [(["-s", str(SKETCH_S)], SKETCH_S, 0), (["--scale", "200", "-s", "65536"], 65536, 200)]
    expected = [_sketch_expected(datasets, SKETCH_K, s, scale) for _, s, scale in modes]
    say(f"phase 5 sketch: {len(reads2)} x {CLI_READ_NT} nt reads and a mutated copy ({int((mut != reads).sum())} "
        f"bytes changed), numpy sketches {time.perf_counter() - t0:.1f} s")
    for (opts, _, _), (want, want_err) in zip(modes, expected):
        t0 = time.perf_counter()
        argv = ["sketch", fq, mfq, "-k", str(SKETCH_K), *opts]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, text, wall, dev = _run_cli(argv)
        check(rc == 0, f"{' '.join(argv[3:])} exit {rc}")
        check(text == want, f"sketch {' '.join(opts)}: {text[:400]!r} != numpy {want[:400]!r}")
        check(err.getvalue() == want_err, f"sketch {' '.join(opts)} stderr {err.getvalue()!r} != {want_err!r}")
        say(f"phase 5 sketch reads.fq mutated.fq -k {SKETCH_K} {' '.join(opts)}: stdout and stderr == numpy "
            f"({time.perf_counter() - t0:.1f} s with the checks): {json.dumps(json.loads(text)['pairs'])}")
        say(f"  sketch {' '.join(opts)}: {_breakdown(wall, dev)}; top device events (ms) {dev['top']}")
    t0 = time.perf_counter()
    fa = os.path.join(workdir, "chr1.fa")
    seen: list = []
    with _recording(sketch, "bottom_k_sketch_batch", seen):
        rc, text, wall, dev = _run_cli(["sketch", fa, "-k", str(SKETCH_K), "-s", str(SKETCH_S), "--batch", "1"])
    check(rc == 0, f"sketch chr1.fa --batch 1 exit {rc}")
    row = json.loads(text)["datasets"][0]
    check(row == {"path": fa, "records": 1, "nt": CHR1_NT, "hashes": SKETCH_S}, f"sketch chr1.fa: {row}")
    words = interop.u64_to_tensor(api.n_to_bits(chr1, tier="oracle"), "cuda")
    want = sketch.bottom_k_sketch(words, CHR1_NT, SKETCH_K, SKETCH_S)
    check(len(seen) == 1 and torch.equal(_i64(seen[0]), _i64(want)),
          "sketch chr1.fa --batch 1: its sketch != bottom_k_sketch of the sequence's words")
    say(f"phase 5 sketch chr1.fa --batch 1: {text.strip()}; its sketch == bottom_k_sketch of the same words "
        f"({time.perf_counter() - t0:.1f} s with the checks)")
    say(f"  sketch chr1.fa --batch 1: {_breakdown(wall, dev)}; top device events (ms) {dev['top']}")


# --- the seqops path: phases 3-5 ----------------------------------------------------

def _gc_bytes(x) -> int:
    """C and G bytes (either case) of a u8 tensor, counted on its device."""
    u = x & 0xDF
    return int(((u == ord("C")) | (u == ord("G"))).sum())


def phase_gc_b5(x5, words5) -> None:
    """``seqops.gc_content_packed_b5`` (kernel #7's route) on the phase-3
    base-5 batch's words flattened, then on a chr1-length base-5 stream
    encoded on the card, each under torch.profiler and against a count of
    the C and G bytes on the card."""
    import torch

    from cute_nucleotides_tpu_torch.ops import kernels as K, seqops

    flat = words5.view(-1)
    got, wall, dev = _profiled(lambda: seqops.gc_content_packed_b5(flat))
    want = _gc_bytes(x5)
    check(int(got) == want, f"gc_content_packed_b5 of the base-5 batch {int(got)} != {want} C and G bytes")
    say(f"phase 3 seqops: gc_content_packed_b5 of the base-5 batch's {flat.numel() // 2} words == {want} C and G "
        f"bytes of u8{tuple(x5.shape)}")
    say(f"  gc_content_packed_b5, base-5 batch: {_breakdown(wall, dev)}")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 27)
    nw = -(-CHR1_NT // 27)
    x = torch.full((27 * nw,), ord("A"), dtype=torch.uint8, device="cuda")
    lut = torch.tensor(list(b"ACGTNacgtn"), dtype=torch.uint8, device="cuda")
    x[:CHR1_NT] = lut[torch.randint(0, len(lut), (CHR1_NT,), generator=g, device="cuda")]
    w = K.encode_b5_stream(x)
    got, wall, dev = _profiled(lambda: seqops.gc_content_packed_b5(w))
    want = _gc_bytes(x)
    check(int(got) == want, f"gc_content_packed_b5 of the chr1-length stream {int(got)} != {want}")
    say(f"phase 4 seqops: gc_content_packed_b5 of a chr1-length base-5 stream ({nw} words) == {want} C and G bytes")
    say(f"  gc_content_packed_b5, chr1 length: {_breakdown(wall, dev)}")
    del x, w
    torch.cuda.empty_cache()


def phase_region(rng, workdir: str) -> None:
    """``region`` on a chr1-length record of each codec: windows at the
    first bytes, across word seams, over 1 Mnt, at the record's end and
    empty, as FASTA (against the bytes) and ``--packed`` (each window's
    words against the host oracle's encoding of its bytes)."""
    from cute_nucleotides_tpu_torch import api, cli

    for label, codec, alpha, encode, per in (("2-bit", "2bit", b"ACGTacgt", api.n_to_bits, 32),
                                             ("base-5", "base5", b"ACGTNacgtn", api.n_to_bits2, 27)):
        t0 = time.perf_counter()
        a = np.frombuffer(alpha, np.uint8)
        seq = a[rng.integers(0, len(a), CHR1_NT, dtype=np.uint8)]
        nup, fa, packed = (os.path.join(workdir, f"region_{codec}{ext}") for ext in (".nup", ".fa", "_win.nup"))
        cli.write_nup(nup, [b"chr1"], [encode(seq)], [CHR1_NT], codec)
        mid = CHR1_NT // 2
        windows = [(0, 100), (per - 1, 3 * per + 2), (7 * per, 9 * per), (mid - 3, mid + (1 << 20) + 5),
                   (CHR1_NT - 1000, CHR1_NT), (5, 5)]
        regions = [f"chr1:{s}-{e}" for s, e in windows]
        rc, _, wall, dev = _run_cli(["region", nup, *regions, "-o", fa])
        check(rc == 0, f"{label} region exit {rc}")
        up = _upper_t_np(seq.copy())
        with open(fa, "rb") as f:
            check(f.read() == _fasta((r.encode(), up[s:e].tobytes()) for r, (s, e) in zip(regions, windows)),
                  f"{label} region FASTA != the windows of the bytes")
        rc, _, pwall, pdev = _run_cli(["region", nup, *regions, "--packed", "-o", packed])
        check(rc == 0, f"{label} region --packed exit {rc}")
        got_codec, entries = cli.read_nup(packed)
        check(got_codec == codec and [(n, ln) for n, ln, _ in entries] == [(r.encode(), e - s) for r, (s, e) in
                                                                           zip(regions, windows)],
              f"{label} region --packed records")
        for (s, e), (_, _, words) in zip(windows, entries):
            check(np.array_equal(words, encode(seq[s:e], tier="oracle")), f"{label} region --packed {s}-{e} words")
        say(f"phase 5 region {label}: {len(windows)} windows of a {CHR1_NT}-nt record (word seams, "
            f"{windows[3][1] - windows[3][0]} nt, the end, empty) == the bytes; --packed == the oracle's words "
            f"({time.perf_counter() - t0:.1f} s with the checks)")
        say(f"  region, {label}: {_breakdown(wall, dev)}")
        say(f"  region --packed, {label}: {_breakdown(pwall, pdev)}")


_AMINO = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"  # NCBI table 1, TCAG order


def _translate_np(seq: np.ndarray, frame: int) -> bytes:
    """The EMBOSS-numbered frame (1..3, -1..-3) of ASCII bytes translated by
    the standard code; a codon with N is X."""
    index = np.full(256, 4, np.uint8)  # N and anything else
    for i, c in enumerate(b"TCAG"):
        index[c] = index[c | 0x20] = i
    if frame < 0:
        seq = _upper_t_np(seq.copy())[::-1].copy()
        seq = np.frombuffer(seq.tobytes().translate(bytes.maketrans(b"ACGTN", b"TGCAN")), np.uint8)
    off = abs(frame) - 1
    n_cod = (seq.size - off) // 3
    d = index[seq[off : off + 3 * n_cod]].reshape(-1, 3).astype(np.int64)
    aa = np.frombuffer(_AMINO.encode(), np.uint8)[np.minimum(16 * d[:, 0] + 4 * d[:, 1] + d[:, 2], 63)]
    return np.where((d == 4).any(1), ord("X"), aa).astype(np.uint8).tobytes()


def phase_translate(rng, workdir: str) -> None:
    """``translate --frames all`` on a 4-Mnt record of each codec, the
    output against a numpy translation of the bytes."""
    from cute_nucleotides_tpu_torch import api, cli

    for label, codec, alpha, encode in (("2-bit", "2bit", b"ACGTacgt", api.n_to_bits),
                                        ("base-5", "base5", b"ACGTNacgtn", api.n_to_bits2)):
        t0 = time.perf_counter()
        a = np.frombuffer(alpha, np.uint8)
        rec = a[rng.integers(0, len(a), STATS_REC_NT, dtype=np.uint8)]
        nup, out = os.path.join(workdir, f"tr_{codec}.nup"), os.path.join(workdir, f"tr_{codec}.fa")
        cli.write_nup(nup, [b"rec"], [encode(rec)], [STATS_REC_NT], codec)
        rc, _, wall, dev = _run_cli(["translate", nup, out, "--frames", "all"])
        check(rc == 0, f"{label} translate exit {rc}")
        want = _fasta((b"rec|frame=%+d" % f, _translate_np(rec, f)) for f in (1, 2, 3, -1, -2, -3))
        with open(out, "rb") as f:
            check(f.read() == want, f"{label} translate --frames all != numpy's translation of the bytes")
        say(f"phase 5 translate {label}: --frames all on a {STATS_REC_NT}-nt record == numpy "
            f"({time.perf_counter() - t0:.1f} s with the checks)")
        say(f"  translate --frames all, {label}: {_breakdown(wall, dev)}")


def phase_dedup(rng, workdir: str, reads2: list, reads5: list) -> None:
    """``dedup`` on the 200,000 reads of each codec with one read in
    DEDUP_EVERY replaced by an earlier read (every other one lower-cased,
    which the codec folds), encoded by ``encode --batch``: the JSON summary
    and the kept records against a dict of first occurrences of the
    normalised bytes."""
    from cute_nucleotides_tpu_torch import cli

    for label, codec, reads in (("2-bit", "2bit", reads2), ("base-5", "base5", reads5)):
        t0 = time.perf_counter()
        recs = list(reads)
        planted = np.sort(rng.choice(np.arange(1, len(recs)), len(recs) // DEDUP_EVERY, replace=False))
        for k, i in enumerate(planted.tolist()):
            s = recs[int(rng.integers(0, i))][1]
            recs[i] = (recs[i][0], s.lower() if k % 2 else s)
        fq, nup, out = (os.path.join(workdir, f"dedup_{codec}{ext}") for ext in (".fq", ".nup", "_out.nup"))
        qual = b"I" * CLI_READ_NT
        with open(fq, "wb") as f:
            f.write(b"".join(b"@%s\n%s\n+\n%s\n" % (name, s, qual) for name, s in recs))
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["encode", fq, nup, "--codec", codec, "--batch", str(CLI_BATCH)])
        check(rc == 0, f"{label} encode --batch exit {rc}")
        rc, text, wall, dev = _run_cli(["dedup", nup, out])
        check(rc == 0, f"{label} dedup exit {rc}")
        seen, keep = set(), []
        for i, (_, s) in enumerate(recs):
            key = _upper_t_np(np.frombuffer(s, np.uint8).copy()).tobytes()
            if key not in seen:
                seen.add(key)
                keep.append(i)
        want = {"records": len(recs), "kept": len(keep), "removed": len(recs) - len(keep)}
        check(json.loads(text) == want, f"{label} dedup summary {text.strip()} != {want}")
        _, entries = cli.read_nup(nup)
        _, kept = cli.read_nup(out)
        check(len(kept) == len(keep) and all(a[0] == entries[i][0] and a[1] == entries[i][1]
                                             and np.array_equal(a[2], entries[i][2]) for a, i in zip(kept, keep)),
              f"{label} dedup kept records != the first occurrences")
        say(f"phase 5 dedup {label}: {len(recs)} reads, {len(planted)} planted duplicates: {text.strip()} == a dict "
            f"of first occurrences ({time.perf_counter() - t0:.1f} s with the checks)")
        say(f"  dedup, {label}: {_breakdown(wall, dev)}")


# --- the sort path: phase 4 --------------------------------------------------------

def _chr1_kmer_pairs(chr1_words):
    """The (hi, lo) u32 planes ``kmer_counts(k=21, canonical=True)`` sorts
    for the chr1-length stream: #11's planar codes, the canonical fold, and
    the positions past the last k-mer set to the all-ones sentinel."""
    import torch

    from cute_nucleotides_tpu_torch.ops import kernels as K, kmer

    lo, hi = K.kmer_codes_planar_pair(*kmer._panels(chr1_words, 2), SKETCH_K)
    lo, hi = kmer.canonical_codes_pair(lo, hi, SKETCH_K)
    for plane in (lo, hi):
        kmer._mask_tail(plane.view(torch.int32), CHR1_NT - SKETCH_K + 1, -1)
    return hi.reshape(-1), lo.reshape(-1)


def phase_sort_chr1(errors: Errors, chr1_words):
    """``sort.sort_pairs(hi, lo, prefer="bitonic")`` (kernel #18) on the chr1
    k = 21 canonical k-mer pairs, under torch.profiler, against
    ``prefer="lax"``; returns the pairs."""
    import torch

    from cute_nucleotides_tpu_torch.ops import sort

    hi, lo = _chr1_kmer_pairs(chr1_words)
    n0 = hi.numel()
    (hs, ls), wall, dev = _profiled(lambda: sort.sort_pairs(hi, lo, prefer="bitonic"))
    # one wrapper call launches the histogram kernel and the eight radix
    # passes (beside nine memsets); a profile that saw fewer lost some
    if dev["seen"] < SORT_KERNEL_LAUNCHES:
        dev["lost"] = (dev["seen"], SORT_KERNEL_LAUNCHES)
    want = sort.sort_pairs(hi, lo)
    errors.compare("sort_pairs_bitonic", hs, want[0], "chr1 k=21 pairs: bitonic hi vs lax")
    errors.compare("sort_pairs_bitonic", ls, want[1], "chr1 k=21 pairs: bitonic lo vs lax")
    sentinels = int((hs.view(torch.int32)[-(n0 - (CHR1_NT - SKETCH_K + 1)):] == -1).sum())
    check(sentinels == n0 - (CHR1_NT - SKETCH_K + 1), f"chr1 pairs: {sentinels} sentinels at the end")
    del hs, ls, want
    torch.cuda.empty_cache()
    say(f"phase 4 sort chr1: sort_pairs(prefer='bitonic') (#18, radix) of {n0} k=21 canonical pairs == "
        f"prefer='lax'; the {sentinels} sentinels last")
    say(f"  sort_pairs bitonic, chr1 k=21 pairs: {_breakdown(wall, dev)}; top device events (ms) {dev['top']}")
    return hi, lo


# --- the stream path: StreamingEncoder and StreamingDecoder ------------------------------

def _stream_reads(rng, n: int, length: int, alphabet: bytes) -> np.ndarray:
    alpha = np.frombuffer(alphabet, np.uint8)
    return alpha[rng.integers(0, len(alpha), (n, length), dtype=np.uint8)]


def _entries(sunk, per: int) -> list:
    """(name, length, u64 words) entries from sunk (words, batch) pairs."""
    out = []
    for w, b in sunk:
        w64 = w.view("<u8")
        for i in range(b.count):
            n = int(b.lengths[i])
            out.append((b"r%d" % int(b.indices[i]), n, w64[i, : -(-n // per)]))
    return out


def _same_as_torch_tier(codec: str, sunk, what: str) -> None:
    """Every sunk (words, batch) pair against a ``tier="torch"`` codec encode
    of the batch's reads on the card."""
    import torch

    from cute_nucleotides_tpu_torch.models import Base5Codec, TwoBitCodec

    plain = TwoBitCodec(tier="torch", device="cuda") if codec == "2bit" else Base5Codec(tier="torch", device="cuda")
    for w, b in sunk:
        want = plain.encode(torch.from_numpy(b.reads).to("cuda"))
        check(torch.equal(torch.from_numpy(w.view(np.int32)), want.view(torch.int32).cpu()),
              f"{what}: the {codec} batch of record {int(b.indices[0])} != the torch-tier encode")


def _stream_encode_checked(codec: str, fq: str, seqs: np.ndarray, batch: int, validate: bool) -> list:
    """``StreamingEncoder(validate=...).run_batches(fastq_batches(...))`` on
    the card; every sunk batch against a torch-tier codec encode of its reads
    on the card, the first and last row by row against the host oracle, and
    every kept array unchanged after the run."""
    from cute_nucleotides_tpu_torch.ops import native
    from cute_nucleotides_tpu_torch.parallel import runtime
    from cute_nucleotides_tpu_torch.utils import io as io_lib

    n, length = seqs.shape
    per = 32 if codec == "2bit" else 27
    enc = runtime.StreamingEncoder(batch_size=batch, max_len=length, codec=codec, validate=validate)
    check(enc.sharded.tier == "cuda" and enc.sharded.device.type == "cuda",
          f"the default stream runs on {enc.sharded.device} ({enc.sharded.tier})")
    kept = []
    t0 = time.perf_counter()
    agg = enc.run_batches(io_lib.fastq_batches(fq, batch, length, block=per),
                          lambda w, b: kept.append((w, w.copy(), b)))
    wall = time.perf_counter() - t0
    check(agg["total_reads"] == n and agg["batches"] == -(-n // batch), f"{codec} stream agg {agg}")
    check(all(np.array_equal(w, copy) for w, copy, _ in kept), f"{codec}: a kept array changed after the run")
    sunk = [(w, b) for w, _, b in kept]
    _same_as_torch_tier(codec, sunk, f"{length}-nt stream")
    oracle = native.n_to_bits if codec == "2bit" else native.n_to_bits2
    for w, b in (sunk[0], sunk[-1]):
        for i in range(b.count):
            idx = int(b.indices[i])
            check(np.array_equal(w[i].view("<u8")[: -(-length // per)], oracle(seqs[idx])),
                  f"{codec} stream record {idx} != the host oracle")
    say(f"  {codec} encode{', validate' if validate else ''}: {n} x {length} nt in {len(kept)} batches of {batch}, "
        f"{wall:.2f} s ({n * length / wall / 2**30:.3f} GiB/s of nt, {n / wall:,.0f} reads/s); every "
        f"batch == the torch-tier encode, first and last == the oracle, kept arrays unchanged; stages "
        f"{agg['stages']}")
    return _entries(sunk, per)


def _stream_decode(codec: str, entries: list, want: np.ndarray) -> None:
    from cute_nucleotides_tpu_torch.parallel import runtime

    got = []
    t0 = time.perf_counter()
    agg = runtime.StreamingDecoder(batch_size=STREAM_BATCH, codec=codec, verify=codec == "base5").run(
        entries, sink=lambda name, seq: got.append((name, seq)))
    wall = time.perf_counter() - t0
    check([name for name, _ in got] == [b"r%d" % i for i in range(want.shape[0])], f"{codec} decode order")
    check(b"".join(seq for _, seq in got) == want.tobytes(), f"{codec} stream decode != upper(input) with U->T")
    say(f"  {codec} decode{', verify' if codec == 'base5' else ''}: {len(got)} records == upper(input) with "
        f"U->T, {wall:.2f} s ({len(got) / wall:,.0f} reads/s); stages {agg['stages']}")


def _raises(fn, want: str, what: str) -> None:
    try:
        fn()
    except ValueError as e:
        check(str(e) == want, f"{what}: {str(e)!r} != {want!r}")
        return
    raise SmokeFailure(f"{what}: no error")


def _stream_faults(rng, workdir: str, entries5: list) -> str:
    """The four fault checks on the card."""
    import torch

    from cute_nucleotides_tpu_torch import bench
    from cute_nucleotides_tpu_torch.parallel import runtime
    from cute_nucleotides_tpu_torch.utils import io as io_lib

    n = STREAM_FAULT_BATCHES * STREAM_BATCH
    seqs = _stream_reads(rng, n, STREAM_SHORT_NT, ALPHABET)
    k, pos = 3 * STREAM_BATCH + int(rng.integers(0, STREAM_BATCH)), int(rng.integers(0, STREAM_SHORT_NT))
    bad = seqs.copy()
    bad[k, pos] = ord("@")
    fq, bad_fq = os.path.join(workdir, "fault.fq"), os.path.join(workdir, "fault_bad.fq")
    for path, data in ((fq, seqs), (bad_fq, bad)):
        with open(path, "wb") as f:
            f.write(bench.fastq_bytes(data))
    # a planted '@' in record k of batch 3: raised, and nothing from batch 3 on sunk
    firsts = []
    _raises(lambda: runtime.StreamingEncoder(batch_size=STREAM_BATCH, max_len=STREAM_SHORT_NT, validate=True)
            .run_batches(io_lib.fastq_batches(bad_fq, STREAM_BATCH, STREAM_SHORT_NT),
                         lambda w, b: firsts.append(int(b.indices[0]))),
            f"invalid byte b'@' at position {pos} of record index {k}", "planted '@'")
    check(firsts == [0, STREAM_BATCH, 2 * STREAM_BATCH], f"planted '@': batches sunk {firsts}")
    # bit 63 of one base-5 entry's first word: raised, its batch never sunk
    j = 2 * STREAM_BATCH + int(rng.integers(0, STREAM_BATCH))
    bad5 = list(entries5[: 4 * STREAM_BATCH])
    name, length, words = bad5[j]
    words = words.copy()
    words[0] |= np.uint64(1) << np.uint64(63)
    bad5[j] = (name, length, words)
    names = []
    _raises(lambda: runtime.StreamingDecoder(batch_size=STREAM_BATCH, codec="base5", verify=True)
            .run(bad5, sink=lambda nm, s: names.append(nm)),
            f"corrupt base-5 word 0 in record {name.decode()}", "bit 63 of a base-5 entry")
    check(len(names) == 2 * STREAM_BATCH, f"bit 63: {len(names)} records sunk, want {2 * STREAM_BATCH}")
    # a sink that raises on its fourth batch, with a manifest; the resume delivers the rest
    manifest = os.path.join(workdir, "stream_manifest.json")
    sunk, calls = [], [0]

    class Crash(Exception):
        pass

    def crashing(w, b):
        calls[0] += 1
        if calls[0] == 4:
            raise Crash()
        sunk.append((w, b))

    enc = runtime.StreamingEncoder(batch_size=STREAM_BATCH, max_len=STREAM_SHORT_NT, manifest_path=manifest)
    try:
        enc.run_batches(io_lib.fastq_batches(fq, STREAM_BATCH, STREAM_SHORT_NT), crashing)
        raise SmokeFailure("the crashing sink did not stop the stream")
    except Crash:
        pass
    torch.cuda.synchronize()  # a CUDA error left by the drain would raise here
    resumed = runtime.StreamingEncoder(batch_size=STREAM_BATCH, max_len=STREAM_SHORT_NT, manifest_path=manifest)
    agg = resumed.run_batches(io_lib.fastq_batches(fq, STREAM_BATCH, STREAM_SHORT_NT),
                              lambda w, b: sunk.append((w, b)))
    delivered = [int(i) for _, b in sunk for i in b.indices[: b.count]]
    check(sorted(delivered) == list(range(n)), f"crash and resume delivered {len(delivered)} indices, "
          f"{len(set(delivered))} distinct, want each of {n} once")
    check(agg["batches"] == STREAM_FAULT_BATCHES - 3, f"the resume ran {agg['batches']} batches")
    _same_as_torch_tier("2bit", sunk, "crash and resume")
    return (f"planted '@' at record {k} raised, batches {firsts} sunk; bit 63 in {name.decode()} raised, "
            f"{len(names)} records sunk; a sink crash at batch 4 + resume delivered {n} records once each, "
            f"every batch == the torch-tier encode")


PROFILE_STREAM_ENCODE = "--profile-stream-encode"


def profile_stream_encode(fq: str) -> int:
    """One long-read ``StreamingEncoder.run_batches`` of ``fq`` under
    torch.profiler in this (fresh) process, after a warm run; prints its
    breakdown line."""
    from cute_nucleotides_tpu_torch import bench
    from cute_nucleotides_tpu_torch.parallel import runtime
    from cute_nucleotides_tpu_torch.utils import io as io_lib

    def run():
        enc = runtime.StreamingEncoder(batch_size=bench.STREAM_BATCH, max_len=bench.STREAM_READ_NT)
        return enc.run_batches(io_lib.fastq_batches(fq, bench.STREAM_BATCH, bench.STREAM_READ_NT))

    try:
        run()
        agg, wall, dev = _profiled(run)
        check(agg["total_reads"] == STREAM_LONG_READS, f"long-read encode agg {agg}")
        say(f"  long reads, one encode run_batches under the profiler (fresh process; {STREAM_LONG_READS} x "
            f"{bench.STREAM_READ_NT} nt, batch {bench.STREAM_BATCH}): {_breakdown(wall, dev)}; stages "
            f"{agg['stages']}")
    except Exception:
        traceback.print_exc()
        return 1
    return 0


def phase_stream(rng, workdir: str) -> None:
    """The streaming runtime on the card at full width: 1,000,000 x 150-nt
    reads (an Illumina-style run) through StreamingEncoder (validate, both
    codecs) and back through StreamingDecoder (verify on base-5); the
    reference bench's long-read shape through the bench's own encoder
    (unchecked, kernel #1) against the torch tier, then profiled and timed;
    and the fault checks."""
    import torch

    from cute_nucleotides_tpu_torch import bench

    t0 = time.perf_counter()
    entries = {}
    for codec, alphabet in (("2bit", ALPHABET), ("base5", ALPHABET_N)):
        seqs = _stream_reads(rng, STREAM_SHORT_READS, STREAM_SHORT_NT, alphabet)
        fq = os.path.join(workdir, f"stream_{codec}.fq")
        with open(fq, "wb") as f:
            f.write(bench.fastq_bytes(seqs))
        say(f"phase 8 stream, short reads ({codec}): FASTQ {os.path.getsize(fq) / 2**20:.1f} MiB")
        entries[codec] = _stream_encode_checked(codec, fq, seqs, STREAM_BATCH, validate=True)
        _stream_decode(codec, entries[codec], _upper_t_np(seqs))
        os.remove(fq)
        del seqs
    faults = _stream_faults(rng, workdir, entries["base5"])
    del entries
    say(f"  faults: {faults}")
    # the long-read shape: the bench's unchecked encode held against the torch
    # tier, then one encode profiled in a fresh process (this one has run
    # large profiles, after which the profiler loses short calls' device
    # events), then the bench's stream rows
    fq = os.path.join(workdir, "stream_long.fq")
    seqs = _stream_reads(rng, STREAM_LONG_READS, bench.STREAM_READ_NT, ALPHABET)
    with open(fq, "wb") as f:
        f.write(bench.fastq_bytes(seqs))
    _stream_encode_checked("2bit", fq, seqs, bench.STREAM_BATCH, validate=False)
    del seqs
    child = subprocess.run([sys.executable, os.path.abspath(__file__), PROFILE_STREAM_ENCODE, fq],
                           capture_output=True, text=True, timeout=600)
    for line in child.stdout.splitlines():
        say(line)
    check(child.returncode == 0, f"the stream encode profile exited {child.returncode}: {child.stderr[-2000:]}")
    os.remove(fq)
    say(f"  clocks before the stream timing: {_clocks()}")
    results = bench.Results()
    bench.run_stream_rows(results, "cuda")
    for name in bench.STREAM_ROWS:
        row = results.stream[name]
        check(results.gibs[name] > 0 and row["total_reads"] == STREAM_LONG_READS, f"{name}: {row}")
        say(f"  {name}: {results.gibs[name]:.3f} GiB/s of nt, {row['reads_per_s']:,.0f} reads/s, median "
            f"{results.ms[name]:.1f} ms of {row['runs']} runs; {row['link_saturation']:.3f}x the pinned H2D "
            f"rate (range {row['link_saturation_range'][0]:.3f}-{row['link_saturation_range'][1]:.3f}); "
            f"launches {row['launches']}; stages {row['stages']}")
    say(f"  pinned H2D (8 MiB, CUDA events): {results.stream['link_h2d_mib_s']:.1f} MiB/s; clocks after: "
        f"{_clocks()}")
    torch.cuda.synchronize()
    say(f"phase 8 stream done ({time.perf_counter() - t0:.1f} s with the checks)")


# --- the planar path: phase 3 ------------------------------------------------------

def phase_planar(x5, words5):
    """The base-5 batch viewed as u8[310688, 3456] rows through
    ``encode_b5_planar`` (#15), its planes reinterleaved against the
    batch's words; ``decode_b5_nt4_panels`` (#16, compact, and padded then
    de-padded on the host by ``depad_nt4_host``) and ``decode_b5_panels``
    (#17) against the batch's decoded bytes.  Returns the planes."""
    import torch

    from cute_nucleotides_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    rows = x5.numel() // K.B5_ROW_NT
    lo, hi = K.encode_b5_planar(x5.view(rows, K.B5_ROW_NT))
    check(torch.equal(K._interleave(lo, hi).view(torch.int32), words5.view(-1).view(torch.int32)),
          "planar encode of the base-5 batch, reinterleaved, != the batch's words")
    want = _upper_t(x5).view(rows, K.B5_ROW_NT)
    check(torch.equal(K.decode_b5_panels(lo, hi), want), "decode_b5_panels of the batch's planes != its bytes")
    check(torch.equal(K.decode_b5_nt4_panels(lo, hi, padded=False).view(torch.uint8), want),
          "compact decode_b5_nt4_panels of the batch's planes != its bytes")
    padded = K.decode_b5_nt4_panels(lo, hi)
    check(padded.shape == (rows, K.B5_NT4_PAD_LANES), f"padded nt4 shape {tuple(padded.shape)}")
    check(bool((padded.view(torch.int32).view(rows, K.B5_SLICES, 112)[:, :, 108:] == 0x41414141).all()),
          "padded nt4 decode of the batch: a pad lane is not 'AAAA'")
    host = K.depad_nt4_host(padded.cpu().numpy())
    check(torch.equal(torch.from_numpy(host).to("cuda"), want.view(-1)),
          "depad_nt4_host of the padded decode != the batch's bytes")
    del want, padded, host
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    say(f"phase 3 planar: encode_b5_planar of u8[{rows}, {K.B5_ROW_NT}] reinterleaves to the batch's words; "
        f"decode_b5_panels, decode_b5_nt4_panels (compact, and padded de-padded on the host) == its bytes "
        f"({time.perf_counter() - t0:.1f} s with the checks)")
    return lo, hi


# --- the align path: kernel #19, the Myers scan ----------------------------------------

def _myers_ascii(rng, n: int, alpha: bytes = b"ACGT") -> bytes:
    return rng.choice(np.frombuffer(alpha, np.uint8), n).tobytes()


def _mutate(rng, seq: bytes, edits: int, alpha: bytes = b"ACGT") -> bytes:
    """``seq`` with ``edits`` random substitutions, insertions or deletions."""
    s = bytearray(seq)
    for _ in range(edits):
        at, kind = int(rng.integers(0, len(s))), int(rng.integers(0, 3))
        if kind == 0:
            s[at] = alpha[(alpha.index(s[at]) + 1 + int(rng.integers(0, len(alpha) - 1))) % len(alpha)]
        elif kind == 1:
            s.insert(at, alpha[int(rng.integers(0, len(alpha)))])
        elif len(s) > 1:
            del s[at]
    return bytes(s)


def _myers_rows(seqs, b5: bool, width_u32: int) -> np.ndarray:
    """ASCII rows -> packed u32[len(seqs), width_u32] by the host oracle."""
    from cute_nucleotides_tpu_torch.ops import native

    out = np.zeros((len(seqs), width_u32), np.uint32)
    for i, s in enumerate(seqs):
        w = np.ascontiguousarray((native.n_to_bits2 if b5 else native.n_to_bits)(s)).view(np.uint32)[:width_u32]
        out[i, : w.size] = w
    return out


def _corrupt_b5(rng, words: np.ndarray, every: int) -> np.ndarray:
    """Triplet 125, 126 or 127 in one word of every ``every``-th row."""
    out = words.copy()
    pairs = out.view(np.uint64)
    for r in range(0, out.shape[0], every):
        t = int(rng.integers(125, 128))
        pairs[r, int(rng.integers(0, pairs.shape[1]))] |= np.uint64(t << (7 * int(rng.integers(0, 9))))
    return out


def _myers_compare(errors: Errors, got, want, what: str) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        errors.compare("myers_scan", g, w, what)


def _myers_case(errors: Errors, peq, ql, words, tl, stride: int, length: int, mode: str, b5: bool, errs,
                what: str) -> None:
    from cute_nucleotides_tpu_torch.ops import kernels as K

    args = dict(mode=mode, b5=b5, max_errors=errs if mode == "ends" else None)
    _myers_compare(errors, K.myers_scan(peq, ql, words, tl, stride, length, **args),
                   K.myers_scan_plain(peq, ql, words, tl, stride, length, **args), what)


#: phase 2 query widths of the Peq build (1, 2, 3 and 9 blocks), and phase 3's
#: rows: the adapter scan's batch, queries of 4 u32 (54 nt)
PEQ_B5_WQ, PEQ_B5_ROWS = (2, 4, 6, 20), 1 << 20
#: phase 3's base-5 align batch at the adapter scan's shape: PEQ_B5_ROWS texts
#: of B5_BATCH_NT nt in rows of 12 u32 (162 nt), B5_BATCH_CHECKED of them
#: held to the host Myers scan
B5_BATCH_NT, B5_BATCH_CHECKED = 150, 4096


def _peq_b5_queries(rng, wq: int):
    """(qwords, qlens) on the card: each length at the block and word seams,
    at the words' rows, past them and negative, over packed ACGTN queries,
    then the same with a triplet 125..127 in every row, then random words."""
    import torch

    have = 27 * wq // 2
    lens = [0, 1, 26, 27, 31, 32, 33, 53, 54, have, have + 5, -3]
    clean = _myers_rows([_myers_ascii(rng, have, b"ACGTN") for _ in lens], True, wq)
    q = np.concatenate([clean, _corrupt_b5(rng, clean, 1), rng.integers(0, 2**32, (9, wq), dtype=np.uint32)])
    ql = np.array(lens * 2 + rng.integers(-2, have + 8, 9).tolist(), np.int32)
    return torch.from_numpy(q).cuda(), torch.from_numpy(ql).cuda()


def _peq_b5_small(errors: Errors, rng) -> int:
    """The Peq build against its plain version at PEQ_B5_WQ: contiguous, from
    row 1, every other row, a stride-0 query and words 4 bytes off an 8-byte
    boundary (each of its load widths); returns the cases."""
    import torch

    from cute_nucleotides_tpu_torch.ops import kernels as K

    cases = 0
    for wq in PEQ_B5_WQ:
        q, ql = _peq_b5_queries(rng, wq)
        n = q.shape[0]
        off = torch.zeros(n * wq + 1, dtype=torch.int32, device="cuda")
        off[1:] = q.view(torch.int32).reshape(-1)
        views = {"contiguous": (q, ql), "from row 1": (q[1:], ql[1:]),
                 "every other row": (q[::2], ql[::2].contiguous()), "stride 0": (q[5:6].expand(n, wq), ql),
                 "4 bytes off": (off[1:].view(torch.uint32).view(n, wq), ql)}
        for what, (v, lens) in views.items():
            errors.compare("peq_b5", K.peq_b5(v, lens), K.peq_b5_plain(v, lens), f"peq_b5 Wq = {wq}, {what}")
            cases += 1
    return cases


def phase_peq_b5_full(errors: Errors) -> None:
    """The Peq build at the adapter scan's shape, PEQ_B5_ROWS queries of 4 u32
    (random words from the seed, corrupt triplets where they fall, bit 63 in
    half), lengths -2..60, against its plain version on the card."""
    import torch

    from cute_nucleotides_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 22)
    q = torch.randint(-(2**31), 2**31, (PEQ_B5_ROWS, 4), dtype=torch.int32, device="cuda", generator=g)
    ql = torch.randint(-2, 61, (PEQ_B5_ROWS,), dtype=torch.int32, device="cuda", generator=g)
    q = q.view(torch.uint32)
    errors.compare("peq_b5", K.peq_b5(q, ql), K.peq_b5_plain(q, ql), f"peq_b5 at {PEQ_B5_ROWS} x 4 u32")
    torch.cuda.synchronize()
    say(f"phase 3 Peq build: peq_b5 of {PEQ_B5_ROWS} queries of 4 u32 (lengths -2..60) == its plain version "
        f"({time.perf_counter() - t0:.1f} s with the check)")


def _peq_b5_timing() -> tuple:
    """The Peq build's timing case at the adapter scan's shape, PEQ_B5_ROWS
    queries of 4 u32 (random words from the seed, 33-nt lengths): (label,
    kernel, plain, bound).  The kernel is timed through its entry point
    ``cn_peq_b5`` with the output allocated once: the wrapper's host work
    (29-43 us a call on the card's host) is longer than the kernel.  Bound:
    16 B of words and a 4-B length read, 5 x 2 u32 written a query."""
    import torch

    from cute_nucleotides_tpu_torch.ops import _build, kernels as K

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 24)
    q = torch.randint(-(2**31), 2**31, (PEQ_B5_ROWS, 4), dtype=torch.int32, device="cuda", generator=g).view(
        torch.uint32)
    ql = torch.full((PEQ_B5_ROWS,), 33, dtype=torch.int32, device="cuda")
    out = torch.empty((PEQ_B5_ROWS, 5, 2), dtype=torch.uint32, device="cuda")
    lib, stream = _build.load(), torch.cuda.current_stream().cuda_stream
    kernel = lambda: K._launch(lib.cn_peq_b5, q.data_ptr(), 4, 4, ql.data_ptr(), PEQ_B5_ROWS, 2, out.data_ptr(), stream)
    return (f"[{PEQ_B5_ROWS} x 4 u32]", kernel, lambda: K.peq_b5_plain(q, ql),
            _bound((16 + 4 + 40) * PEQ_B5_ROWS))


def phase_kernels_align(errors: Errors, rng) -> None:
    """#19 against its plain version on the card, bit for bit: both
    alphabets and every mode, ALIGN_PAIRS pairs at each m in ALIGN_M,
    ragged texts of 0..700 nt (0..150 past 128-nt queries; tlens below
    the row capacity), wildcard queries (N, ?), base-5 triplets 125..127
    in texts and queries, max_errors 0, 2 and INT32_MAX, a stride-0 Peq
    (to m = 128, and at m = 256 and 1024 on MYERS_LONG_PAIRS pairs of
    200..400-nt texts), the lanes of two blocks on batches large enough
    for the launch plan to pick them, stream rows whose halo spans
    several rows, and #19's stream form's key on the same words."""
    import torch

    from cute_nucleotides_tpu_torch.ops import align, kernels as K

    dev = "cuda"
    cases, t0 = 0, time.perf_counter()
    for b5 in (False, True):
        alpha, wild = (b"ACGTN", b"?") if b5 else (b"ACGT", b"N")
        cap_u32 = 2 * 26 if b5 else 44  # 702 / 704 nt a row
        modes = ("global", "semiglobal", "prefix") + (() if b5 else ("ends",))
        for m in ALIGN_M:
            queries = []
            for i in range(ALIGN_PAIRS):
                q = bytearray(_myers_ascii(rng, m, alpha))
                if i % 4 == 1:
                    q[int(rng.integers(0, m))] = wild[0]
                queries.append(bytes(q))
            # the plain version costs about 30 + 4 nb launches a text nt: the long queries get shorter texts
            tmax = 700 if m <= 128 else 150
            texts = [_myers_ascii(rng, int(rng.integers(0, tmax + 1)), alpha) for _ in range(ALIGN_PAIRS)]
            for i in range(0, ALIGN_PAIRS, 3):  # a near copy of the query in a third of the texts
                if len(texts[i]) > m + 4:
                    at = int(rng.integers(0, len(texts[i]) - m - 2))
                    near = _mutate(rng, queries[i].replace(wild, alpha[:1]), 2, alpha)
                    texts[i] = (texts[i][:at] + near + texts[i][at:])[: len(texts[i])]
            tw = _myers_rows(texts, b5, cap_u32)
            if b5:
                tw = _corrupt_b5(rng, tw, 3)
            build = align.peq_from_bytes_b5 if b5 else align.peq_from_bytes
            peq = np.stack([build(q)[0] for q in queries])
            if b5:  # a third of the queries from packed words with a corrupt triplet (digit 5 matches nothing)
                qw = _corrupt_b5(rng, _myers_rows([q.replace(b"?", b"A") for q in queries], True,
                                                  2 * -(-m // 27)), 1)
                coded = align._peq_b5(torch.from_numpy(qw), [m] * ALIGN_PAIRS)[:, :, : peq.shape[2]].numpy()
                peq[::3] = coded[::3]
            tl = np.array([len(t) for t in texts], np.int32)
            tl[1::5] = np.maximum(tl[1::5] - 9, 0)
            errs = np.array([(0, 2, 2**31 - 1)[i % 3] for i in range(ALIGN_PAIRS)], np.int32)
            ql = np.full(ALIGN_PAIRS, m, np.int32)
            ql[-1] = 0
            t = [torch.from_numpy(a).to(dev) for a in (peq, ql, tw.reshape(-1), tl, errs)]
            wide = torch.from_numpy(peq[:1]).to(dev).expand(ALIGN_PAIRS, *peq.shape[1:])  # stride 0
            for mode in modes:
                _myers_case(errors, t[0], t[1], t[2], t[3], cap_u32, cap_u32, mode, b5, t[4],
                            f"#19 {'b5' if b5 else '2bit'} m={m} {mode}")
                cases += 1
                if mode in ("semiglobal", "ends") and m <= 128:  # the CLI's modes with one broadcast Peq
                    _myers_case(errors, wide, t[1], t[2], t[3], cap_u32, cap_u32, mode, b5, t[4],
                                f"#19 {'b5' if b5 else '2bit'} m={m} {mode} stride-0 Peq")
                    cases += 1
        # the CLI's broadcast Peq at the long forms' edges (8 and 32 lanes of one block): a few pairs whose
        # texts run 200..400 nt, many words past the 32-lane fill (62 nt, base-5 93), stopping mid-word
        cap_long = 2 * 16 if b5 else 28  # 432 / 448 nt a row
        for m in (256, 1024):
            q = _myers_ascii(rng, m, alpha)
            texts = [_myers_ascii(rng, n, alpha) for n in [400] + rng.integers(200, 401, MYERS_LONG_PAIRS - 1).tolist()]
            texts[1] = (texts[1][:50] + _mutate(rng, q, 3, alpha) + texts[1][50:])[: len(texts[1])]
            tw = _myers_rows(texts, b5, cap_long)
            if b5:
                tw = _corrupt_b5(rng, tw, 3)
            peq = torch.from_numpy((align.peq_from_bytes_b5 if b5 else align.peq_from_bytes)(q)[0]).to(dev)
            errs = torch.tensor([(0, 2, 2**31 - 1)[i % 3] for i in range(MYERS_LONG_PAIRS)], dtype=torch.int32,
                                device=dev)
            t = (peq[None].expand(MYERS_LONG_PAIRS, *peq.shape),
                 torch.full((MYERS_LONG_PAIRS,), m, dtype=torch.int32, device=dev),
                 torch.from_numpy(tw.reshape(-1)).to(dev),
                 torch.tensor([len(x) for x in texts], dtype=torch.int32, device=dev))
            for mode in ("semiglobal",) + (() if b5 else ("ends",)):
                _myers_case(errors, *t, cap_long, cap_long, mode, b5, errs,
                            f"#19 {'b5' if b5 else '2bit'} m={m} {mode} stride-0 Peq, 200..400-nt texts")
                cases += 1
        # the lanes of two blocks, which the plan picks once one-block lanes would pass two warps a scheduler
        # (one but in semiglobal mode): random Peq planes, query lengths up to the blocks' end and past it,
        # 0..160-nt texts (stopping mid-word)
        wave = torch.cuda.get_device_properties(0).multi_processor_count * 4 * 32
        for nb in (3, 4, 8, 32):
            lanes = (1 << (nb - 1).bit_length()) // 2
            R = wave // lanes + 5
            for mode in modes:
                plan = K.myers_plan(nb, R, mode)
                check(plan == (lanes, 2), f"#19 plan for {nb} blocks x {R} pairs, {mode}: {plan}")
            A = 5 if b5 else 4
            t = [torch.from_numpy(a).to(dev) for a in (
                rng.integers(0, 2**32, (R, A, nb), dtype=np.uint32), rng.integers(0, 32 * nb + 3, R).astype(np.int32),
                _corrupt_b5(rng, rng.integers(0, 2**32, (R, 10), dtype=np.uint32), 7) if b5
                else rng.integers(0, 2**32, (R, 10), dtype=np.uint32), rng.integers(0, 161, R).astype(np.int32),
                rng.integers(0, 30, R).astype(np.int32))]
            for mode in modes:
                _myers_case(errors, t[0], t[1], t[2].reshape(-1), t[3], 10, 10, mode, b5, t[4],
                            f"#19 {'b5' if b5 else '2bit'} {lanes} lane(s) of 2 blocks, nb = {nb}, {R} pairs {mode}")
                cases += 1
        # stream rows: 4 u32 a row (2 pairs), the halo of a 150-nt query spans about 5 rows
        m, stride = 150, 4
        halo = (2 * -(-(2 * m - 2) // 27)) if b5 else -(-(2 * m - 2) // 16)
        n_u32 = 2 * 61 if b5 else 101
        words = torch.from_numpy(_corrupt_b5(rng, rng.integers(0, 2**32, (1, n_u32), dtype=np.uint32), 1)[0]
                                 if b5 else rng.integers(0, 2**32, n_u32, dtype=np.uint32)).to(dev)
        R = -(-n_u32 // stride)
        peq = torch.from_numpy((align.peq_from_bytes_b5 if b5 else align.peq_from_bytes)(
            _myers_ascii(rng, m, alpha))[0]).to(dev)
        ql = torch.full((R,), m, dtype=torch.int32, device=dev)
        tl = torch.full((R,), 10**6, dtype=torch.int32, device=dev)
        for mode in ("semiglobal", "prefix", "global"):
            _myers_case(errors, peq[None].expand(R, *peq.shape), ql, words, tl, stride, stride + halo, mode, b5,
                        None, f"#19 {'b5' if b5 else '2bit'} stream rows, halo {halo} u32 over rows of {stride}")
            cases += 1
        # #19's stream form on the same words, its key against its plain version's: one and five blocks,
        # best_match_stream's rows, the whole stream, a ragged length and one nt
        cap_nt = 27 * (n_u32 // 2) if b5 else 16 * n_u32
        for sm in (21, 150):
            speq = (align.peq_from_bytes_b5 if b5 else align.peq_from_bytes)(_myers_ascii(rng, sm, alpha))[0]
            if b5:
                sR, prb, Hp = align.stream_rows_plan_b5(n_u32 // 2, sm)
                srows = (sR, 2 * prb, 2 * (prb + Hp))
            else:
                sR, wrb, H = align.stream_rows_plan(n_u32, sm)
                srows = (sR, wrb, wrb + H)
            for n in (cap_nt, cap_nt - 13, 1):
                got = int(K.myers_stream_best(speq, sm, words, n, *srows, b5=b5))
                want = int(K.myers_stream_best_plain(speq, sm, words.cpu(), n, *srows, b5=b5))
                check(got == want, f"#19 stream form {'b5' if b5 else '2bit'} m = {sm}, {n} nt: key {got:#x} != "
                                   f"its plain version's {want:#x}")
                cases += 1
        # the approx CLI's shape: reads in rows of 16 u32, PRIMER (m = 20) as one broadcast Peq, a share of
        # the reads holding it with 0-2 edits and one in seven cut short
        reads = [_myers_ascii(rng, APPROX_NT, alpha) for _ in range(APPROX_ROWS)]
        for i in range(0, APPROX_ROWS, APPROX_EVERY):
            p = _mutate(rng, PRIMER, int(rng.integers(0, 3)))
            at = int(rng.integers(0, APPROX_NT - len(p)))
            reads[i] = (reads[i][:at] + p + reads[i][at:])[:APPROX_NT]
        tl = np.full(APPROX_ROWS, APPROX_NT, np.int32)
        tl[::7] = rng.integers(0, APPROX_NT, tl[::7].size)
        peq = torch.from_numpy((align.peq_from_bytes_b5 if b5 else align.peq_from_bytes)(PRIMER)[0]).to(dev)
        args = (peq[None].expand(APPROX_ROWS, *peq.shape),
                torch.full((APPROX_ROWS,), len(PRIMER), dtype=torch.int32, device=dev),
                torch.from_numpy(_myers_rows(reads, b5, 16).reshape(-1)).to(dev), torch.from_numpy(tl).to(dev), 16, 16)
        for mode in ("semiglobal",) + (() if b5 else ("ends",)):
            _myers_case(errors, *args, mode, b5, torch.full((APPROX_ROWS,), 2, dtype=torch.int32, device=dev),
                        f"#19 {'b5' if b5 else '2bit'} approx shape, {APPROX_ROWS} x {APPROX_NT} nt, m = 20")
            cases += 1
    peq_cases = _peq_b5_small(errors, rng)
    torch.cuda.synchronize()
    say(f"phase 2 align kernel: #19 in {cases} cases (both alphabets, every mode, {ALIGN_PAIRS} pairs at m in "
        f"{ALIGN_M}, ragged texts of 0..700 nt (0..150 past m = 128), N/? wildcards, base-5 triplets 125..127 in "
        f"texts and queries, lanes of two blocks at 3, 4, 8 and 32 blocks on batches past two warps a scheduler, "
        f"max_errors 0/2/INT32_MAX, stride-0 Peq (to m = 128, and {MYERS_LONG_PAIRS} pairs of 200..400-nt texts at "
        f"m = 256 and 1024), stream rows with a halo over several rows and the stream form's key, the approx CLI's {APPROX_ROWS} rows of 16 u32 with PRIMER): bit-identical to the plain version "
        f"({errors.count} comparisons in phase 2; max abs err {errors.max['myers_scan']}; "
        f"{time.perf_counter() - t0:.1f} s with the Peq build's)")
    say(f"phase 2 Peq build: peq_b5 in {peq_cases} cases (Wq in {PEQ_B5_WQ}, query lengths at the block and word "
        f"seams, past the words and negative, triplets 125..127, random words; contiguous, row-sliced, stride 0, "
        f"4 bytes off): bit-identical to the plain version (max abs err {errors.max['peq_b5']})")


def _align_batch(rng):
    """The bench's shape, ALIGN_B pairs of an ALIGN_QM-nt query and an
    ALIGN_TN-nt text (random ACGT; a near copy of the query in every other
    text), packed on the host: (queries, texts, qw, tw) with the words on
    the card."""
    from cute_nucleotides_tpu_torch import interop
    from cute_nucleotides_tpu_torch.ops import native

    acgt = np.frombuffer(b"ACGT", np.uint8)
    qs = rng.choice(acgt, (ALIGN_B, ALIGN_QM))
    ts = rng.choice(acgt, (ALIGN_B, ALIGN_TN))
    for i in range(0, ALIGN_B, 2):
        near = np.frombuffer(_mutate(rng, qs[i].tobytes(), int(rng.integers(0, 6))), np.uint8)[: ALIGN_TN // 2]
        at = int(rng.integers(0, ALIGN_TN - near.size))
        ts[i, at : at + near.size] = near
    # rows of 128 and 2048 nt are whole u64 words, so one encode of the flat bytes packs every row
    qw = interop.u64_to_tensor(native.n_to_bits(qs.reshape(-1)).reshape(ALIGN_B, -1), "cuda")
    tw = interop.u64_to_tensor(native.n_to_bits(ts.reshape(-1)).reshape(ALIGN_B, -1), "cuda")
    return qs, ts, qw, tw


def phase_align_batch(rng):
    """``edit_distance_packed`` and ``best_match_packed`` at the bench's
    shape through kernel #19, under torch.profiler, each pair held to the
    host Myers scan (``native.edit_distance`` / ``native.best_match``);
    returns the packed words for the timing phase."""
    import torch

    from cute_nucleotides_tpu_torch.ops import align, native

    t0 = time.perf_counter()
    qs, ts, qw, tw = _align_batch(rng)
    ql = torch.full((ALIGN_B,), ALIGN_QM, dtype=torch.int32, device="cuda")
    tl = torch.full((ALIGN_B,), ALIGN_TN, dtype=torch.int32, device="cuda")
    dist, d_wall, d_dev = _profiled(lambda: align.edit_distance_packed(qw, ql, tw, tl))
    (best, end), b_wall, b_dev = _profiled(lambda: align.best_match_packed(qw, ql, tw, tl))
    dist, best, end = (x.cpu().numpy() for x in (dist, best, end))
    for i in range(ALIGN_B):
        q, t = qs[i].tobytes(), ts[i].tobytes()
        check(int(dist[i]) == native.edit_distance(q, t), f"edit_distance_packed pair {i}: {dist[i]} != host Myers")
        check((int(best[i]), int(end[i])) == native.best_match(q, t),
              f"best_match_packed pair {i}: {(best[i], end[i])} != host {native.best_match(q, t)}")
    say(f"phase 3 align batch: edit_distance_packed and best_match_packed on {ALIGN_B} pairs of {ALIGN_QM} x "
        f"{ALIGN_TN} nt == the host Myers scan on every pair (median distance {int(np.median(dist))}, best "
        f"{int(best.min())}..{int(best.max())}; {time.perf_counter() - t0:.1f} s with the checks)")
    say(f"  edit_distance_packed, {ALIGN_B} x {ALIGN_QM} x {ALIGN_TN}: {_breakdown(d_wall, d_dev)}")
    say(f"  best_match_packed, {ALIGN_B} x {ALIGN_QM} x {ALIGN_TN}: {_breakdown(b_wall, b_dev)}")
    return qw, tw


def phase_align_batch_b5(rng) -> None:
    """``best_match_packed_b5`` and ``edit_distance_packed_b5`` at the adapter
    scan's shape, through the Peq build and #19: PEQ_B5_ROWS pairs of a query
    of 4 u32 (20..54 nt of ACGT, its own a row) and a text of 12 u32
    (B5_BATCH_NT nt of ACGT; a near copy of the query planted in half the
    checked rows).  B5_BATCH_CHECKED rows are held to the host Myers scan
    (``native.best_match`` / ``native.edit_distance``), and each call must
    launch the Peq build once and #19 once."""
    import torch

    from cute_nucleotides_tpu_torch import interop
    from cute_nucleotides_tpu_torch.ops import align, kernels as K, native

    t0 = time.perf_counter()
    R, q_nt, t_nt = PEQ_B5_ROWS, 54, 162  # 2 and 6 words of 27 nt: one encode of the flat bytes packs every row
    acgt = np.frombuffer(b"ACGT", np.uint8)
    qs = acgt[rng.integers(0, 4, (R, q_nt), dtype=np.uint8)]
    ts = acgt[rng.integers(0, 4, (R, t_nt), dtype=np.uint8)]
    qlens = rng.integers(20, q_nt + 1, R).astype(np.int32)
    rows = rng.choice(R, B5_BATCH_CHECKED, replace=False)
    for i in rows[::2]:
        near = np.frombuffer(_mutate(rng, qs[i, : qlens[i]].tobytes(), int(rng.integers(0, 4))), np.uint8)
        at = int(rng.integers(0, B5_BATCH_NT - near.size + 1))
        ts[i, at : at + near.size] = near
    qw = interop.u64_to_tensor(native.n_to_bits2(qs.reshape(-1)).reshape(R, -1), "cuda")
    tw = interop.u64_to_tensor(native.n_to_bits2(ts.reshape(-1)).reshape(R, -1), "cuda")
    ql = torch.from_numpy(qlens).cuda()
    tl = torch.full((R,), B5_BATCH_NT, dtype=torch.int32, device="cuda")
    before = (K.peq_b5.launches, K.myers_scan.launches)
    best, end = align.best_match_packed_b5(qw, ql, tw, tl)
    dist = align.edit_distance_packed_b5(qw, ql, tw, tl)
    runs = (K.peq_b5.launches - before[0], K.myers_scan.launches - before[1])
    check(runs == (2, 2), f"the two base-5 calls launched (peq_b5, myers_scan) {runs}, not one each a call")
    idx = torch.from_numpy(rows).cuda()
    best, end, dist = (x[idx].cpu().numpy() for x in (best, end, dist))
    for k, i in enumerate(rows):
        q, t = qs[i, : qlens[i]].tobytes(), ts[i, :B5_BATCH_NT].tobytes()
        check((int(best[k]), int(end[k])) == native.best_match(q, t),
              f"best_match_packed_b5 row {i}: {(best[k], end[k])} != host {native.best_match(q, t)}")
        check(int(dist[k]) == native.edit_distance(q, t),
              f"edit_distance_packed_b5 row {i}: {dist[k]} != host {native.edit_distance(q, t)}")
    say(f"phase 3 base-5 align batch: best_match_packed_b5 and edit_distance_packed_b5 on {R} pairs of 20..{q_nt} x "
        f"{B5_BATCH_NT} nt (u32 rows of 4 and 12), one peq_b5 and one myers_scan launch a call, == the host Myers "
        f"scan on {B5_BATCH_CHECKED} rows (best {int(best.min())}..{int(best.max())}; "
        f"{time.perf_counter() - t0:.1f} s with the checks)")


def phase_align_stream(rng, chr1_words) -> None:
    """``best_match_stream`` on the chr1-length 2-bit stream with a 21-nt
    query (a substring of it with 2 edits), under torch.profiler, against
    one ``native.best_match`` over the decoded stream; then
    ``best_match_stream_b5`` on the same sequence encoded base-5 must give
    the same (dist, end)."""
    import torch

    from cute_nucleotides_tpu_torch import api, interop
    from cute_nucleotides_tpu_torch.ops import align, native

    t0 = time.perf_counter()
    w = chr1_words.view(torch.int32)
    w64 = interop.tensor_to_u64(torch.cat([w, w.new_zeros(w.numel() % 2)]).view(torch.uint32))
    seq = native.bits_to_n(w64, CHR1_NT)
    at = int(rng.integers(0, CHR1_NT - 40))
    query = seq[at : at + ALIGN_STREAM_M].tobytes()
    while True:  # two edits that keep 21 nt (two substitutions, or an insertion and a deletion)
        edited = _mutate(rng, query, 2)
        if len(edited) == ALIGN_STREAM_M and edited != query:
            break
    (d, e), wall, dev = _profiled(lambda: align.best_match_stream(chr1_words, CHR1_NT, edited))
    t_host = time.perf_counter()
    want = native.best_match(edited, seq)
    t_host = time.perf_counter() - t_host
    check((d, e) == want and d <= 2, f"best_match_stream chr1: {(d, e)} != host {want}")
    w5 = interop.u64_to_tensor(api.n_to_bits2(seq, tier="auto"), "cuda")
    del seq
    (d5, e5), wall5, dev5 = _profiled(lambda: align.best_match_stream_b5(w5, CHR1_NT, edited))
    check((d5, e5) == (d, e), f"best_match_stream_b5 chr1: {(d5, e5)} != the 2-bit scan's {(d, e)}")
    del w5
    torch.cuda.empty_cache()
    say(f"phase 4 align stream: best_match_stream of a {ALIGN_STREAM_M}-nt query (the stream at {at} with 2 "
        f"edits) over {CHR1_NT} nt == (dist, end) {(d, e)} of native.best_match on the decoded stream "
        f"({t_host:.2f} s on the host); best_match_stream_b5 of the same sequence gives the same "
        f"({time.perf_counter() - t0:.1f} s with the checks)")
    say(f"  best_match_stream, chr1 length: {_breakdown(wall, dev)}; top device events (ms) {dev['top']}")
    say(f"  best_match_stream_b5, chr1 length: {_breakdown(wall5, dev5)}; top device events (ms) {dev5['top']}")


def _approx_reads(rng, records: list) -> tuple[list, list]:
    """The phase-5 reads with PRIMER (or its reverse complement, half the
    time) planted with 0-2 edits in every APPROX_EVERY-th read: (names,
    upper-case U->T sequences)."""
    names, seqs = [], []
    for i, (name, s) in enumerate(records):
        s = bytes(_upper_t_np(np.frombuffer(s, np.uint8).copy()))
        if i % APPROX_EVERY == 0:
            p = _mutate(rng, PRIMER if rng.integers(0, 2) else _revcomp(PRIMER), int(rng.integers(0, 3)))
            at = int(rng.integers(0, len(s) - len(p)))
            s = s[:at] + p + s[at + len(p):]
        names.append(name)
        seqs.append(s)
    return names, seqs


def _cigar_edits(cigar: str, q: bytes, window: bytes) -> tuple[int, int, int]:
    """(edits, query nt, window nt) of a SAM CIGAR applied to q and window."""
    edits = qi = ti = 0
    for n, op in re.findall(r"(\d+)([MID])", cigar):
        n = int(n)
        if op == "M":
            edits += sum(a != b for a, b in zip(q[qi : qi + n], window[ti : ti + n]))
            qi, ti = qi + n, ti + n
        elif op == "I":
            edits, qi = edits + n, qi + n
        else:
            edits, ti = edits + n, ti + n
    return edits, qi, ti


def _ends_np(seqs: list, query: bytes, max_errors: int) -> list:
    """Every end (1-based) within max_errors of query in each read, by a
    semiglobal DP vectorized over the reads (codes (b >> 1) & 3)."""
    n = len(seqs[0])
    t = (np.frombuffer(b"".join(seqs), np.uint8).reshape(len(seqs), n) >> 1) & 3
    cq = (np.frombuffer(query, np.uint8) >> 1) & 3
    m = len(query)
    col = np.tile(np.arange(m + 1, dtype=np.int32), (len(seqs), 1))  # D[:, 0] = i
    hits = np.zeros((len(seqs), n), bool)
    for j in range(n):
        new = np.empty_like(col)
        new[:, 0] = 0
        sub = (t[:, j : j + 1] != cq[None, :]).astype(np.int32)
        new[:, 1:] = np.minimum(col[:, :-1] + sub, col[:, 1:] + 1)
        for i in range(1, m + 1):
            np.minimum(new[:, i], new[:, i - 1] + 1, out=new[:, i])
        col = new
        hits[:, j] = col[:, m] <= max_errors
    return [np.nonzero(h)[0] + 1 for h in hits]


def phase_approx(rng, workdir: str, reads2: list, reads5: list) -> None:
    """``approx`` through the CLI on the phase-5 reads of both codecs, with
    PRIMER planted in a share of them: ``--both``, ``--both --max-errors
    2``, ``--all --max-errors 1`` (2-bit; base-5 must refuse it with exit 1)
    and ``--both --cigar`` (on the first APPROX_CIGAR_READS records).  2-bit
    lines against ``native.best_match`` per record and strand (``--all``
    against a numpy DP of every end); base-5 against the port's DP oracle
    on a sample; each CIGAR applied to its window must give the line's
    distance."""
    from cute_nucleotides_tpu_torch import cli
    from cute_nucleotides_tpu_torch.ops import align, native

    rc_primer = _revcomp(PRIMER)
    for label, codec, records, encode in (("2-bit", "2bit", reads2, native.n_to_bits),
                                          ("base-5", "base5", reads5, native.n_to_bits2)):
        t0 = time.perf_counter()
        names, seqs = _approx_reads(rng, records)
        nup = os.path.join(workdir, f"approx_{codec}.nup")
        packed, lens = [encode(s) for s in seqs], [len(s) for s in seqs]
        cli.write_nup(nup, names, packed, lens, codec)
        if codec == "2bit":
            want = []
            for s in seqs:
                f, r = native.best_match(PRIMER, s), native.best_match(rc_primer, s)
                want.append((*r, "-") if r[0] < f[0] else (*f, "+"))
            sample = range(len(seqs))
        else:
            sample = range(0, len(seqs), APPROX_B5_EVERY)
            want = {}
            for i in sample:
                f = align.best_match_reference_b5(PRIMER, seqs[i])
                r = align.best_match_reference_b5(rc_primer, seqs[i])
                want[i] = (*r, "-") if r[0] < f[0] else (*f, "+")
        rc, text, wall, dev = _run_cli(["approx", nup, PRIMER.decode(), "--both"])
        got = [json.loads(line) for line in text.splitlines()]
        check(rc == 0 and [g["record"] for g in got] == [n.decode() for n in names],
              f"{label} approx --both: exit {rc}, {len(got)} lines")
        for i in sample:
            check((got[i]["dist"], got[i]["end"], got[i]["strand"]) == tuple(want[i]),
                  f"{label} approx --both record {i}: {got[i]} != {want[i]}")
        planted = sum(g["dist"] <= 2 for g in got)
        say(f"phase 5 approx {label}: --both on {len(got)} x {CLI_READ_NT} nt, PRIMER in every {APPROX_EVERY}th "
            f"read with 0-2 edits: dist/end/strand == {'native.best_match on every record' if codec == '2bit' else f'the DP oracle on {len(sample)} records'} "
            f"({planted} within 2 edits; {time.perf_counter() - t0:.1f} s with the checks)")
        say(f"  approx --both, {label}: {_breakdown(wall, dev)}; top device events (ms) {dev['top']}")
        rc, text, wall2, _ = _run_cli(["approx", nup, PRIMER.decode(), "--both", "--max-errors", "2"])
        kept = [json.loads(line) for line in text.splitlines()]
        check(rc == 0 and kept == [g for g in got if g["dist"] <= 2],
              f"{label} approx --both --max-errors 2: exit {rc}, {len(kept)} lines")
        head = os.path.join(workdir, f"approx_{codec}_head.nup")
        n_head = APPROX_CIGAR_READS
        cli.write_nup(head, names[:n_head], packed[:n_head], lens[:n_head], codec)
        rc, text, wall3, _ = _run_cli(["approx", head, PRIMER.decode(), "--both", "--cigar"])
        lines = [json.loads(line) for line in text.splitlines()]
        check(rc == 0 and [{k: g[k] for k in ("record", "dist", "end", "strand")} for g in lines] == got[:n_head],
              f"{label} approx --both --cigar: exit {rc}, lines differ from --both")
        for i, g in enumerate(lines):
            if g["end"] == 0:
                check("cigar" not in g, f"{label} --cigar line {i} with end 0 has a CIGAR")
                continue
            q = PRIMER if g["strand"] == "+" else rc_primer
            edits, qn, tn = _cigar_edits(g["cigar"], q, seqs[i][g["start"] : g["end"]])
            check((edits, qn, tn) == (g["dist"], len(q), g["end"] - g["start"]),
                  f"{label} --cigar line {i}: {g} applies as {edits} edits over {qn} and {tn} nt")
        say(f"phase 5 approx {label}: --both --max-errors 2 kept {len(kept)} records ({wall2:.2f} s); --both "
            f"--cigar on the first {n_head} records ({wall3:.2f} s): every CIGAR applied to its window gives the "
            f"line's distance")
        if codec == "2bit":
            rc, text, wall4, _ = _run_cli(["approx", nup, PRIMER.decode(), "--all", "--max-errors", "1"])
            want_all = [{"record": names[k].decode(), "end": int(e), "strand": "+"}
                        for k, ends in enumerate(_ends_np(seqs, PRIMER, 1)) for e in ends]
            check(rc == 0 and [json.loads(line) for line in text.splitlines()] == want_all,
                  f"2-bit approx --all --max-errors 1: exit {rc}, output != numpy DP of every end")
            say(f"phase 5 approx 2-bit: --all --max-errors 1: {len(want_all)} ends == a numpy DP of every end "
                f"({wall4:.2f} s)")
        else:
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = cli.main(["approx", nup, PRIMER.decode(), "--all", "--max-errors", "1"])
            check(rc == 1 and err.getvalue().startswith("error: --all is 2-bit only"),
                  f"base-5 approx --all: exit {rc}, {err.getvalue()!r}")
            say("phase 5 approx base-5: --all exits 1 (2-bit only)")


# --- the parallel layer: phase 9 ----------------------------------------------------

#: the flag that runs this script as one rank of phase 9's two-rank group
PARALLEL_RANK = "--parallel-rank"


def _start_ranks(workdir: str, seed: int):
    """Phase 9's two ranks, started: this script with PARALLEL_RANK
    (:func:`rank_child`), run from its own checkout; both on cuda:0, the one
    card, joined by a gloo group (NCCL takes one rank a card)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        coord = f"localhost:{s.getsockname()[1]}"
    outs = [os.path.join(workdir, f"rank{r}.npz") for r in range(2)]
    script = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, script, PARALLEL_RANK, str(r), coord, outs[r], str(seed)],
                              cwd=os.path.dirname(script), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    return procs, outs


def rank_child(rank: int, coord: str, out: str, seed: int) -> int:
    """One rank of phase 9's two-rank group on cuda:0.  It joins a gloo group
    of its own (``runtime.initialize`` takes it as it is), streams the seeded
    reads (its residue class), then calls every form of the parallel layer
    on the process mesh -- data = 2 (``default_mesh()``) and seq = 2, one
    entry a rank -- with the whole input, each against its own one-device
    call on that input, bit for bit: its own shard of a sharded result, the
    whole of a replicated one, ``np.asarray`` of a sharded one raising.
    Every form is timed once (CUDA events around the checked call, after a
    barrier, so both ranks start it together, and after the one-device call
    that warmed its kernels), and every one-device call at its second
    call.  Saves what it sank, the launches of the layer's own
    calls, its collectives by backend and the times.  A failing check or
    collective raises (a collective waits 120 s for its peer)."""
    import datetime

    import torch

    from cute_nucleotides_tpu_torch import api, interop, parallel
    from cute_nucleotides_tpu_torch.models import Base5Codec, TwoBitCodec
    from cute_nucleotides_tpu_torch.ops import align, kmer, search, sketch
    from cute_nucleotides_tpu_torch.parallel import longseq, mesh as mesh_lib, runtime
    from cute_nucleotides_tpu_torch.utils import io as io_lib

    torch.distributed.init_process_group("gloo", init_method=f"tcp://{coord}", world_size=2, rank=rank,
                                         timeout=datetime.timedelta(seconds=120))
    info = runtime.initialize()
    mesh = parallel.default_mesh()
    check(info == {"process_index": rank, "process_count": 2, "local_devices": 1, "global_devices": 2}
          and mesh.size == 2 and mesh.rank == rank, f"rank {rank}: initialize {info}, default mesh {mesh}")

    # the stream: this rank's residue class of the seeded reads
    seqs = np.random.default_rng(seed).choice(np.frombuffer(ALPHABET, np.uint8), (RANK_READS, RANK_NT))
    records = [io_lib.Record(b"r%d" % i, seqs[i].tobytes()) for i in range(RANK_READS)]
    idx, rows = [], []

    def sink(words, b):
        idx.extend(b.indices[: b.count].tolist())
        rows.append(np.array(words[: b.count]))

    agg = runtime.StreamingEncoder(batch_size=RANK_BATCH, max_len=160, codec="2bit").run(records, sink=sink)

    par, times, dp = _LayerLaunches(), {}, parallel.data_parallel
    half = slice(rank * BATCH_ROWS // 2, (rank + 1) * BATCH_ROWS // 2)

    def timed(label, fn, *args, **kwargs):  # a one-device call: its second call timed
        fn(*args, **kwargs)
        got, times[label] = _plain_once(lambda: fn(*args, **kwargs))
        return got

    def form(label, fn, *args, **kwargs):  # the layer's own calls: counted, and timed once, after the one-device
        torch.distributed.barrier()  # call warmed their kernels and with both ranks starting together
        got, times[label] = _plain_once(lambda: par(fn, *args, **kwargs))
        return got

    def u8(t):
        return t.contiguous().view(torch.uint8)

    def own(got, want, what):
        check(not got.replicated and got.axis.mine == (rank,) and len(got.shards) == 1, f"rank {rank} {what}: {got}")
        check(torch.equal(u8(got.shards[0]), u8(want[half])), f"rank {rank} {what}: its shard != its block of the "
              f"one-device call")
        try:
            np.asarray(got)
        except RuntimeError:
            return
        raise SmokeFailure(f"rank {rank} {what}: np.asarray of a sharded value across ranks did not raise")

    def whole(got, want, what):
        check(got.replicated and torch.equal(u8(got.full()), u8(want)), f"rank {rank} {what} != the one-device call")

    def flag(nbad, bad, what):
        check(int(np.asarray(nbad)) == int(bad.any()), f"rank {rank} {what}: flag {np.asarray(nbad)} against {bad}")

    # the codec forms on phase 3's batches, made on the card from the seed (every rank the same)
    x = _make_batch(seed)
    c2 = TwoBitCodec(device="cuda")
    w2 = timed("TwoBitCodec.encode", c2.encode, x)
    own(form("data_parallel_encode", dp.data_parallel_encode, x, mesh=mesh), w2, "data_parallel_encode")
    whole(form("data_parallel_encode gather", dp.data_parallel_encode, x, mesh=mesh, gather=True), w2,
          "data_parallel_encode gather")
    own(form("data_parallel_encode mxu", dp.data_parallel_encode, x, mesh=mesh, variant="mxu"), w2, "encode mxu")
    d2 = timed("TwoBitCodec.decode", c2.decode, w2)
    own(form("data_parallel_decode", dp.data_parallel_decode, w2, mesh=mesh), d2, "data_parallel_decode")
    whole(form("data_parallel_decode gather", dp.data_parallel_decode, w2, mesh=mesh, gather=True), d2,
          "data_parallel_decode gather")
    w2b, bad2 = timed("TwoBitCodec.encode_checked", c2.encode_checked, x)
    for gather in (False, True):
        got, nbad = form(f"data_parallel_encode_checked{' gather' * gather}", dp.data_parallel_encode_checked, x,
                         mesh=mesh, gather=gather)
        (whole if gather else own)(got, w2b, f"data_parallel_encode_checked gather={gather}")
        flag(nbad, bad2, "data_parallel_encode_checked")
    sc = parallel.ShardedCodec(mesh=mesh)
    placed = form("ShardedCodec.shard", sc.shard, x)
    own(placed, x, "ShardedCodec.shard")
    enc = form("ShardedCodec.encode", sc.encode, placed)
    own(enc, w2, "ShardedCodec.encode")
    own(form("ShardedCodec.decode", sc.decode, enc), d2, "ShardedCodec.decode")
    whole(form("ShardedCodec.encode gather", sc.encode, placed, gather=True), w2, "ShardedCodec.encode gather")
    del x, d2, w2b, got, placed, enc
    torch.cuda.empty_cache()
    x5 = _make_batch(seed + 1, B5_NT, ALPHABET_N)
    c5 = Base5Codec(device="cuda")
    w5 = timed("Base5Codec.encode", c5.encode, x5)
    own(form("data_parallel_encode b5", dp.data_parallel_encode, x5, mesh=mesh, codec="base5"), w5, "base-5 encode")
    whole(form("data_parallel_encode b5 gather", dp.data_parallel_encode, x5, mesh=mesh, codec="base5", gather=True),
          w5, "base-5 encode gather")
    d5 = timed("Base5Codec.decode", c5.decode, w5)
    own(form("data_parallel_decode b5", dp.data_parallel_decode, w5, mesh=mesh, codec="base5"), d5, "base-5 decode")
    whole(form("data_parallel_decode b5 gather", dp.data_parallel_decode, w5, mesh=mesh, codec="base5", gather=True),
          d5, "base-5 decode gather")
    w5b, bad5 = timed("Base5Codec.encode_checked", c5.encode_checked, x5)
    for gather in (False, True):
        got, nbad = form(f"data_parallel_encode_checked b5{' gather' * gather}", dp.data_parallel_encode_checked, x5,
                         mesh=mesh, codec="base5", gather=gather)
        (whole if gather else own)(got, w5b, f"base-5 encode_checked gather={gather}")
        flag(nbad, bad5, "base-5 encode_checked")
    d5b, dbad5 = timed("Base5Codec.decode_checked", c5.decode_checked, w5)
    got, nbad = form("data_parallel_decode_checked", dp.data_parallel_decode_checked, w5, mesh=mesh)
    own(got, d5b, "data_parallel_decode_checked")
    flag(nbad, dbad5, "data_parallel_decode_checked")
    sc5 = parallel.ShardedCodec("base5", mesh=mesh)
    got, nbad = form("ShardedCodec b5 encode_checked gather", sc5.encode_checked, x5, gather=True)
    whole(got, w5b, "ShardedCodec base-5 encode_checked gather")
    flag(nbad, bad5, "ShardedCodec base-5 encode_checked")
    got, nbad = form("ShardedCodec b5 decode_checked", sc5.decode_checked, w5)
    own(got, d5b, "ShardedCodec base-5 decode_checked")
    flag(nbad, dbad5, "ShardedCodec base-5 decode_checked")
    del x5, d5, w5b, d5b, got
    torch.cuda.empty_cache()

    # the analyses: a psum, two all_gathers, an all_gather + merge, an all_gather
    want = timed("kmer_histogram_batch", kmer.kmer_histogram_batch, w2, BATCH_NT, 8)
    whole(form("kmer_spectrum", parallel.kmer_spectrum, w2, BATCH_NT, 8, mesh=mesh), want, "kmer_spectrum k=8")
    want = timed("match_counts_batch", search.match_counts_batch, w2[:64], BATCH_NT, b"GANTACA")
    whole(form("match_counts", parallel.match_counts, w2[:64], BATCH_NT, b"GANTACA", mesh=mesh), want,
          "match_counts")
    want = timed("match_counts_batch b5", search.match_counts_batch, w5[:64], B5_NT, b"CAT?AGN", codec="base5")
    whole(form("match_counts b5", parallel.match_counts, w5[:64], B5_NT, b"CAT?AGN", mesh=mesh, codec="base5"),
          want, "base-5 match_counts")
    sub = w2[:256]
    lens = torch.full((sub.shape[0],), BATCH_NT, dtype=torch.int32, device="cuda")
    lens[1::7] = BATCH_NT - 1000
    want = timed("bottom_k_sketch_batch", sketch.bottom_k_sketch_batch, sub, lens, SKETCH_K, SKETCH_S)
    whole(form("sketch_sharded", parallel.sketch_sharded, sub, lens, SKETCH_K, SKETCH_S, mesh=mesh), want,
          f"sketch_sharded k={SKETCH_K}")
    _, _, qw, tw = _align_batch(np.random.default_rng(seed))
    ql = torch.full((qw.shape[0],), ALIGN_QM, dtype=torch.int32, device="cuda")
    tl = torch.full((qw.shape[0],), ALIGN_TN, dtype=torch.int32, device="cuda")
    want = timed("edit_distance_packed", align.edit_distance_packed, qw, ql, tw, tl)
    whole(form("edit_distances", parallel.edit_distances, qw, ALIGN_QM, tw, ALIGN_TN, mesh=mesh), want,
          "edit_distances")
    del w2, w5, sub, qw, tw, want
    torch.cuda.empty_cache()

    # the long-sequence mode at chr1 length on seq = 2, hits and near hits across the seam
    seq2 = parallel.make_mesh(1, 2)
    check(seq2.axis(mesh_lib.SEQ_AXIS).mine == (rank,), f"rank {rank}: seq axis {seq2}")
    q2, q5 = b"GATTACANGATTACANGATTACANGATTACAN", b"CATTAG?NCATTAG?NCATTAG?N"
    t2, t5 = q2.replace(b"N", b"T"), q5.replace(b"?", b"G")
    s2 = _seam_starts(2 * -(-CHR1_NT // 32), 16, 2, 7)
    s5 = _seam_starts(-(-CHR1_NT // 27), 27, 2, 11)
    b2, b5 = bytearray(t2), bytearray(t5)
    b2[16], b5[9] = ord("C"), ord("G")  # one substitution each: the best match across the seam is at distance 1
    seq = _random_seq()
    chr2, chr5 = _with_hits(seq, s2, t2), _with_hits(seq, s5, t5)
    del seq
    want2 = timed("api.n_to_bits", api.n_to_bits, chr2)
    check(np.array_equal(form("encode_long_2bit", longseq.encode_long_2bit, chr2, mesh=seq2), want2),
          f"rank {rank} encode_long_2bit")
    want5 = timed("api.n_to_bits2", api.n_to_bits2, chr5)
    check(np.array_equal(form("encode_long_b5", longseq.encode_long_b5, chr5, mesh=seq2), want5),
          f"rank {rank} encode_long_b5")
    back2 = timed("api.bits_to_n", api.bits_to_n, want2, CHR1_NT)
    check(np.array_equal(form("decode_long_2bit", longseq.decode_long_2bit, want2, CHR1_NT, mesh=seq2), back2),
          f"rank {rank} decode_long_2bit")
    back5 = timed("api.bits_to_n2", api.bits_to_n2, want5, CHR1_NT)
    check(np.array_equal(form("decode_long_b5", longseq.decode_long_b5, want5, CHR1_NT, mesh=seq2), back5),
          f"rank {rank} decode_long_b5")
    del chr2, chr5, back2, back5
    ww2, ww5 = interop.u64_to_tensor(want2, "cuda"), interop.u64_to_tensor(want5, "cuda")
    m2 = timed("search.match_positions", search.match_positions, ww2, CHR1_NT, q2)
    m5 = timed("search.match_positions_b5", search.match_positions_b5, ww5, CHR1_NT, q5)
    check(set(s2) <= set(m2.tolist()) and set(s5) <= set(m5.tolist()), f"rank {rank}: a planted hit is missing")
    check(np.array_equal(form("match_long", longseq.match_long, ww2, CHR1_NT, q2, mesh=seq2), m2),
          f"rank {rank} match_long")
    check(np.array_equal(form("match_long_b5", longseq.match_long_b5, ww5, CHR1_NT, q5, mesh=seq2), m5),
          f"rank {rank} match_long_b5")
    best2 = timed("align.best_match_stream", align.best_match_stream, ww2, CHR1_NT, bytes(b2))
    best5 = timed("align.best_match_stream_b5", align.best_match_stream_b5, ww5, CHR1_NT, bytes(b5))
    check(best2[0] == best5[0] == 1, f"rank {rank}: the planted near hits {best2}, {best5}")
    check(form("best_match_long", longseq.best_match_long, ww2, CHR1_NT, bytes(b2), mesh=seq2) == best2,
          f"rank {rank} best_match_long")
    check(form("best_match_long_b5", longseq.best_match_long_b5, ww5, CHR1_NT, bytes(b5), mesh=seq2) == best5,
          f"rank {rank} best_match_long_b5")
    torch.cuda.synchronize()
    launches, collectives = dict(par.counts), dict(mesh_lib._COLLECTIVES)
    check(all(launches[k] > 0 for k in PARALLEL_KERNELS), f"rank {rank}: a kernel of the path never launched in the "
          f"layer's own calls: {launches}")
    check(set(collectives) == {"gloo"} and collectives["gloo"] > 0, f"rank {rank}: collectives {collectives}")
    np.savez(out, idx=np.asarray(idx, np.int64), words=np.concatenate(rows), reads=agg["total_reads"],
             device=torch.cuda.current_device(), host=agg["host_id"], hosts=agg["num_hosts"],
             report=np.array(json.dumps({"launches": launches, "collectives": collectives, "ms": times})))
    torch.distributed.destroy_process_group()
    return 0


def _check_ranks(procs, outs, seed: int) -> list:
    """Each rank passed its checks, sank exactly its residue class of records,
    on cuda:0; the union is every record, bit-exact against the host oracle.
    Returns each rank's report (launches, collectives, times)."""
    from cute_nucleotides_tpu_torch.ops import native

    seen, reports = {}, []
    for r, (p, out) in enumerate(zip(procs, outs)):
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            raise SmokeFailure(f"rank {r} of the two-rank group did not finish in 300 s") from None
        check(p.returncode == 0, f"rank {r} of the two-rank group exited {p.returncode}: {err[-3000:]}")
        z = np.load(out)
        check((int(z["host"]), int(z["hosts"]), int(z["device"])) == (r, 2, 0),
              f"rank {r}: host {z['host']} of {z['hosts']} on cuda:{z['device']}")
        idx = z["idx"]
        check(int(z["reads"]) == idx.size and bool(np.all(idx % 2 == r)), f"rank {r} sank another residue class")
        seen.update(zip(idx.tolist(), z["words"]))
        reports.append(json.loads(str(z["report"])))
    check(sorted(seen) == list(range(RANK_READS)), "the two ranks did not cover every record once")
    seqs = np.random.default_rng(seed).choice(np.frombuffer(ALPHABET, np.uint8), (RANK_READS, RANK_NT))
    per = -(-RANK_NT // 32)
    for i in range(RANK_READS):
        check(np.array_equal(seen[i].view("<u8")[:per], native.n_to_bits(seqs[i])),
              f"record {i} of the two-rank stream != host oracle")
    return reports


def _random_seq() -> np.ndarray:
    """A chr1-length ACGTUN sequence (upper and lower case) made on the card
    from the seed, on the host."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 29)
    table = torch.tensor(np.frombuffer(ALPHABET_N, np.uint8), device="cuda")
    return table[torch.randint(0, len(ALPHABET_N), (CHR1_NT,), device="cuda", generator=g)].cpu().numpy()


def _with_hits(seq: np.ndarray, starts: list, text: bytes) -> np.ndarray:
    out = seq.copy()
    for p in starts:
        out[p : p + len(text)] = np.frombuffer(text, np.uint8)
    return out


def _seam_starts(units: int, per: int, shards: int, back: int) -> list:
    """Starts ``back`` nt before each seam of a halo scan's split of
    ``units`` words of ``per`` nt over ``shards``."""
    w_eq = -(-units // shards)
    return [per * k * w_eq - back for k in range(1, shards)]


class _LayerLaunches:
    """The launches of the calls made through it alone: ``tally(fn, *args)``
    calls ``fn`` and adds the change of every wrapper's count, so the
    one-device calls that a check compares against, and timing loops, count
    nothing."""

    def __init__(self):
        from cute_nucleotides_tpu_torch.ops import kernels as K

        self.wrappers = K.WRAPPERS
        self.counts = {w.__name__: 0 for w in K.WRAPPERS}

    def __call__(self, fn, *args, **kwargs):
        before = [w.launches for w in self.wrappers]
        out = fn(*args, **kwargs)
        for w, n in zip(self.wrappers, before):
            self.counts[w.__name__] += w.launches - n
        return out


def _lap(label: str, t0: float, laps: list) -> float:
    t = time.perf_counter()
    laps.append(f"{label} {t - t0:.2f} s")
    return t


def _one_rank_nccl(par, c2, x, words, ww2) -> str:
    """A one-rank NCCL group in this process (``runtime.initialize`` with a
    coordinator and one process): ``default_mesh()`` is a process mesh of
    this rank's card, and ``data_parallel_encode(gather=True)``,
    ``kmer_spectrum`` and ``best_match_long`` run their collectives through
    ``torch.distributed``'s NCCL backend; each against the one-device call
    (``c2`` is a ``TwoBitCodec`` on the card), timed once (CUDA events)
    beside it (timed at its second call).  The group is destroyed before anything else runs."""
    import socket

    import torch

    from cute_nucleotides_tpu_torch import parallel
    from cute_nucleotides_tpu_torch.ops import align, kmer
    from cute_nucleotides_tpu_torch.parallel import longseq, mesh as mesh_lib, runtime

    with socket.socket() as s:
        s.bind(("localhost", 0))
        coord = f"localhost:{s.getsockname()[1]}"
    t0 = time.perf_counter()
    info = runtime.initialize(coord, 1, 0)
    try:
        join_s = time.perf_counter() - t0
        mesh = parallel.default_mesh()
        check(torch.distributed.get_backend() == "nccl" and mesh.rank == 0 and mesh.size == info["global_devices"] == 1,
              f"one-rank group: backend {torch.distributed.get_backend()}, initialize {info}, default mesh {mesh}")
        before = mesh_lib._COLLECTIVES["nccl"]
        nt, q = 16 * words.shape[1], b"GATTACAGATTACAGATTACA"
        def second(fn):  # a one-device call, timed at its second call
            fn()
            return _plain_once(fn)

        w2, enc_one = second(lambda: c2.encode(x))
        got, enc_ms = _plain_once(lambda: par(parallel.data_parallel_encode, x, mesh=mesh, gather=True))
        check(got.replicated and torch.equal(got.full().view(torch.int32), w2.view(torch.int32)),
              "data_parallel_encode(gather=True) over NCCL != TwoBitCodec.encode")
        want, hist_one = second(lambda: kmer.kmer_histogram_batch(words, nt, 8))
        got, hist_ms = _plain_once(lambda: par(parallel.kmer_spectrum, words, nt, 8, mesh=mesh))
        check(torch.equal(got.full(), want), "kmer_spectrum over NCCL != kmer_histogram_batch")
        want, best_one = second(lambda: align.best_match_stream(ww2, CHR1_NT, q))
        got, best_ms = _plain_once(lambda: par(longseq.best_match_long, ww2, CHR1_NT, q, mesh=mesh))
        check(got == want, f"best_match_long over NCCL {got} != best_match_stream {want}")
        ran = mesh_lib._COLLECTIVES["nccl"] - before
        check(ran >= 3, f"{ran} NCCL collectives for three forms")
    finally:
        torch.distributed.destroy_process_group()
    return (f"joined in {join_s:.2f} s ({info}); {ran} NCCL collectives; data_parallel_encode gather {enc_ms:.4f} "
            f"ms against TwoBitCodec.encode {enc_one:.4f}, kmer_spectrum k=8 {hist_ms:.4f} "
            f"ms against kmer_histogram_batch {hist_one:.4f}, best_match_long {best_ms:.4f} ms against "
            f"best_match_stream {best_one:.4f} on {CHR1_NT} nt, each == the one-device call; group destroyed")


def phase_parallel(rng, x, x5, words, words5, align_words, workdir: str) -> dict:
    """The parallel layer on the card (``parallel/``), each result against
    the one-device call on the same input, bit for bit: the data-parallel
    codec forms on the phase-3 batches on the default (one-card) mesh and on
    PAR_SHARDS logical shards of cuda:0, gathered and not, with the
    one-card encode timed beside ``TwoBitCodec.encode``; ``kmer_spectrum``
    (k = 8), ``sketch_sharded`` (k = 21), ``match_counts`` and
    ``edit_distances`` (phase 3's align batch); the long-sequence mode on a
    chr1-length sequence (seq = 1 and PAR_SHARDS) against the api and the
    one-stream search, hits planted across every seam; ``best_match_long``
    on one 2-bit stream of BIG_NT nt (past 2^31, which ``best_match_stream``
    refuses) on 2 seq shards, against the planted ends and the host Myers
    on their windows; a one-rank NCCL group (:func:`_one_rank_nccl`); and two
    ranks on cuda:0 in a gloo group (:func:`rank_child`: the stream and
    every form on a process mesh).  Returns the launches of the parallel
    layer's own calls in this process (the checked ones, not the one-device
    calls nor the timing loops); each rank checks its own."""
    import torch

    from cute_nucleotides_tpu_torch import api, interop, parallel
    from cute_nucleotides_tpu_torch.models import Base5Codec, TwoBitCodec
    from cute_nucleotides_tpu_torch.ops import align, kmer, native, search, sketch
    from cute_nucleotides_tpu_torch.parallel import longseq

    t_start = t0 = time.perf_counter()
    laps = []
    say(f"phase 9 parallel: clocks {_clocks()}")
    dev = torch.device("cuda", 0)
    one = parallel.default_mesh()
    check(one.size == torch.cuda.device_count() == 1, f"default mesh {one} on {torch.cuda.device_count()} cards")
    data4 = parallel.make_mesh(PAR_SHARDS, 1, devices=[dev] * PAR_SHARDS)
    seq4 = parallel.make_mesh(1, PAR_SHARDS, devices=[dev] * PAR_SHARDS)
    dp = parallel.data_parallel
    par = _LayerLaunches()

    def same(got, want, what):
        full = got.full()
        check(full.shape == want.shape and torch.equal(full.view(torch.uint8), want.contiguous().view(torch.uint8)),
              f"{what} != the one-device call")
        if got.replicated:  # logical shards of one card share one gathered tensor
            check(all(s.data_ptr() == full.data_ptr() for s in got.shards), f"{what}: a gather copied per shard")

    # the data-parallel codec forms on the 1-Gnt batches
    c2, c5 = TwoBitCodec(device="cuda"), Base5Codec(device="cuda")
    w2 = c2.encode(x)
    w2b, bad2 = c2.encode_checked(x)
    d2 = c2.decode(w2)
    for mesh, name in ((one, "one card"), (data4, f"data={PAR_SHARDS}")):
        for gather in (False, True):
            got = par(dp.data_parallel_encode, x, mesh=mesh, gather=gather)
            check(len(got.shards) == mesh.shape["data"], f"encode on {name}: {got}")
            same(got, w2, f"data_parallel_encode on {name}, gather={gather}")
            same(par(dp.data_parallel_decode, got, mesh=mesh, gather=gather), d2,
                 f"data_parallel_decode on {name}, gather={gather}")
            del got
        got, nbad = par(dp.data_parallel_encode_checked, x, mesh=mesh, gather=True)
        same(got, w2b, f"data_parallel_encode_checked on {name}")
        check(int(np.asarray(nbad)) == int(bad2.any()), f"encode_checked flag on {name}")
        same(par(dp.data_parallel_encode, x, mesh=mesh, variant="mxu"), w2, f"data_parallel_encode mxu on {name}")
        del got
    del d2, w2b
    one_ms = [_time_ms(fn, 20) for fn in (lambda: c2.encode(x), lambda: dp.data_parallel_encode(x, mesh=one),
                                          lambda: dp.data_parallel_encode(x, mesh=one), lambda: c2.encode(x))]
    codec_ms, dp_ms = min(one_ms[0], one_ms[3]), min(one_ms[1], one_ms[2])
    check(dp_ms <= 1.02 * codec_ms, f"data_parallel_encode on one card {dp_ms:.4f} ms > 1.02 x TwoBitCodec.encode "
          f"{codec_ms:.4f} ms")
    w5, d5 = c5.encode(x5), c5.decode(words5)
    w5b, bad5 = c5.encode_checked(x5)
    d5b, dbad5 = c5.decode_checked(words5)
    for mesh, name in ((one, "one card"), (data4, f"data={PAR_SHARDS}")):
        same(par(dp.data_parallel_encode, x5, mesh=mesh, codec="base5", gather=True), w5, f"base-5 encode on {name}")
        same(par(dp.data_parallel_decode, words5, mesh=mesh, codec="base5"), d5, f"base-5 decode on {name}")
        got, nbad = par(dp.data_parallel_encode_checked, x5, mesh=mesh, codec="base5")
        same(got, w5b, f"base-5 encode_checked on {name}")
        check(int(np.asarray(nbad)) == int(bad5), f"base-5 encode_checked flag on {name}")
        got, nbad = par(dp.data_parallel_decode_checked, words5, mesh=mesh)
        same(got, d5b, f"base-5 decode_checked on {name}")
        check(int(np.asarray(nbad)) == int(dbad5), f"base-5 decode_checked flag on {name}")
        del got
    del w5, d5, w5b, d5b
    torch.cuda.empty_cache()
    t0 = _lap("data-parallel codec", t0, laps)
    rank_seed = SEED + 31  # the two ranks run beside the checks below: the times taken below share the card
    procs, outs = _start_ranks(workdir, rank_seed)

    # the analyses: a psum, an all_gather + merge, two all_gathers
    rows, nt = words.shape[0], 16 * words.shape[1]
    same(par(parallel.kmer_spectrum, words, nt, 8, mesh=data4), kmer.kmer_histogram_batch(words, nt, 8),
         f"kmer_spectrum k=8 on data={PAR_SHARDS}")
    sub = words[: rows // 16]
    lens = torch.full((sub.shape[0],), nt, dtype=torch.int32, device="cuda")
    lens[1::7] = nt - 1000
    same(par(parallel.sketch_sharded, sub, lens, SKETCH_K, SKETCH_S, mesh=data4),
         sketch.bottom_k_sketch_batch(sub, lens, SKETCH_K, SKETCH_S), f"sketch_sharded k={SKETCH_K}")
    few = words[: 8 * PAR_SHARDS]
    same(par(parallel.match_counts, few, nt, b"GANTACA", mesh=data4), search.match_counts_batch(few, nt, b"GANTACA"),
         "match_counts")
    qw, tw = align_words
    ql = torch.full((qw.shape[0],), ALIGN_QM, dtype=torch.int32, device="cuda")
    tl = torch.full((qw.shape[0],), ALIGN_TN, dtype=torch.int32, device="cuda")
    same(par(parallel.edit_distances, qw, ALIGN_QM, tw, ALIGN_TN, mesh=data4), align.edit_distance_packed(qw, ql, tw, tl),
         f"edit_distances on data={PAR_SHARDS}")
    torch.cuda.empty_cache()
    t0 = _lap("analyses", t0, laps)

    # the long-sequence mode on a chr1-length sequence, hits across every seam
    q2, q5 = b"GATTACANGATTACANGATTACANGATTACAN", b"CATTAG?NCATTAG?NCATTAG?N"  # N, ? the wildcards
    s2 = _seam_starts(2 * -(-CHR1_NT // 32), 16, PAR_SHARDS, 7)
    s5 = _seam_starts(-(-CHR1_NT // 27), 27, PAR_SHARDS, 11)
    seq = _random_seq()  # the two codecs' seams lie within a few nt, so each plants into its own copy
    seq2, seq5 = _with_hits(seq, s2, q2.replace(b"N", b"T")), _with_hits(seq, s5, q5.replace(b"?", b"G"))
    del seq
    want2, want5 = api.n_to_bits(seq2), api.n_to_bits2(seq5)
    back2, back5 = api.bits_to_n(want2, CHR1_NT), api.bits_to_n2(want5, CHR1_NT)
    for mesh, name in ((one, "seq=1"), (seq4, f"seq={PAR_SHARDS}")):
        check(np.array_equal(par(longseq.encode_long_2bit, seq2, mesh=mesh), want2), f"encode_long_2bit on {name}")
        check(np.array_equal(par(longseq.encode_long_b5, seq5, mesh=mesh), want5), f"encode_long_b5 on {name}")
        check(np.array_equal(par(longseq.decode_long_2bit, want2, CHR1_NT, mesh=mesh), back2), f"decode_long_2bit {name}")
        check(np.array_equal(par(longseq.decode_long_b5, want5, CHR1_NT, mesh=mesh), back5), f"decode_long_b5 {name}")
    del back2, back5, seq2, seq5
    t0 = _lap("long encode/decode", t0, laps)
    ww2, ww5 = interop.u64_to_tensor(want2, "cuda"), interop.u64_to_tensor(want5, "cuda")
    m2, m5 = search.match_positions(ww2, CHR1_NT, q2), search.match_positions_b5(ww5, CHR1_NT, q5)
    check(set(s2) <= set(m2.tolist()) and set(s5) <= set(m5.tolist()), "a hit planted across a seam is missing")
    for mesh, name in ((one, "seq=1"), (seq4, f"seq={PAR_SHARDS}")):
        check(np.array_equal(par(longseq.match_long, want2, CHR1_NT, q2, mesh=mesh), m2), f"match_long on {name}")
        check(np.array_equal(par(longseq.match_long, ww2, CHR1_NT, q2, mesh=mesh), m2), f"match_long of words, {name}")
        check(np.array_equal(par(longseq.match_long_b5, ww5, CHR1_NT, q5, mesh=mesh), m5), f"match_long_b5 on {name}")
    t0 = _lap("long search", t0, laps)
    nccl = _one_rank_nccl(par, c2, x, words, ww2)
    del ww2, ww5, want2, want5
    t0 = _lap("one-rank NCCL group", t0, laps)
    say(f"phase 9 parallel: data_parallel_encode/decode(_checked) and mxu on one card and on data={PAR_SHARDS} "
        f"logical shards, gathered and not, == the one-device codec on the 1-Gnt batches (flags "
        f"{int(bad2.any())}/{int(bad5)}/{int(dbad5)}); on one card data_parallel_encode {dp_ms:.4f} ms against "
        f"TwoBitCodec.encode {codec_ms:.4f} ms ({100 * (dp_ms / codec_ms - 1):+.2f}%; runs "
        f"{'/'.join(f'{v:.4f}' for v in one_ms)}, CUDA events, 20 calls each); kmer_spectrum, sketch_sharded, "
        f"match_counts, edit_distances == their one-device calls; encode/decode_long (both codecs) and "
        f"match_long(_b5) ({m2.size} and {m5.size} hits, {len(s2)} and {len(s5)} planted across the seams) on "
        f"{CHR1_NT} nt, seq=1 and {PAR_SHARDS}, == api and the one-stream search")

    # best_match_long past 2^31 nt: one random 2-bit stream, a 32-nt query
    # planted with one substitution across the seam of 2 seq shards (before
    # 2^31) and after 2^31; a second query only after 2^31
    W = -(-BIG_NT // 16)
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 37)
    big = torch.randint(-2**31, 2**31, (W,), dtype=torch.int64, device="cuda", generator=g).to(torch.int32)
    big[-1] &= (1 << (2 * (BIG_NT % 16))) - 1  # the bits past the last nt zero
    acgt = np.frombuffer(b"ACGT", np.uint8)
    qa, qb = (rng.choice(acgt, 32).tobytes() for _ in range(2))
    seam = 16 * -(-W // 2)
    planted = {}
    for q, p in ((qa, seam - 16), (qa, 16 * ((2**31 + 16_000) // 16)), (qb, 16 * ((2**31 + 12_444_432) // 16))):
        mut = bytearray(q)
        mut[16] = b"ACGT"[(b"ACGT".index(mut[16]) + 1) % 4]  # one substitution mid-query
        big[p // 16 : p // 16 + 2] = interop.u64_to_tensor(native.n_to_bits(bytes(mut)), "cuda").view(torch.int32)
        planted.setdefault(q, p)
    big = big.view(torch.uint32)
    two = parallel.make_mesh(1, 2, devices=[dev] * 2)
    torch.cuda.synchronize()
    t0 = _lap(f"{BIG_NT}-nt stream", t0, laps)
    found = []
    for q, p in planted.items():
        (d, e), wall, prof = _profiled(lambda q=q: par(longseq.best_match_long, big, BIG_NT, q, mesh=two))
        lo = p - 64
        win = big[lo // 16 : (p + 96) // 16].view(torch.int32)
        w64 = interop.tensor_to_u64(torch.cat([win, win.new_zeros(win.numel() % 2)]).view(torch.uint32))
        wd, we = native.best_match(q, native.bits_to_n(w64, p + 96 - lo).tobytes())
        check((d, e) == (1, p + 32) == (wd, lo + we), f"best_match_long {q.decode()}: {(d, e)}; planted end "
              f"{p + 32}; the host Myers on its window {(wd, lo + we)}")
        found.append(f"{q.decode()} -> (1, {e}): {_breakdown(wall, prof)}")
    big_ms = _time_ms(lambda: longseq.best_match_long(big, BIG_NT, qa, mesh=two), 3)
    try:
        align.best_match_stream(big, BIG_NT, qa)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    check(refused is not None and "parallel.longseq.best_match_long" in refused,
          f"best_match_stream on {BIG_NT} nt: {refused}")
    del big
    torch.cuda.empty_cache()
    t0 = _lap("best_match_long", t0, laps)
    say(f"phase 9 best_match_long over {BIG_NT} nt on 2 seq shards == (1, the planted end), the host Myers on "
        f"each window agreeing: {'; '.join(found)}")
    say(f"  best_match_long, {BIG_NT} nt: {big_ms:.4f} ms a call (CUDA events over 3 calls, the host merge "
        f"included); best_match_stream refuses the stream: {refused}")
    say(f"phase 9 one-rank NCCL group: {nccl}")
    reports = _check_ranks(procs, outs, rank_seed)
    say(f"phase 9 two ranks on cuda:0 (a gloo group; process mesh data = 2 and seq = 2): every form == the rank's "
        f"one-device call on the whole input (its own shard, the whole of a gathered result, np.asarray of a "
        f"sharded one raising); ranks 0 and 1 each sank their residue class of {RANK_READS} x {RANK_NT}-nt reads "
        f"== host oracle")
    for r, rep in enumerate(reports):
        say(f"  rank {r}: collectives {rep['collectives']}; the layer's own launches {rep['launches']}")
        say(f"  rank {r} ms (CUDA events; each form one call, each one-device call its second): "
            f"{'; '.join(f'{k} {v:.4f}' for k, v in rep['ms'].items())}")
    _lap("two ranks (the rest of their wait)", t0, laps)
    say(f"phase 9 parallel done ({time.perf_counter() - t_start:.1f} s with the checks: {'; '.join(laps)}); "
        f"clocks {_clocks()}")
    return par.counts


# --- the bench: phase 7 -------------------------------------------------------------

def phase_bench(workdir: str) -> None:
    """``python -m cute_nucleotides_tpu_torch bench`` in a child process at
    BENCH_ENV, its detail file in the work directory: exit 0, the last
    stdout line with the reference's keys, all BENCH_ROWS rows above 0, and
    the planar rows' launches of #15-#17."""
    detail_path = os.path.join(workdir, "bench_detail.json")
    env = dict(os.environ, **BENCH_ENV, BENCH_DETAIL_PATH=detail_path)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "cute_nucleotides_tpu_torch", "bench"], env=env,
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if "FAILED" in line or line.startswith(("error", "Traceback")):
            say(f"  bench: {line}")
    check(proc.returncode == 0, f"bench exit {proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    check(tuple(line) == BENCH_LINE_KEYS, f"bench last line keys {tuple(line)}")
    with open(detail_path) as f:
        detail = json.load(f)
    gibs = detail["detail"]
    check(len(gibs) == BENCH_ROWS and all(v > 0 for v in gibs.values()),
          f"bench rows: {len(gibs)}, at 0: {[k for k, v in gibs.items() if not v > 0]}")
    for row, fn in {**BENCH_PLANAR_ROWS, **BENCH_ALIGN_ROWS}.items():
        check(detail["launches"].get(row, {}).get(fn, 0) > 0, f"bench row {row} launched no {fn}: "
              f"{detail['launches'].get(row)}")
    gcups = line["champions_gibs"]["edit_distance_gcups"]
    check(gcups is not None and gcups > 0, f"bench edit_distance_gcups {gcups}")
    say(f"phase 7 bench ({' '.join(f'{k}={v}' for k, v in BENCH_ENV.items())}): {len(gibs)} rows in {wall:.1f} s "
        f"wall; planar rows (GiB/s of nt): "
        + ", ".join(f"{row} {gibs[row]:.1f} ({detail['launches'][row]})" for row in BENCH_PLANAR_ROWS))
    say(f"  bench align rows: " + ", ".join(f"{row} {detail['ms'][row]:.4f} ms ({gibs[row]:.1f} GiB/s)"
                                            for row in BENCH_ALIGN_ROWS))
    say(f"  bench headline: {json.dumps(line)}")


# --- timing -------------------------------------------------------------------

def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _clocks() -> str:
    """The card's SM clock (now and its maximum), power draw and temperature,
    as nvidia-smi reads them: integer-bound kernels scale with the clock."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() if smi.returncode == 0 else f"nvidia-smi failed: {smi.stderr.strip()}"


def _plain_once(fn) -> tuple:
    """One call (a plain version's, or phase 9's) between two CUDA events:
    (its output, ms)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _myers_entry_ms(args, iters: int) -> tuple:
    """#19 in semiglobal mode timed through its entry point ``cn_myers``
    with the outputs allocated once: at small shapes the wrapper's checks
    take longer than the kernel.  ``args`` are myers_scan's (2-bit, Peq
    contiguous per row); returns (ms a call, (best, first end))."""
    import torch

    from cute_nucleotides_tpu_torch.ops import _build, kernels as K

    peq, ql, words, tl, row_stride, row_len = args
    R, _, nb = peq.shape
    best, end = (torch.empty(R, dtype=torch.int32, device="cuda") for _ in range(2))
    scratch = torch.empty(2 * nb * R, dtype=torch.uint32, device="cuda")
    lib, stream = _build.load(), torch.cuda.current_stream().cuda_stream
    call = lambda: K._launch(lib.cn_myers, peq.data_ptr(), peq.stride(0), nb, ql.data_ptr(), words.data_ptr(),
                             words.numel(), row_stride, row_len, tl.data_ptr(), None, K.MYERS_MODES["semiglobal"], 0,
                             R, None, best.data_ptr(), end.data_ptr(), None, scratch.data_ptr(), stream)
    return min(_time_ms(call, iters) for _ in range(2)), (best, end)


def _time_myers(errors: Errors, align_words, chr1_words) -> tuple:
    """#19 at the bench's shape (the path's largest call: global mode on the
    phase-3 pairs) in turns with its plain version on the same inputs, which
    must agree with it, as must its semiglobal (best_match) form; on the
    chr1-length stream as ``best_match_stream`` cuts it (a 21-nt query),
    STREAM_CHECK_ROWS rows at each end of it held to the plain version,
    then #19's stream form (what ``best_match_stream`` runs) on the same
    rows, its key held to the rows' path's; and at a phase-2 size beside the plain version.  Each beside its bound
    (utils.profiling.myers_ops) but the last, with the launch plan each
    takes (``kernels.myers_plan``, read from ``cn_myers_plan``: lanes a
    pair, blocks a lane) and the SM clock after.  Returns phase_timing's
    tuple."""
    import torch

    from cute_nucleotides_tpu_torch.ops import align, kernels as K

    qw, tw = align_words
    B, wt = tw.shape
    ql = torch.full((B,), ALIGN_QM, dtype=torch.int32, device="cuda")
    tl = torch.full((B,), ALIGN_TN, dtype=torch.int32, device="cuda")
    peq, flat = align.peq_from_packed(qw, ql), tw.reshape(-1)
    nb = peq.shape[2]

    def bench(fn, mode="global"):
        return lambda: fn(peq, ql, flat, tl, wt, wt, mode=mode)

    want, p1 = _plain_once(bench(K.myers_scan_plain))
    k1 = _time_ms(bench(K.myers_scan), 10)
    k2 = _time_ms(bench(K.myers_scan), 10)
    _, p2 = _plain_once(bench(K.myers_scan_plain))
    _myers_compare(errors, bench(K.myers_scan)(), want, f"#19 bench shape {B} x {ALIGN_QM} x {ALIGN_TN}, global")
    _myers_compare(errors, bench(K.myers_scan, "semiglobal")(), bench(K.myers_scan_plain, "semiglobal")(),
                   f"#19 bench shape {B} x {ALIGN_QM} x {ALIGN_TN}, semiglobal")
    k_big, p_big = min(k1, k2), min(p1, p2)
    # the bound at the bench shape: read the words, write the scores; the floor of integer instructions
    bound_ms, bound_by = _bound(4 * (qw.numel() + tw.numel()) + 4 * B, myers_ops(B * ALIGN_TN, nb))
    # the chr1-length stream in best_match_stream's rows (the reduction over rows left out)
    rng = np.random.default_rng(SEED + 190)
    speq1, m1 = align.peq_from_bytes(_myers_ascii(rng, ALIGN_STREAM_M))
    R, wrb, H = align.stream_rows_plan(chr1_words.numel(), m1)
    rows_tl = (CHR1_NT - 16 * wrb * torch.arange(R, device="cuda")).clamp(0, 16 * (wrb + H)).to(torch.int32)
    speq_rows = torch.from_numpy(speq1).cuda()[None].expand(R, *speq1.shape)
    ql1 = torch.full((R,), m1, dtype=torch.int32, device="cuda")
    stream_args = (speq_rows, ql1, chr1_words, rows_tl, wrb, wrb + H)
    k_stream = min(_time_ms(lambda: K.myers_scan(*stream_args, mode="semiglobal"), 5) for _ in range(2))
    for r0 in (0, R - STREAM_CHECK_ROWS):  # the first rows, and the last (past the stream's end)
        # the words these rows start in (the last one's halo reads zeros past them, in both versions)
        rows = slice(r0, r0 + STREAM_CHECK_ROWS)
        sub = (speq_rows[rows], ql1[rows], chr1_words[r0 * wrb : (r0 + STREAM_CHECK_ROWS) * wrb], rows_tl[rows],
               wrb, wrb + H)
        _myers_compare(errors, K.myers_scan(*sub, mode="semiglobal"), K.myers_scan_plain(*sub, mode="semiglobal"),
                       f"#19 chr1 stream rows {r0}..{r0 + STREAM_CHECK_ROWS - 1} of {R}")
    stream_nt = int(rows_tl.sum())
    stream_bound, stream_by = _bound(4 * chr1_words.numel() + 8 * R,
                                     myers_ops(stream_nt, speq1.shape[1], mode="semiglobal"))
    say(f"  myers_scan[bench {B} x {ALIGN_QM} x {ALIGN_TN}, global, plan {K.myers_plan(nb, B)}]: kernel {k_big:.4f} ms "
        f"({B * ALIGN_QM * ALIGN_TN / (k_big / 1e3) / 1e9:.1f} GCUPS); plain {p_big:.3f} ms; runs "
        f"{k1:.4f}/{k2:.4f} vs {p1:.3f}/{p2:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / k_big:.0f}% of it; == the plain version on every pair, global and semiglobal")
    say(f"  myers_scan[chr1 stream rows, batch form, {R} rows of {wrb} + {H} words, m = {m1}, plan "
        f"{K.myers_plan(speq1.shape[1], R, 'semiglobal')}]: "
        f"kernel {k_stream:.4f} ms "
        f"({stream_nt * m1 / (k_stream / 1e3) / 1e9:.1f} GCUPS); bound {stream_bound:.4f} ms ({stream_by}), "
        f"{100 * stream_bound / k_stream:.0f}% of it; {STREAM_CHECK_ROWS} rows at each end == the plain version")
    # #19's stream form, what best_match_stream runs, on the same rows: its memset and kernel into one key,
    # which must equal the rows' path's (the batch form above, then the eager reduction)
    slot = torch.empty((), dtype=torch.int64, device="cuda")
    form_args = (speq1, m1, chr1_words, CHR1_NT, R, wrb, wrb + H)
    k_form = min(_time_ms(lambda: K.myers_stream_best(*form_args, out=slot), 5) for _ in range(2))
    key, rows_key = int(slot), int(K._stream_key_by_rows(K.myers_scan, *form_args[:-1], wrb + H, False))
    check(key == rows_key, f"#19 stream form on the chr1 stream: key {key:#x} != the rows' path's {rows_key:#x}")
    form_bound, form_by = _bound(4 * chr1_words.numel() + 8, myers_ops(stream_nt, speq1.shape[1], mode="semiglobal"))
    say(f"  myers_stream_best[chr1 stream, stream form, the same rows, m = {m1}]: memset and kernel {k_form:.4f} ms "
        f"({stream_nt * m1 / (k_form / 1e3) / 1e9:.1f} GCUPS); bound {form_bound:.4f} ms ({form_by}), "
        f"{100 * form_bound / k_form:.0f}% of it; key (dist {key >> 32}, end {key & 0xFFFFFFFF}) == the rows' path's")
    # the approx CLI's shape (phase 2's): APPROX_ROWS reads of APPROX_NT nt in rows of 16 u32, PRIMER broadcast
    apeq, am = align.peq_from_bytes(PRIMER)
    approx_words = torch.from_numpy(rng.integers(0, 2**32, APPROX_ROWS * 16, dtype=np.uint32)).cuda()
    approx_args = (torch.from_numpy(apeq).cuda()[None].expand(APPROX_ROWS, *apeq.shape),
                   torch.full((APPROX_ROWS,), am, dtype=torch.int32, device="cuda"), approx_words,
                   torch.full((APPROX_ROWS,), APPROX_NT, dtype=torch.int32, device="cuda"), 16, 16)
    want_a, pa = _plain_once(lambda: K.myers_scan_plain(*approx_args, mode="semiglobal"))
    wrapped = min(_time_ms(lambda: K.myers_scan(*approx_args, mode="semiglobal"), 50) for _ in range(2))
    k_approx, got_a = _myers_entry_ms(approx_args, 200)
    approx_case = f"approx {APPROX_ROWS} x {APPROX_NT} nt, m = {am}"
    _myers_compare(errors, K.myers_scan(*approx_args, mode="semiglobal"), want_a, f"#19 {approx_case}")
    _myers_compare(errors, got_a, want_a, f"#19 {approx_case}, through its entry point")
    approx_bound, approx_by = _bound(4 * approx_words.numel() + 8 * APPROX_ROWS,
                                     myers_ops(APPROX_ROWS * APPROX_NT, 1, mode="semiglobal"))
    say(f"  myers_scan[{approx_case}, semiglobal, plan {K.myers_plan(1, APPROX_ROWS, 'semiglobal')}]: kernel {k_approx:.4f} ms "
        f"through cn_myers ({wrapped:.4f} ms a call through the wrapper); plain {pa:.3f} ms; bound "
        f"{approx_bound:.4f} ms ({approx_by}), {100 * approx_bound / k_approx:.0f}% of it; == the plain version")
    # a phase-2 size in turns with the plain version: ALIGN_PAIRS pairs of a 150-nt query and 700-nt texts
    m, n = 150, 700
    speq = torch.from_numpy(np.stack([align.peq_from_bytes(_myers_ascii(rng, m))[0] for _ in range(ALIGN_PAIRS)]))
    small_args = (speq.cuda(), torch.full((ALIGN_PAIRS,), m, dtype=torch.int32, device="cuda"),
                  torch.from_numpy(rng.integers(0, 2**32, ALIGN_PAIRS * 44, dtype=np.uint32)).cuda(),
                  torch.full((ALIGN_PAIRS,), n, dtype=torch.int32, device="cuda"), 44, 44)
    want_s, ps1 = _plain_once(lambda: K.myers_scan_plain(*small_args, mode="semiglobal"))
    k_small, got_s = _myers_entry_ms(small_args, 50)
    _, ps2 = _plain_once(lambda: K.myers_scan_plain(*small_args, mode="semiglobal"))
    small_case = f"{ALIGN_PAIRS} pairs, m = {m}, {n}-nt texts"
    _myers_compare(errors, got_s, want_s, f"#19 {small_case}, through its entry point")
    say(f"  myers_scan[{small_case}, semiglobal, plan {K.myers_plan(speq.shape[2], ALIGN_PAIRS, 'semiglobal')}]: kernel "
        f"{k_small:.4f} ms through cn_myers; plain {min(ps1, ps2):.3f} ms; runs {ps1:.3f}/{ps2:.3f} ms; "
        f"clocks {_clocks()}")
    return k_big, p_big, bound_ms, bound_by, None, {f"[bench {B} x {ALIGN_QM} x {ALIGN_TN}]": k_big,
                                                     f"[chr1 stream rows, batch form, m = {m1}]": k_stream,
                                                     f"[chr1 stream, stream form, m = {m1}]": k_form,
                                                     f"[{approx_case}]": k_approx,
                                                     f"[{small_case}]": k_small}


def phase_timing(errors: Errors, x, words, x5, words5, chr1_words, chr1_pairs, planes, align_words,
                 card: str) -> dict:
    """Each kernel and its plain version at its path's shapes, in turns
    (plain, kernel, kernel, plain), with its bound from those shapes and,
    for the histogram and the sort, the one PyTorch call that computes the
    same function (torch.bincount, torch.sort of the int64 key).  Returns
    {name: (ms, plain ms, bound ms, bound by, library ms or None, {case:
    ms})}: the numbers of the first (the path's) variant, then the kernel
    time of every case.  #19's timing also holds it to its plain version at
    the path's two largest shapes (into ``errors``)."""
    import torch

    from cute_nucleotides_tpu_torch.ops import kernels as K, kmer, search

    nt4 = x.view(torch.uint32)
    packed = words.view(torch.uint8)
    b5, w5 = x5.view(-1), words5.view(-1)
    gib, gib5 = x.numel() / 2**30, x5.numel() / 2**30  # nt per call, in Gi
    cases = {
        "encode_2bit_nt4": [(f"[{v}]", lambda v=v: K.encode_2bit_nt4(nt4, v),
                             lambda v=v: K.encode_2bit_nt4_plain(nt4, v)) for v in ("mul", "shift", "interleave")],
        "decode_2bit_nt4": [(f"[{v}]", lambda v=v: K.decode_2bit_nt4(packed, v),
                             lambda v=v: K.decode_2bit_nt4_plain(packed, v)) for v in ("swar", "shuffle", "select")],
        "encode_2bit_nt4_checked": [(f"[{v}]", lambda v=v: K.encode_2bit_nt4_checked(nt4, v),
                                     lambda v=v: K.encode_2bit_nt4_checked_plain(nt4, v)) for v in ("mul",)],
        "encode_2bit_nt4_mxu": [("[checked]" if c else "", lambda c=c: K.encode_2bit_nt4_mxu(nt4, c),
                                 lambda c=c: K.encode_2bit_nt4_mxu_plain(nt4, c)) for c in (False, True)],
        "encode_b5_stream": [("[checked]" if c else "", lambda c=c: K.encode_b5_stream(b5, c),
                              lambda c=c: K.encode_b5_stream_plain(b5, c)) for c in (False, True)],
        "decode_b5_stream": [(f"[{m}]", lambda c=c, d=d: K.decode_b5_stream(w5, c, d),
                              lambda c=c, d=d: K.decode_b5_stream_plain(w5, c, d))
                             for m, c, d in (("chars", False, False), ("checked", True, False),
                                             ("digits", False, True))],
    }
    w2, n2, n5 = words.view(-1), x.numel(), x5.numel()
    queries = {"7 nt": b"GATTACA", "45 nt": (b"ACGTACNGTT" * 5)[:45]}
    compiled = {k: search.compile_query(q) for k, q in queries.items()}
    compiled5 = {k: (search.compile_query_b5(q.replace(b"N", b"?")), len(q)) for k, q in queries.items()}
    cases["match_bits_stream"] = [
        (f"[{k}]", lambda q=q, c=c, m=m: K.match_bits_stream(w2, q, c, n2 - m + 1),
         lambda q=q, c=c, m=m: K.match_bits_stream_plain(w2, q, c, n2 - m + 1))
        for k, (q, c, m) in compiled.items()]
    cases["match_b5_bits_stream"] = [
        (f"[{k}]", lambda qc=qc, m=m: K.match_b5_bits_stream(w5, qc, n5 - m + 1),
         lambda qc=qc, m=m: K.match_b5_bits_stream_plain(w5, qc, n5 - m + 1))
        for k, (qc, m) in compiled5.items()]
    # the k-mer kernels at their path's shapes: #10 and #13 on the batch's
    # words as rows of 512 (k = 8, canonical codes for #13), #11 on the
    # chr1-length stream (k = 21)
    panels = kmer._panels(words, 1)
    codes = kmer.canonical_codes(K.kmer_codes_planar(*panels, 8), 8)
    panels3 = kmer._panels(chr1_words, 2)
    cases["kmer_codes_planar"] = [("[k=8]", lambda: K.kmer_codes_planar(*panels, 8),
                                   lambda: K.kmer_codes_planar_plain(*panels, 8))]
    cases["kmer_codes_planar_pair"] = [("[k=21]", lambda: K.kmer_codes_planar_pair(*panels3, 21),
                                        lambda: K.kmer_codes_planar_pair_plain(*panels3, 21))]
    # and #13 on one 150-nt read's codes, as stats sends them one record at
    # a time (8049 of its 8192 codes masked to 0), beside 8192 random codes
    read = torch.randint(0, 1 << 32, (10,), dtype=torch.int64, device="cuda").to(torch.int32)
    read[-1] &= (1 << 12) - 1  # 150 nt: 6 in the last word (int32: the card has no & on uint32)
    read_codes = K.kmer_codes_planar(*kmer._panels(read.view(torch.uint32), 1), 8)
    kmer._mask_tail(read_codes, 150 - 8 + 1, 0)
    rand_codes = torch.randint(0, K.HIST_BINS, read_codes.shape, dtype=torch.int32, device="cuda")
    hist_inputs = {"[k=8 canonical]": codes, "[one 150-nt read, 8049 codes 0]": read_codes,
                   "[8192 random codes]": rand_codes}
    cases["hist_codes"] = [(label, lambda c=c: K.hist_codes(c), lambda c=c: K.hist_codes_plain(c))
                           for label, c in hist_inputs.items()]
    # the sketch kernels on the chr1-length stream, as the sketch path calls them
    n12, n14 = CHR1_NT - SKETCH_K + 1, CHR1_NT - 15 + 1
    cases["kmer_hashes_planar_pair"] = [(f"[k={SKETCH_K} canonical]",
                                         lambda: K.kmer_hashes_planar_pair(chr1_words, SKETCH_K, n12),
                                         lambda: K.kmer_hashes_planar_pair_plain(chr1_words, SKETCH_K, n12))]
    cases["minimizer_bits_stream"] = [(f"[k=15 w={win} canonical]",
                                       lambda win=win: K.minimizer_bits_stream(chr1_words, n14, 15, win),
                                       lambda win=win: K.minimizer_bits_stream_plain(chr1_words, n14, 15, win))
                                      for win in (10, 1024)]
    # #7 on the base-5 batch's words as one stream (the seqops path's
    # phase-3 call); #18 on the chr1 k = 21 pairs (the sort path's call),
    # then on 2^23 random pairs
    cases["gc_b5_stream"] = [("", lambda: K.gc_b5_stream(w5), lambda: K.gc_b5_stream_plain(w5))]
    # #15-#17 on the base-5 batch as planar rows (the planar path's calls)
    b5_rows, (plo, phi) = x5.view(-1, K.B5_ROW_NT), planes
    cases["encode_b5_planar"] = [("", lambda: K.encode_b5_planar(b5_rows), lambda: K.encode_b5_planar_plain(b5_rows))]
    cases["decode_b5_nt4_panels"] = [
        ("[padded]" if p else "[compact]", lambda p=p: K.decode_b5_nt4_panels(plo, phi, padded=p),
         lambda p=p: K.decode_b5_nt4_panels_plain(plo, phi, padded=p)) for p in (True, False)]
    cases["decode_b5_panels"] = [("", lambda: K.decode_b5_panels(plo, phi), lambda: K.decode_b5_panels_plain(plo, phi))]
    shi, slo = chr1_pairs
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 23)
    rhi, rlo = (torch.randint(0, 1 << 32, (1 << 23,), dtype=torch.int64, device="cuda", generator=g)
                .to(torch.int32).view(torch.uint32) for _ in range(2))
    sort_inputs = {f"[chr1 k=21 pairs, n={shi.numel()}]": (shi, slo), "[2^23 random pairs]": (rhi, rlo)}
    cases["sort_pairs_bitonic"] = [(label, lambda p=p: K.sort_pairs_bitonic(*p), lambda p=p: K.sort_pairs_bitonic_plain(*p))
                                   for label, p in sort_inputs.items()]
    # the library call beside #18: torch.sort of the pairs' int64 keys (the
    # key prefer="lax" sorts: the sign bit of hi flipped, so that signed
    # order is the pairs' unsigned order)
    lib_key = K.pair_keys(shi, slo)
    library = {"hist_codes": lambda: torch.bincount(codes.view(-1), minlength=K.HIST_BINS),
               "sort_pairs_bitonic": lambda: torch.sort(lib_key)}
    # bounds: bytes each input read once and each output written once; the
    # search kernels' integer work at the least this data needs (2-bit: 3
    # ops -- funnel shift, masked xor, compare -- per word, start and anchor
    # query word; base-5: 6 per triplet split and 2 per start slot and
    # first anchor tap)
    W2, N5, R1 = w2.numel(), w5.numel() // 2, panels[0].numel()
    R3, W3 = panels3[0].numel(), chr1_words.numel()
    bounds = {
        "encode_2bit_nt4": _bound(n2 + 4 * W2),
        "decode_2bit_nt4": _bound(4 * W2 + n2),
        "encode_2bit_nt4_checked": _bound(n2 + 4 * W2 + 4 * BATCH_ROWS),
        "encode_2bit_nt4_mxu": _bound(n2 + 4 * W2),
        "encode_b5_stream": _bound(n5 + 8 * N5),
        "decode_b5_stream": _bound(8 * N5 + n5),
        "match_bits_stream": _bound(8 * W2, 3 * 16 * W2),
        "match_b5_bits_stream": _bound(12 * N5, (6 * 9 + 2 * 27) * N5),
        "kmer_codes_planar": _bound(8 * R1 + 64 * R1),
        "kmer_codes_planar_pair": _bound(12 * R3 + 128 * R3),
        # the sketch kernels' integer instructions at the least the function
        # needs (a three-input logic op, a funnel shift or a multiply is one;
        # a fmix32 is 8: three shift-xor pairs and two multiplies).  #12: read
        # the stream, write 4 B per planar slot; per valid position 28: the
        # forward code (2 funnel shifts and the hi mask), the reverse
        # complement cut from the word's (the same 3), the 64-bit unsigned
        # compare and select (4), two fmix32 (16), the xor (1), the store
        # (1); per word 21: 3 loads, the reverse complement of its 48 nt (3
        # times xor, __brev and the 3-op field swap) and its shift (3)
        "kmer_hashes_planar_pair": _bound(4 * W3 + 4 * 16 * R3, 28 * n12 + 21 * W3),
        # #14: read the stream, write 4 B per 16 positions; per position 21:
        # the forward and reverse codes (funnel shift and mask each: 4), min
        # (1), fmix32 (8), a windowed min (prefix, suffix, combine: 3) and
        # max (3) as van Herk's flat-cost form needs them, the compare (1)
        # and the ballot (1); per word 5: the load and its reverse complement.
        # The doubling passes take more (2 floor(log2 w) + 2 passes), so the
        # bound does not depend on w
        "minimizer_bits_stream": _bound(4 * W3 + 4 * (-(-n14 // 16)), 21 * n14 + 5 * W3),
        "hist_codes": {label: _bound(4 * c.numel() + 4 * K.HIST_BINS) for label, c in hist_inputs.items()},
        # #7: read the stream; the lookup form's 3 instructions per triplet
        # (extract, table load, add)
        "gc_b5_stream": _bound(8 * N5, 3 * 9 * N5),
        # #15-#17 as #5 and #6; the padded decode writes 3584 B per row of 128 words
        "encode_b5_planar": _bound(n5 + 8 * N5),
        "decode_b5_nt4_panels": {"[padded]": _bound(8 * N5 + 4 * K.B5_NT4_PAD_LANES * (N5 // K.B5_ROW_WORDS)),
                                 "[compact]": _bound(8 * N5 + n5)},
        "decode_b5_panels": _bound(8 * N5 + n5),
        # #18: read and write each pair once (16 B); the radix passes' own
        # floor, 136 B a pair, is 8.5 times that and is not the function's
        "sort_pairs_bitonic": {label: _bound(16 * p[0].numel()) for label, p in sort_inputs.items()},
    }
    label, kernel, plain, bounds["peq_b5"] = _peq_b5_timing()
    cases["peq_b5"] = [(label, kernel, plain)]
    iters = {"sort_pairs_bitonic": (3, 1)}  # (kernel, plain) launches per timed run; 20 and 2 elsewhere
    say(f"  clocks before timing: {_clocks()}")
    say(f"timing on {card}: 2-bit u8[{BATCH_ROWS}, {BATCH_NT}] ({gib:.3f} Gnt), base-5 "
        f"u8[{BATCH_ROWS}, {B5_NT}] ({gib5:.3f} Gnt); k-mer codes u32{tuple(panels[0].shape)} (k=8) and "
        f"u32{tuple(panels3[0].shape)} (k=21), histogram i32{tuple(codes.shape)}")
    for label, batch, g in (("2-bit", x, gib), ("base-5", x5, gib5)):
        copy_ms = _time_ms(lambda b=batch: b.clone(), 10)
        say(f"  device copy of the {label} batch {copy_ms:.4f} ms ({2 * g / (copy_ms / 1e3):.1f} GiB/s "
            f"read+write)")
    times = {}
    for name, variants in cases.items():
        g = gib5 if name in B5_KERNELS + SEQOPS_KERNELS + PLANAR_KERNELS else gib
        k_iters, p_iters = iters.get(name, (20, 2))
        for suffix, kernel, plain in variants:
            bound_ms, bound_by = bounds[name][suffix] if isinstance(bounds[name], dict) else bounds[name]
            p1 = _time_ms(plain, p_iters)
            k1 = _time_ms(kernel, k_iters)
            k2 = _time_ms(kernel, k_iters)
            p2 = _time_ms(plain, p_iters)
            k_ms, p_ms = min(k1, k2), min(p1, p2)
            lib_ms = _time_ms(library[name], 5) if name in library and name not in times else None
            torch.cuda.empty_cache()
            rate = (f"{g / (k_ms / 1e3):.1f} GiB/s of nt"
                    if name not in KMER_KERNELS + SKETCH_KERNELS + SORT_KERNELS + ALIGN_KERNELS
                    else f"{HBM_BYTES_PER_S * bound_ms / k_ms / 1e12:.2f} TB/s moved" if bound_by == "bytes"
                    else "its instructions bound it")
            say(f"  {name}{suffix}: kernel {k_ms:.4f} ms ({rate}); plain {p_ms:.3f} ms; runs "
                f"{k1:.4f}/{k2:.4f} vs {p1:.3f}/{p2:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
                f"{100 * bound_ms / k_ms:.0f}% of it"
                + (f"; library call {lib_ms:.4f} ms" if lib_ms is not None else ""))
            times.setdefault(name, (k_ms, p_ms, bound_ms, bound_by, lib_ms, {}))  # the default variant is first
            times[name][5][suffix] = k_ms
    times["myers_scan"] = _time_myers(errors, align_words, chr1_words)
    say(f"  clocks after timing: {_clocks()}")
    return times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available; this gate runs on a GPU", file=sys.stderr)
        return 1
    try:
        from cute_nucleotides_tpu_torch.ops import _build, kernels as K

        name, card = phase_device()
        phase_build()
        rng = np.random.default_rng(SEED)
        errors = Errors()
        phase_kernels(errors, rng)
        phase_kernels_b5(errors, rng)
        phase_kernels_search(errors, rng)
        phase_kernels_kmer(errors, rng)
        phase_kernels_sketch(errors, rng)
        phase_kernels_seqops(errors, rng)
        phase_kernels_planar(errors, rng)
        # the align path draws from its own seed, so the earlier paths' data stay as they were
        align_rng = np.random.default_rng(SEED + 19)
        phase_kernels_align(errors, align_rng)
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        # each path (2-bit, base-5, search, k-mer, sketch, seqops, sort, planar) runs
        # with the counts set to 0 just before it and read just after; each
        # kernel must have launched on its own path
        launches = {}
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
            K.reset_launch_counts()
            x, words, dec = phase_batch(errors, rng)
            del dec
            phase_api(rng)
            reads2 = phase_cli(rng, workdir)
            torch.cuda.synchronize()
            launches["2-bit"] = {fn.__name__: fn.launches for fn in K.WRAPPERS}
            say(f"phase 6 launches by the 2-bit path (phases 3-5): {launches['2-bit']}")
            K.reset_launch_counts()
            x5, words5 = phase_batch_b5(errors, rng)
            phase_api_b5(rng)
            reads5 = phase_cli_b5(rng, workdir)
            torch.cuda.synchronize()
            launches["base-5"] = {fn.__name__: fn.launches for fn in K.WRAPPERS}
            say(f"phase 6 launches by the base-5 path (phases 3-5): {launches['base-5']}")
            K.reset_launch_counts()
            words, words5 = phase_search_batch(errors, rng, x, x5)
            phase_grep(rng, workdir, reads2, reads5)
            torch.cuda.synchronize()
            launches["search"] = {fn.__name__: fn.launches for fn in K.WRAPPERS}
            say(f"phase 6 launches by the search path (phases 3 and 5): {launches['search']}")
            chr1 = _chr1_fasta(rng, workdir)
            K.reset_launch_counts()
            phase_kmer_batch(errors, words)
            chr1_words = phase_kmer_chr1(errors)
            phase_stats(rng, workdir, reads2, chr1)
            torch.cuda.synchronize()
            launches["k-mer"] = {fn.__name__: fn.launches for fn in K.WRAPPERS}
            say(f"phase 6 launches by the k-mer path (phases 3-5): {launches['k-mer']}")
            K.reset_launch_counts()
            phase_sketch_chr1(errors, chr1_words)
            phase_sketch_cli(rng, workdir, reads2, chr1)
            torch.cuda.synchronize()
            launches["sketch"] = {fn.__name__: fn.launches for fn in K.WRAPPERS}
            say(f"phase 6 launches by the sketch path (phases 4 and 5): {launches['sketch']}")
            del chr1
            torch.cuda.empty_cache()
            K.reset_launch_counts()
            phase_gc_b5(x5, words5)
            phase_region(rng, workdir)
            phase_translate(rng, workdir)
            phase_dedup(rng, workdir, reads2, reads5)
            torch.cuda.synchronize()
            launches["seqops"] = {fn.__name__: fn.launches for fn in K.WRAPPERS}
            say(f"phase 6 launches by the seqops path (phases 3-5): {launches['seqops']}")
            K.reset_launch_counts()
            chr1_pairs = phase_sort_chr1(errors, chr1_words)
            torch.cuda.synchronize()
            launches["sort"] = {fn.__name__: fn.launches for fn in K.WRAPPERS}
            say(f"phase 6 launches by the sort path (phase 4): {launches['sort']}")
            K.reset_launch_counts()
            planes = phase_planar(x5, words5)
            torch.cuda.synchronize()
            launches["planar"] = {fn.__name__: fn.launches for fn in K.WRAPPERS}
            say(f"phase 6 launches by the planar path (phase 3): {launches['planar']}")
            # the Peq build's direct check is no call of the align path: the
            # reset drops its launch, so the path's peq_b5 count is its own
            phase_peq_b5_full(errors)
            K.reset_launch_counts()
            align_words = phase_align_batch(align_rng)
            phase_align_batch_b5(align_rng)
            phase_align_stream(align_rng, chr1_words)
            phase_approx(align_rng, workdir, reads2, reads5)
            torch.cuda.synchronize()
            launches["align"] = {fn.__name__: fn.launches for fn in K.WRAPPERS}
            say(f"phase 6 launches by the align path (phases 3-5): {launches['align']}")
            own = {k: launches[PATH_OF[k]][k] for k in REPLACES}
            check(all(n > 0 for n in own.values()), f"a kernel of its path never launched: {own}")
            K.reset_launch_counts()
            phase_stream(rng, workdir)
            torch.cuda.synchronize()
            launches["stream"] = {fn.__name__: fn.launches for fn in K.WRAPPERS}
            say(f"phase 8 launches by the stream path: {launches['stream']}")
            check(all(launches["stream"][k] > 0 for k in STREAM_KERNELS),
                  f"a kernel of the stream path never launched: {launches['stream']}")
            torch.cuda.empty_cache()
            K.reset_launch_counts()
            # counted from the parallel layer's own calls alone: phase 9's
            # one-device calls and timing loops launch the same kernels
            launches["parallel"] = phase_parallel(rng, x, x5, words, words5, align_words, workdir)
            torch.cuda.synchronize()
            in_all = {fn.__name__: fn.launches for fn in K.WRAPPERS}
            say(f"phase 9 launches by the parallel layer's path: {launches['parallel']} (phase 9 in all, "
                f"its one-device calls and timing loops included: {in_all})")
            check(all(launches["parallel"][k] > 0 for k in PARALLEL_KERNELS),
                  f"a kernel of the parallel layer's path never launched: {launches['parallel']}")
            torch.cuda.empty_cache()
            times = phase_timing(errors, x, words, x5, words5, chr1_words, chr1_pairs, planes, align_words, card)
            kernels_line = json.dumps({"kernels": [
                {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
                 "launches": own[k], "max_abs_err": errors.max[k], "ms": times[k][0], "plain_ms": times[k][1],
                 "bound_ms": times[k][2], "bound_by": times[k][3], "library_ms": times[k][4],
                 **({"ms_by_case": times[k][5]} if len(times[k][5]) > 1 else {}),
                 **({"note": NOT_PALLAS[k]} if k in NOT_PALLAS else {})}
                for k in REPLACES
            ]})
            del x, words, x5, words5, chr1_words, chr1_pairs, planes, align_words
            torch.cuda.empty_cache()
            phase_bench(workdir)
        say(kernels_line)
    except Exception:
        traceback.print_exc()
        print("FAIL: chip smoke failed", file=sys.stderr)
        return 1
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if args == [PROFILE_SKETCH_CHR1]:
        sys.exit(profile_sketch_chr1())
    if len(args) == 2 and args[0] == PROFILE_STREAM_ENCODE:
        sys.exit(profile_stream_encode(args[1]))
    if len(args) == 5 and args[0] == PARALLEL_RANK:
        sys.exit(rank_child(int(args[1]), args[2], args[3], int(args[4])))
    sys.exit(main())
