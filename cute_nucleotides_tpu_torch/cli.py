"""Command-line interface of the port: encode / decode / parity / region /
grep / approx / translate / dedup / stats / sketch / bench.

Counterpart of the commands of ``cute_nucleotides_tpu/cli.py`` (all 11 of
them); it reads and writes the same
``.nup`` container (:mod:`.nup`), so files are byte-identical between the
two packages, and ``region``, ``grep``, ``approx``, ``translate``,
``dedup``, ``stats`` and ``sketch`` print the same bytes::

    python -m cute_nucleotides_tpu_torch encode reads.fq out.nup --batch 8192 --validate
    python -m cute_nucleotides_tpu_torch encode reads.fq out.nup --codec base5 --batch 8192 --validate
    python -m cute_nucleotides_tpu_torch decode out.nup out.fa --batch 8192 --verify-stream
    python -m cute_nucleotides_tpu_torch parity --tiers torch,auto
    python -m cute_nucleotides_tpu_torch region chr.nup chr1:1000-2000 chr2:0-500 -o win.fa
    python -m cute_nucleotides_tpu_torch grep out.nup GATTACA --both
    python -m cute_nucleotides_tpu_torch approx out.nup GTTCAGAGTTCTACAGTCCG --both --max-errors 2 --cigar
    python -m cute_nucleotides_tpu_torch translate out.nup prot.fa --frames all
    python -m cute_nucleotides_tpu_torch dedup out.nup unique.nup
    python -m cute_nucleotides_tpu_torch stats chr1.fa -k 21 --canonical --top 10
    python -m cute_nucleotides_tpu_torch sketch a.fq b.fq -k 21 -s 1000
    python -m cute_nucleotides_tpu_torch bench

``--batch N`` is the production path: batches of N reads as resident
tensors through :class:`.models.TwoBitCodec` or :class:`.models.Base5Codec`.
Without it each record goes through :mod:`.api` on its own.  The codec of
``decode``, ``region``, ``grep``, ``approx``, ``translate`` and ``dedup`` is
the one the ``.nup`` names; ``grep``, ``approx``, ``translate``, ``dedup``,
``stats`` and ``sketch`` work on the card when there is one (the ``auto``
tier's device), and
``region`` on its ``--tier``'s device.  ``bench`` (:mod:`.bench`) measures
the card, and without CUDA it refuses to run.

A malformed or missing file ends in one ``error:`` line and exit 1, and a
closed output pipe (``grep ... | head``) in exit 141, as in the reference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from . import TIERS
from .nup import read_nup, write_fasta, write_nup

_CODECS = ("2bit", "base5")


def _oracle_has_no_batch_path() -> int:
    print(
        "error: --tier oracle has no batch device path; drop --batch "
        "(the per-record path runs the host oracle)",
        file=sys.stderr,
    )
    return 2


def _report_invalid(name: bytes, seq: bytes, pos: int) -> int:
    print(
        f"error: invalid byte {seq[pos:pos + 1]!r} at {pos} in "
        f"{name.decode(errors='replace')}",
        file=sys.stderr,
    )
    return 1


def _codec_class(codec: str):
    from .models import Base5Codec, TwoBitCodec

    return TwoBitCodec if codec == "2bit" else Base5Codec


def cmd_encode(args) -> int:
    from .ops import native, spec
    from .utils import io as io_lib

    records = list(io_lib.open_reads(args.input))
    words_list, lengths = [], []
    allow_n = args.codec == "base5"
    words_for = spec.num_words_2bit if args.codec == "2bit" else spec.num_words_b5
    if args.validate and not args.batch:
        for rec in records:
            pos = native.find_invalid(rec.seq, allow_n=allow_n)
            if pos >= 0:
                return _report_invalid(rec.name, rec.seq, pos)

    if args.batch:
        if args.tier == "oracle":
            return _oracle_has_no_batch_path()
        import torch

        codec = _codec_class(args.codec)(tier=args.tier)
        # batches are as wide as the longest read needs (BatchStream rounds
        # up to whole u64 words); --max-len only bounds it
        longest = max((len(r.seq) for r in records), default=0)
        stream = io_lib.BatchStream(
            records, batch_size=args.batch, max_len=max(min(longest, args.max_len), 1),
            block=codec.block,
        )
        for b in stream:
            reads = torch.from_numpy(b.reads).to(codec.device)
            if args.validate:
                words, bad = codec.encode_checked(reads)
                if bool(bad.any()):
                    # the host scan names the first bad record; the fused
                    # check and the scan agree on every byte, so a flag the
                    # scan cannot explain means they drifted apart
                    for row in range(b.count):
                        seq = bytes(b.reads[row, : int(b.lengths[row])])
                        pos = native.find_invalid(seq, allow_n=allow_n)
                        if pos >= 0:
                            return _report_invalid(records[len(lengths) + row].name, seq, pos)
                    print(
                        "error: device validity check flagged this batch but the "
                        "host scan found no invalid byte (refusing to write)",
                        file=sys.stderr,
                    )
                    return 1
            else:
                words = codec.encode(reads)
            out = words.cpu().numpy()
            for row in range(b.count):
                n = int(b.lengths[row])
                words_list.append(spec.u32_pairs_to_u64(out[row])[: words_for(n)])
                lengths.append(n)
    else:
        from . import api

        encode = api.n_to_bits if args.codec == "2bit" else api.n_to_bits2
        for rec in records:
            words_list.append(encode(rec.seq, tier=args.tier))
            lengths.append(len(rec.seq))
    names = [r.name for r in records]
    write_nup(args.output, names, words_list, lengths, args.codec)
    print(json.dumps({"records": len(names), "nt": sum(lengths), "codec": args.codec,
                      "output": args.output}))
    return 0


def _pack_words(chunk: list[tuple[bytes, int, np.ndarray]]) -> np.ndarray:
    """``(name, length, u64 words)`` entries -> u32[len(chunk), 2 * widest]
    little-endian pairs; short records end in zero words, which the
    per-record length drops after decode."""
    width = max(max((words.size for _, _, words in chunk), default=0), 1)
    mat = np.zeros((len(chunk), width), dtype="<u8")
    for i, (_, _, words) in enumerate(chunk):
        mat[i, : words.size] = words
    return mat.view("<u4")


def _report_corrupt(name: bytes, word: int) -> int:
    print(f"error: corrupt base-5 word {word} in record {name.decode(errors='replace')}",
          file=sys.stderr)
    return 1


def cmd_decode(args) -> int:
    from . import interop
    from .ops import seqops

    codec, entries = read_nup(args.input)
    if args.batch and args.tier == "oracle":
        return _oracle_has_no_batch_path()
    # base-5 words leave triplet codes 125..127 and bit 63 unused, so a
    # corrupt stream is detectable; the 2-bit stream has no invalid states
    verify = args.verify_stream and codec == "base5"
    if verify and not args.batch:
        for name, _, words in entries:
            w = int(seqops.first_invalid_word_b5(interop.u64_to_tensor(words)))
            if w >= 0:
                return _report_corrupt(name, w)
    # a file is written under a temporary name and renamed on success, so a
    # failure neither leaves a truncated FASTA nor clobbers an existing one
    to_file = args.output != "-"
    tmp_path = args.output + ".tmp" if to_file else None
    out = open(tmp_path, "wb") if to_file else sys.stdout.buffer
    ok = False
    try:
        if args.batch:
            import torch

            cd = _codec_class(codec)(tier=args.tier)
            for start in range(0, len(entries), args.batch):
                chunk = entries[start : start + args.batch]
                words = torch.from_numpy(_pack_words(chunk)).to(cd.device)
                if verify:
                    # the check rides the decode's own read; a flagged batch
                    # is diagnosed row by row (zero pad words are valid)
                    dec, bad = cd.decode_checked(words)
                    if bool(bad):
                        # every corrupt record of the batch is named
                        first = seqops.first_invalid_word_b5(words).cpu()
                        rows = torch.nonzero(first >= 0).flatten().tolist()
                        if not rows:
                            print("error: the fused integrity check flagged this batch but "
                                  "the scan found no corrupt word (refusing to write)",
                                  file=sys.stderr)
                        for row in rows:
                            _report_corrupt(chunk[row][0], int(first[row]))
                        return 1
                else:
                    dec = cd.decode(words)
                dec = dec.cpu().numpy()
                for i, (name, length, _) in enumerate(chunk):
                    write_fasta(out, name, dec[i, :length].tobytes())
        else:
            from . import api

            decode = api.bits_to_n if codec == "2bit" else api.bits_to_n2
            for name, length, words in entries:
                write_fasta(out, name, decode(words, length, tier=args.tier).tobytes())
        ok = True
    finally:
        if to_file:
            out.close()
            if ok:
                os.replace(tmp_path, args.output)
            else:
                os.unlink(tmp_path)
    return 0


def cmd_parity(args) -> int:
    """Randomized parity gate: every tier must match the oracle bit-exactly."""
    from . import api
    from .ops import native, oracle

    rng = np.random.default_rng(args.seed)
    alpha = np.frombuffer(b"ACGTUacgtu", np.uint8)
    alpha_n = np.frombuffer(b"ACGTUNacgtun", np.uint8)
    tiers = args.tiers.split(",")
    failures = 0
    for trial in range(args.trials):
        n = int(rng.integers(1, args.max_len + 1))
        kind = trial % 3  # ACGTU, ACGTUN, random bytes
        if kind == 2:
            s = rng.integers(0, 256, size=n, dtype=np.int64).astype(np.uint8)
        else:
            s = rng.choice(alpha_n if kind == 1 else alpha, size=n)
        w_ref, w5_ref = oracle.n_to_bits_lut(s), oracle.n_to_bits2_lut(s)
        s_ref, s5_ref = oracle.bits_to_n_lut(w_ref, n), oracle.bits_to_n2_lut(w5_ref, n)
        checks = [("native", native.n_to_bits(s), w_ref), ("native-b5", native.n_to_bits2(s), w5_ref)]
        for tier in tiers:
            checks.append((tier, api.n_to_bits(s, tier=tier), w_ref))
            checks.append((f"decode-{tier}", api.bits_to_n(w_ref, n, tier=tier), s_ref))
            checks.append((f"{tier}-b5", api.n_to_bits2(s, tier=tier), w5_ref))
            checks.append((f"decode-{tier}-b5", api.bits_to_n2(w5_ref, n, tier=tier), s5_ref))
        for label, got, want in checks:
            if not np.array_equal(got, want):
                print(f"PARITY FAIL [{label}] n={n} trial={trial}", file=sys.stderr)
                failures += 1
    status = "PASS" if failures == 0 else "FAIL"
    print(json.dumps({"parity": status, "trials": args.trials, "failures": failures}))
    return 0 if failures == 0 else 1


def _revcomp_pattern(raw: bytes, is_b5: bool) -> bytes:
    """Reverse complement of a CLI pattern.  A base-5 ``?`` is no base: it
    is complemented as N and restored at its reversed position (a literal N
    stays N)."""
    from .ops import search

    if is_b5:
        rc = search.revcomp_query(raw.replace(b"?", b"N"))
        return bytes(ord("?") if p == ord("?") else w for p, w in zip(raw[::-1], rc))
    return search.revcomp_query(raw)


def _print_hits(name: bytes, hits) -> None:
    rec = name.decode(errors="replace")
    for p, strand in hits:
        print(json.dumps({"record": rec, "pos": p, "strand": strand}))


def _print_counts(name: bytes, counts: dict) -> None:
    print(json.dumps({"record": name.decode(errors="replace"),
                      **{("fwd" if s == "+" else "rev"): c for s, c in counts.items()}}))


def _grep_batched(args, entries, queries, is_b5: bool, device) -> int:
    """Batched grep: fixed-shape batches (the word width bucketed by
    ``pack_words_batch``, as the decode path does), one mask-tier call per
    batch and strand; hits print per record, in record order."""
    from . import interop
    from .ops import search
    from .utils import io as io_lib

    mask_fn = search.match_mask_b5_batch if is_b5 else search.match_mask_batch
    total = 0
    for start in range(0, len(entries), args.batch):
        chunk = entries[start : start + args.batch]
        w32 = interop.to_tensor(io_lib.pack_words_batch(chunk, args.batch), device)
        lengths = np.zeros(args.batch, np.int32)
        for i, (_, length, _) in enumerate(chunk):
            lengths[i] = length
        cap = (w32.shape[1] // 2) * 27 if is_b5 else w32.shape[1] * 16
        per_strand = {}
        for q, strand in queries:
            if cap - len(q) + 1 <= 0:  # every record shorter than the query
                per_strand[strand] = np.zeros((args.batch, 0), dtype=bool)
            else:
                per_strand[strand] = interop.to_numpy(mask_fn(w32, lengths, q))
        for i, (name, _, _) in enumerate(chunk):
            if args.count:
                counts = {s: int(m[i].sum()) for s, m in per_strand.items()}
                _print_counts(name, counts)
                total += sum(counts.values())
            else:
                hits = sorted((int(p), s) for s, m in per_strand.items() for p in np.flatnonzero(m[i]))
                total += len(hits)
                _print_hits(name, hits)
    return 0 if total or args.count else 1


def cmd_grep(args) -> int:
    """Every occurrence of a pattern in a .nup's records, found on the
    packed words (no decode).  2-bit: ``N`` is a wildcard; base-5: ``N`` is
    a literal and ``?`` the wildcard.  One JSON line per hit (record,
    0-based position, strand), or per record with ``--count``; exit 1 when
    nothing matched (and no ``--count``)."""
    from . import interop
    from .models import resolve_device
    from .ops import search

    codec, entries = read_nup(args.input)
    is_b5 = codec != "2bit"
    compile_q = search.compile_query_b5 if is_b5 else search.compile_query
    positions = search.match_positions_b5 if is_b5 else search.match_positions
    try:
        compile_q(args.pattern.encode())
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    queries = [(args.pattern.encode(), "+")]
    if args.both:
        raw = args.pattern.encode()
        rc = _revcomp_pattern(raw, is_b5)
        if rc != raw.upper().replace(b"U", b"T"):
            queries.append((rc, "-"))
    device = resolve_device("auto")
    if args.batch:
        return _grep_batched(args, entries, queries, is_b5, device)
    total = 0
    for name, length, words in entries:
        counts, hits = {}, []
        w32 = interop.u64_to_tensor(words, device)  # one transfer, both strands
        for q, strand in queries:
            if length < len(q):
                counts[strand] = 0
                continue
            pos = positions(w32, length, q)
            counts[strand] = len(pos)
            hits.extend((int(p), strand) for p in pos)
        total += len(hits)
        if args.count:
            _print_counts(name, counts)
        else:
            _print_hits(name, sorted(hits))
    return 0 if total or args.count else 1


def _approx_refusal(args, is_b5: bool) -> str | None:
    """The reference's error line for a flag combination ``approx`` refuses."""
    if not args.all:
        return None
    if args.max_errors < 0:
        return "--all requires --max-errors"
    if args.cigar:
        return ("--all and --cigar are mutually exclusive (the all-ends scan has no single match to trace "
                "back)")
    if is_b5:
        return "--all is 2-bit only (the base-5 scan does not emit per-position scores)"
    return None


def _approx_cigars(lines: list, is_b5: bool) -> None:
    """Add the match start and SAM CIGAR to each ``(line, query, words)``:
    a host DP on the <= 2m - 1 nt window ending at the reported end
    (forward-strand coordinates for either strand, the SAM convention), one
    batched DP for all of them."""
    from .ops import align, native, oracle, spec

    nt_w = spec.NT_PER_WORD_B5 if is_b5 else spec.NT_PER_WORD_2BIT
    # the reference decodes with its numpy oracle; the C++ one writes the same
    # 2-bit bytes, but a corrupt base-5 word decodes differently there
    decode = oracle.bits_to_n2_lut if is_b5 else native.bits_to_n
    pairs, offsets = [], []
    for line, qb, words in lines:
        end = line["end"]
        e_lo = max(0, end - (2 * len(qb) - 1))
        a = (e_lo // nt_w) * nt_w
        pairs.append((qb, bytes(decode(np.ascontiguousarray(words[a // nt_w :]), end - a))[e_lo - a :]))
        offsets.append(e_lo)
    for (line, _, _), e_lo, (_, start, _, cigar) in zip(lines, offsets, align.semiglobal_tracebacks(pairs, is_b5)):
        line["start"] = e_lo + start
        line["cigar"] = cigar


def cmd_approx(args) -> int:
    """Best approximate occurrence of a pattern in every record of a .nup:
    the Myers scan on the packed words (kernel #19 on the card, no decode).
    2-bit: ``N`` in the pattern matches any base; base-5: ``N`` is a literal
    and ``?`` the wildcard.  One JSON line per record (edit distance, end,
    strand; the better strand with ``--both``); ``--max-errors E`` keeps the
    records within E (exit 1 when none), ``--all`` prints every end within
    E (2-bit), ``--cigar`` adds the start and a CIGAR."""
    import torch

    from . import interop
    from .models import resolve_device
    from .ops import align, spec

    codec, entries = read_nup(args.input)
    is_b5 = codec != "2bit"
    refusal = _approx_refusal(args, is_b5)
    if refusal:
        print(f"error: {refusal}", file=sys.stderr)
        return 1
    compile_q = align.peq_from_bytes_b5 if is_b5 else align.peq_from_bytes
    best_peq = align.best_match_peq_b5 if is_b5 else align.best_match_peq
    raw = args.pattern.encode()
    try:
        strands = [(compile_q(raw), "+", raw)]
        if args.both:
            rc = _revcomp_pattern(raw, is_b5)
            if rc != raw.upper().replace(b"U", b"T"):
                strands.append((compile_q(rc), "-", rc))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    qbytes_by_strand = {strand: qb for _, strand, qb in strands}
    device = resolve_device("auto")
    chunk = max(args.batch, 1)
    # one Peq per strand, broadcast to the batch (stride 0, no copy)
    dev_strands = [(interop.to_tensor(peq, device)[None].expand(chunk, *peq.shape),
                    torch.full((chunk,), m, dtype=torch.int32, device=device), strand)
                   for (peq, m), strand, _ in strands]
    words_for = spec.num_words_b5 if is_b5 else spec.num_words_2bit
    shown = 0
    for lo in range(0, len(entries), chunk):
        part = entries[lo : lo + chunk]
        lens = np.array([length for _, length, _ in part], np.int64)
        # the u32 row width: the next power of two (even, >= 2), as the reference buckets it
        need = max(2, int(2 * words_for(int(lens.max(initial=1)))))
        width = 2
        while width < need:
            width *= 2
        mat = np.zeros((chunk, width), np.uint32)
        for i, (_, _, words) in enumerate(part):
            mat[i, : 2 * len(words)] = spec.u64_to_u32_pairs(np.ascontiguousarray(words)).reshape(-1)
        tl = np.zeros(chunk, np.int32)
        tl[: len(part)] = lens
        tw_dev, tl_dev = interop.to_tensor(mat, device), interop.to_tensor(tl, device)
        if args.all:
            errs = torch.full((chunk,), args.max_errors, dtype=torch.int32, device=device)
            for peq_dev, ql_dev, strand in dev_strands:
                ends = interop.to_numpy(align.match_ends_peq(peq_dev, ql_dev, tw_dev, tl_dev, errs))
                for i, (name, _, _) in enumerate(part):
                    rec = name.decode(errors="replace")
                    for j in np.nonzero(ends[i])[0]:
                        shown += 1
                        print(json.dumps({"record": rec, "end": int(j) + 1, "strand": strand}))
            continue
        results = [(*(interop.to_numpy(x) for x in best_peq(peq_dev, ql_dev, tw_dev, tl_dev)), strand)
                   for peq_dev, ql_dev, strand in dev_strands]
        lines, traced = [], []
        for i, (name, _, words) in enumerate(part):
            best = None
            for d, e, strand in results:
                if best is None or int(d[i]) < best[0]:
                    best = (int(d[i]), int(e[i]), strand)
            dist, end, strand = best
            if 0 <= args.max_errors < dist:
                continue
            line = {"record": name.decode(errors="replace"), "dist": dist, "end": end, "strand": strand}
            lines.append(line)
            if args.cigar and end > 0:
                traced.append((line, qbytes_by_strand[strand], words))
        _approx_cigars(traced, is_b5)
        for line in lines:
            print(json.dumps(line))
        shown += len(lines)
    return 1 if args.max_errors >= 0 and shown == 0 else 0


def cmd_stats(args) -> int:
    """GC content, base composition and the top k-mers of a read file or a
    2-bit ``.nup``, all computed on the packed words (no decode), one record
    at a time as in the reference.  k <= 12 sums dense histograms; past
    that the distinct k-mers of each record (``kmer.kmer_counts``) merge
    into a dict in the reference's order, so ties print alike.  ``--tier``
    encodes FASTA/FASTQ input and picks the device (``oracle``: the auto
    device)."""
    import torch

    from . import api, interop
    from .models import resolve_device
    from .ops import kmer, seqops
    from .utils import io as io_lib

    if args.input.endswith(".nup"):
        codec, entries = read_nup(args.input)
        if codec != "2bit":
            print("stats requires a 2-bit stream", file=sys.stderr)
            return 1
        seqs = [(length, words) for _, length, words in entries]
    else:
        seqs = [(len(rec.seq), api.n_to_bits(rec.seq, tier=args.tier))
                for rec in io_lib.open_reads(args.input)]
    device = resolve_device("auto" if args.tier == "oracle" else args.tier)
    total_nt = sum(n for n, _ in seqs)
    # the sums stay on the device until the end: no sync per record
    comp = torch.zeros(4, dtype=torch.int64, device=device)
    hist = None
    counts_map: dict[int, int] = {}
    use_counts = args.k > 12  # past the dense-histogram ceiling (17 TB at 21)
    for n, words in seqs:
        w32 = interop.u64_to_tensor(words, device)
        comp += seqops.base_composition_packed(w32, n)
        if n >= args.k:
            if use_counts:
                lo, hi, cnt = kmer.kmer_counts(w32, n, args.k, canonical=args.canonical)
                idx = torch.nonzero(cnt).flatten()
                hi64, lo64 = (t.view(torch.int32)[idx].to(torch.int64) & 0xFFFFFFFF for t in (hi, lo))
                for code, c in zip(((hi64 << 32) | lo64).tolist(), cnt[idx].tolist()):
                    counts_map[code] = counts_map.get(code, 0) + c
            else:
                h = kmer.kmer_histogram(w32, n, args.k, canonical=args.canonical)
                hist = h if hist is None else hist + h
    comp = comp.tolist()
    gc = comp[1] + comp[3]  # C + G: the fields with code bit 0 set, what gc_content_packed counts
    out = {
        "records": len(seqs),
        "nt": total_nt,
        "gc_fraction": round(gc / max(total_nt, 1), 6),
        "composition": dict(zip("ACTG", comp)),
        "k": args.k,
        "canonical": bool(args.canonical),
    }

    def code_to_str(c):
        return "".join("ACTG"[(c >> (2 * j)) & 3] for j in range(args.k))

    if use_counts and counts_map:
        out["distinct_kmers"] = len(counts_map)
        top = sorted(counts_map.items(), key=lambda kv: -kv[1])[: args.top]  # stable: ties keep code order
        out["top_kmers"] = [{"kmer": code_to_str(c), "count": n} for c, n in top]
    elif hist is not None:
        hist_np = interop.to_numpy(hist)  # i32, as the reference's: argsort breaks ties alike
        top = np.argsort(hist_np)[::-1][: args.top]
        out["top_kmers"] = [{"kmer": code_to_str(int(c)), "count": int(hist_np[c])}
                            for c in top if hist_np[c] > 0]
    print(json.dumps(out))
    return 0


def _parse_region(spec_str: str) -> tuple[bytes, int, int]:
    """``NAME:START-END`` (0-based half-open) -> (name, start, end)."""
    name, _, span = spec_str.rpartition(":")
    if not name or "-" not in span:
        raise ValueError(f"region must be NAME:START-END, got {spec_str!r}")
    s, _, e = span.partition("-")
    start, end = int(s), int(e)
    if start < 0 or end < start:
        raise ValueError(f"bad region bounds in {spec_str!r}")
    return name.encode(), start, end


def cmd_region(args) -> int:
    """Extract subsequences from a .nup container on the packed domain, the
    samtools-faidx analogue: each window is cut with
    :func:`ops.seqops.packed_slice` / ``packed_slice_b5`` (a funnel over the
    record's words, read with one seek; no whole-record decode), then
    decoded to FASTA or, with ``--packed``, written still packed to a new
    .nup.  Either output is written under a temporary name and renamed on
    success, so a failure leaves an existing file as it was."""
    from . import api, interop
    from .models import resolve_device
    from .nup import NupReader
    from .ops import seqops, spec

    device = resolve_device("auto" if args.tier == "oracle" else args.tier)
    reader = NupReader(args.input)
    codec = reader.codec
    packed_out: list[tuple[bytes, int, np.ndarray]] = []
    to_file = args.output != "-"
    tmp_path = args.output + ".tmp" if to_file else None
    out = open(tmp_path, "wb") if to_file else sys.stdout.buffer
    ok = False
    try:
        for reg in args.regions:
            name, start, end = _parse_region(reg)
            if name not in reader:
                print(f"error: no record {name.decode(errors='replace')!r} in {args.input}", file=sys.stderr)
                return 1
            if reader.names.count(name) > 1:
                print(f"warning: {reader.names.count(name)} records named {name.decode(errors='replace')!r}; "
                      "using the first", file=sys.stderr)
            length, words = reader.get(name)
            if end > length:
                print(f"error: region {reg} overruns record length {length}", file=sys.stderr)
                return 1
            n = end - start
            op = seqops.packed_slice if codec == "2bit" else seqops.packed_slice_b5
            # only the words the window covers go to the device, and one
            # more (the funnel's last tap); past them the slice masks anyway
            per_word = spec.NT_PER_WORD_2BIT if codec == "2bit" else spec.NT_PER_WORD_B5
            first = start // per_word
            window = words[first : spec.cdiv(end, per_word) + 1]
            w64 = interop.tensor_to_u64(op(interop.u64_to_tensor(window, device), start - first * per_word, n))
            tag = name + f":{start}-{end}".encode()
            if args.packed:
                packed_out.append((tag, n, w64))
            else:
                decode = api.bits_to_n if codec == "2bit" else api.bits_to_n2
                write_fasta(out, tag, decode(w64, n, tier=args.tier).tobytes())
        if args.packed:
            if args.output == "-":
                print("error: --packed needs an output path", file=sys.stderr)
                return 1
            out.close()
            write_nup(tmp_path, [t for t, _, _ in packed_out], [w for _, _, w in packed_out],
                      [n for _, n, _ in packed_out], codec)
        ok = True
    finally:
        reader.close()
        if to_file:
            if not out.closed:
                out.close()
            if ok:
                os.replace(tmp_path, args.output)
            elif os.path.exists(tmp_path):
                os.unlink(tmp_path)
    return 0


def _parse_frames(spec_str: str) -> list[int]:
    """'all' or a comma list from {1,2,3,-1,-2,-3} (EMBOSS numbering)."""
    if spec_str == "all":
        return [1, 2, 3, -1, -2, -3]
    out = []
    for tok in spec_str.split(","):
        f = int(tok)
        if f not in (1, 2, 3, -1, -2, -3):
            raise ValueError(f"frame {tok} not in 1,2,3,-1,-2,-3")
        out.append(f)
    return out


def cmd_translate(args) -> int:
    """Translate .nup records to protein FASTA on the packed domain: 2-bit
    codons through the k = 3 funnel (:func:`ops.seqops.translate_packed`),
    base-5 codons as triplets (``translate_packed_b5``, N codons -> X);
    minus-strand frames reverse-complement on the packed words first.  Runs
    on the card when there is one."""
    from . import interop
    from .models import resolve_device
    from .ops import seqops

    try:
        frames = _parse_frames(args.frames)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    codec, entries = read_nup(args.input)
    fwd = seqops.translate_packed if codec == "2bit" else seqops.translate_packed_b5
    rcfn = seqops.revcomp_packed if codec == "2bit" else seqops.revcomp_packed_b5
    device = resolve_device("auto")
    to_file = args.output != "-"
    tmp_path = args.output + ".tmp" if to_file else None
    out = open(tmp_path, "wb") if to_file else sys.stdout.buffer
    ok = False
    try:
        for name, length, words in entries:
            w32 = interop.u64_to_tensor(words, device)
            rc = None
            for f in frames:
                off = abs(f) - 1
                if (length - off) // 3 <= 0:
                    continue  # no whole codon in this frame
                if f > 0:
                    src = w32
                else:
                    if rc is None:
                        rc = rcfn(w32, length)
                    src = rc
                write_fasta(out, name + b"|frame=%+d" % f, interop.to_numpy(fwd(src, length, off)).tobytes())
        ok = True
    finally:
        if to_file:
            if not out.closed:
                out.close()
            if ok:
                os.replace(tmp_path, args.output)
            elif os.path.exists(tmp_path):
                os.unlink(tmp_path)
    return 0


#: the longest record dedup takes, in u64 words (the reference's bound on
#: its multi-key sort)
_DEDUP_MAX_WORDS = 256


def cmd_dedup(args) -> int:
    """Remove exact-duplicate records (same normalised sequence) from a .nup
    container, ``seqkit rmdup -s`` on the packed domain: equality of the
    packed words and length (case/U folding happened at encode), decided on
    the card when there is one (:func:`ops.seqops.duplicate_mask`); the
    first occurrence wins.  Prints a one-line JSON summary."""
    from . import interop
    from .models import resolve_device
    from .ops import seqops, spec

    codec, entries = read_nup(args.input)
    if not entries:
        write_nup(args.output, [], [], [], codec)
        print(json.dumps({"records": 0, "kept": 0, "removed": 0}))
        return 0
    wmax = max(1, max(len(w) for _, _, w in entries))
    if wmax > _DEDUP_MAX_WORDS:
        per_word = spec.NT_PER_WORD_2BIT if codec == "2bit" else spec.NT_PER_WORD_B5
        print(f"error: dedup is read-batch-scoped (records up to {per_word * _DEDUP_MAX_WORDS} nt for this "
              f"codec); longest record here is {max(length for _, length, _ in entries)} nt", file=sys.stderr)
        return 1
    rows = np.zeros((len(entries), wmax), "<u8")
    lens = np.zeros(len(entries), np.int32)
    for i, (_, length, words) in enumerate(entries):
        rows[i, : words.size] = words
        lens[i] = length
    device = resolve_device("auto")
    dup = interop.to_numpy(seqops.duplicate_mask(interop.to_tensor(rows.view("<u4"), device),
                                                 interop.to_tensor(lens, device)))
    keep = [e for e, d in zip(entries, dup) if not d]
    write_nup(args.output, [n for n, _, _ in keep], [w for _, _, w in keep], [length for _, length, _ in keep],
              codec)
    print(json.dumps({"records": len(entries), "kept": len(keep), "removed": int(dup.sum())}))
    return 0


def _dataset_sketch(path: str, args):
    """One dataset-level sketch of every read in ``path`` (FASTA/FASTQ or a
    2-bit .nup): -> (sorted u32[s] sketch, records, total_nt).  Reads sketch
    in padded batches of ``--batch`` records; the batch sketches union-merge
    (:func:`ops.sketch.merge`), which is exact because merging is
    associative."""
    import torch

    from . import interop
    from .models import TwoBitCodec, resolve_device
    from .ops import sketch as sketch_lib
    from .ops import spec, validate
    from .utils import io as io_lib

    def sketch_batch(words, lengths, invalid=None):
        if args.scale:
            sk, _ = sketch_lib.frac_sketch_batch(words, lengths, args.k, scale=args.scale, cap=args.s,
                                                 canonical=not args.no_canonical, invalid=invalid)
            return sk
        return sketch_lib.bottom_k_sketch_batch(words, lengths, args.k, args.s,
                                                canonical=not args.no_canonical, invalid=invalid)

    acc = None
    records = 0
    total_nt = 0
    device = resolve_device(args.tier)
    if path.endswith(".nup"):
        codec, entries = read_nup(path)
        if codec != "2bit":
            raise ValueError(f"{path}: sketch requires a 2-bit stream")
        rows = [(length, spec.u64_to_u32_pairs(np.ascontiguousarray(words)).reshape(-1))
                for _, length, words in entries]
        for i in range(0, len(rows), args.batch):
            chunk = rows[i : i + args.batch]
            # rows as wide as the chunk's longest record
            W = max(w.shape[0] for _, w in chunk)
            words = np.zeros((len(chunk), W), np.uint32)
            lengths = np.zeros(len(chunk), np.int32)
            for j, (n, w) in enumerate(chunk):
                words[j, : w.shape[0]] = w
                lengths[j] = n
                records += 1
                total_nt += n
            sk = sketch_batch(interop.to_tensor(words, device), lengths)
            acc = sk if acc is None else sketch_lib.merge(acc, sk)
    else:
        recs = list(io_lib.open_reads(path))
        if recs:
            codec = TwoBitCodec(tier=args.tier)
            max_len = max(len(r.seq) for r in recs)
            stream = io_lib.BatchStream(recs, batch_size=args.batch, max_len=max_len, block=codec.block)
            for b in stream:
                reads = torch.from_numpy(b.reads).to(codec.device)
                words = codec.encode(reads)
                # the Mash/sourmash rule: k-mers touching N (or any byte the
                # 2-bit code cannot hold) are dropped, not hashed as G
                sk = sketch_batch(words, b.lengths, invalid=~validate.valid_mask(reads))
                acc = sk if acc is None else sketch_lib.merge(acc, sk)
                records += b.count
                total_nt += int(b.lengths.sum())
    if acc is None:
        acc = interop.to_tensor(np.full(args.s, sketch_lib.SENTINEL, np.uint32), device)
    return acc, records, total_nt


def cmd_sketch(args) -> int:
    """MinHash-sketch datasets and estimate pairwise similarity (Mash-style).

    Each input (FASTA/FASTQ/.nup) reduces to one sorted-hash summary built
    from packed words (:mod:`ops.sketch`); with two or more inputs it prints
    the pairwise Jaccard / containment / Mash-distance table computed from
    the summaries alone.  ``--tier`` encodes FASTA/FASTQ input and picks the
    device (``auto``: the card when there is one).
    """
    import torch

    from .ops import sketch as sketch_lib

    if args.k > 31:
        print("error: k must be <= 31", file=sys.stderr)
        return 2
    datasets = []
    for path in args.inputs:
        try:
            sk, records, nt = _dataset_sketch(path, args)
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        datasets.append((path, sk, records, nt))
    out = {
        "k": args.k,
        "scheme": ({"name": "fracminhash", "scale": args.scale, "cap": args.s}
                   if args.scale else {"name": "bottom-s", "s": args.s}),
        "canonical": not args.no_canonical,
    }
    ds_rows = []
    for path, sk, records, nt in datasets:
        row = {"path": path, "records": records, "nt": nt,
               "hashes": int((sk.view(torch.int32) != -1).sum())}
        if args.scale:
            # a full buffer means the retained sample was truncated and the
            # scheme's unbiased containment no longer holds
            row["saturated"] = row["hashes"] >= args.s
            if row["saturated"]:
                print(f"warning: {path}: FracMinHash buffer saturated at {args.s} hashes — "
                      f"containment/Jaccard will be underestimated; raise -s or --scale", file=sys.stderr)
        ds_rows.append(row)
    out["datasets"] = ds_rows
    pairs = []
    for i in range(len(datasets)):
        for j in range(i + 1, len(datasets)):
            pa, sa, _, _ = datasets[i]
            pb, sb, _, _ = datasets[j]
            jac = float(sketch_lib.jaccard(sa, sb))
            pairs.append({
                "a": pa,
                "b": pb,
                "jaccard": round(jac, 6),
                "mash_distance": round(sketch_lib.mash_distance(jac, args.k), 6),
                "containment_a_in_b": round(float(sketch_lib.containment(sa, sb)), 6),
                "containment_b_in_a": round(float(sketch_lib.containment(sb, sa)), 6),
            })
    if pairs:
        out["pairs"] = pairs
    print(json.dumps(out))
    return 0


def cmd_bench(args) -> int:
    from . import bench

    return bench.main()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cute-nucleotides-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="encode reads to a packed .nup file")
    pe.add_argument("input")
    pe.add_argument("output")
    pe.add_argument("--codec", choices=_CODECS, default="2bit")
    pe.add_argument("--tier", default="auto", choices=TIERS)
    pe.add_argument("--validate", action="store_true")
    pe.add_argument(
        "--batch", type=int, default=0,
        help="reads per device batch (0 = per-record host path)",
    )
    pe.add_argument("--max-len", type=int, default=65536,
                    help="longest read a batch accepts")
    pe.set_defaults(fn=cmd_encode)

    pd = sub.add_parser("decode", help="decode a .nup file to FASTA")
    pd.add_argument("input")
    pd.add_argument("output", nargs="?", default="-")
    pd.add_argument("--tier", default="auto", choices=TIERS)
    pd.add_argument(
        "--verify-stream", action="store_true",
        help="refuse a base-5 stream with a corrupt word (exit 1, naming it)",
    )
    pd.add_argument(
        "--batch", type=int, default=0, metavar="N",
        help="decode N records per device batch (the production path)",
    )
    pd.set_defaults(fn=cmd_decode)

    pp = sub.add_parser("parity", help="randomized oracle parity gate")
    pp.add_argument("--trials", type=int, default=50)
    pp.add_argument("--max-len", type=int, default=5000)
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--tiers", default="auto")
    pp.set_defaults(fn=cmd_parity)

    pg = sub.add_parser(
        "grep",
        help="find a pattern in packed records, no decode (2-bit: N = wildcard; "
        "base-5: N literal, ? = wildcard)",
    )
    pg.add_argument("input")
    pg.add_argument("pattern")
    pg.add_argument("--both", action="store_true",
                    help="also scan the reverse strand (revcomp pattern, + / - in output)")
    pg.add_argument("--count", action="store_true",
                    help="print per-record totals instead of individual hits")
    pg.add_argument("--batch", type=int, default=0, metavar="N",
                    help="scan N records per device call (fixed-shape batches)")
    pg.set_defaults(fn=cmd_grep)

    pa = sub.add_parser("approx", help="best approximate occurrence of a query per record (Myers bit-parallel "
                        "edit distance on packed words; N in query = any)")
    pa.add_argument("input", help=".nup container (either codec)")
    pa.add_argument("pattern", help="query (2-bit: N = any base; base-5: N literal, ? = any)")
    pa.add_argument("--both", action="store_true", help="also align the reverse strand; report each record's best")
    pa.add_argument("--max-errors", type=int, default=-1, metavar="E",
                    help="only report records with edit distance <= E (exit 1 if none)")
    pa.add_argument("--all", action="store_true",
                    help="report EVERY end position within --max-errors, not just each record's best (2-bit "
                    "containers)")
    pa.add_argument("--cigar", action="store_true",
                    help="add match start + SAM CIGAR (host DP on the <= 2m-1 nt window around each reported "
                    "end; reverse-strand hits stay in forward coordinates)")
    pa.add_argument("--batch", type=int, default=128, metavar="N", help="records per device call (fixed-shape batches)")
    pa.set_defaults(fn=cmd_approx)

    pt = sub.add_parser("translate", help="translate .nup records to protein FASTA (packed-domain codons)")
    pt.add_argument("input")
    pt.add_argument("output", nargs="?", default="-")
    pt.add_argument("--frames", default="1",
                    help="'all' or comma list from 1,2,3,-1,-2,-3 (EMBOSS numbering)")
    pt.set_defaults(fn=cmd_translate)

    pu = sub.add_parser("dedup", help="remove exact-duplicate records (packed-word equality, first occurrence wins)")
    pu.add_argument("input", help=".nup container (either codec)")
    pu.add_argument("output", help="deduplicated .nup")
    pu.set_defaults(fn=cmd_dedup)

    ps = sub.add_parser("stats", help="packed-domain GC content + top k-mers")
    ps.add_argument("input")
    ps.add_argument("-k", type=int, default=8)
    ps.add_argument("--top", type=int, default=5)
    ps.add_argument("--canonical", action="store_true")
    ps.add_argument("--tier", default="auto", choices=TIERS)
    ps.set_defaults(fn=cmd_stats)

    pr = sub.add_parser("region", help="extract subsequences (NAME:START-END) on the packed domain")
    pr.add_argument("input")
    pr.add_argument("regions", nargs="+", metavar="NAME:START-END")
    pr.add_argument("-o", "--output", default="-")
    pr.add_argument("--packed", action="store_true",
                    help="write a .nup of the still-packed windows instead of FASTA")
    pr.add_argument("--tier", default="auto", choices=TIERS)
    pr.set_defaults(fn=cmd_region)

    pk = sub.add_parser(
        "sketch",
        help="MinHash-sketch datasets and estimate pairwise similarity "
        "(Jaccard / containment / Mash distance) from packed k-mers",
    )
    pk.add_argument(
        "inputs", nargs="+", metavar="READS",
        help="FASTA/FASTQ files (k-mers touching N are skipped, the Mash rule) or "
        "2-bit .nup containers (which cannot hold N — encode them with --validate)",
    )
    pk.add_argument("-k", type=int, default=21, help="k-mer size (<= 31)")
    pk.add_argument("-s", type=int, default=1000,
                    help="sketch size (bottom-s) or buffer capacity (--scale mode)")
    pk.add_argument(
        "--scale", type=int, default=0, metavar="N",
        help="FracMinHash mode: keep hashes below 2^32/N (sourmash's scheme; "
        "better containment across dataset sizes)",
    )
    pk.add_argument("--no-canonical", action="store_true", help="hash forward-strand k-mers only")
    pk.add_argument("--batch", type=int, default=256, help="reads per device batch")
    pk.add_argument("--tier", default="auto", choices=("auto", "torch", "cuda"),
                    help="codec-model tier for encoding ASCII inputs, and the device")
    pk.set_defaults(fn=cmd_sketch)

    pb = sub.add_parser("bench", help="benchmark the kernels and tiers on the card (prints one JSON line)")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # the reader closed the pipe early (`grep ... | head`): the
        # conventional SIGPIPE exit, and nothing more written to stdout
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 141
    except (ValueError, KeyError, OSError) as e:
        # malformed or missing containers: one line and exit 1, no traceback
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
