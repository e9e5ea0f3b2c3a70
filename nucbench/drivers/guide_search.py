"""Genome-wide guide search: SpCas9 off-target search on a genome held
packed on the card, as Cas-OFFinder runs it, by edit distance.

One client in a closed loop: each guide (a spacer and the PAM, ``N`` a
wildcard) is searched on both strands (the guide and its reverse complement)
of every chromosome, one ``ops.align.best_match_stream`` call each: the
stream plan's rows and halos, kernel #19 and the reduction, and the glue
and read-back of every call.  A guide's latency runs from its send to all
its results in hand; the next guide is sent then.

Checked: every ``(distance, end)`` of a sample of the answered guides drawn
from the seed, against the plain Myers reference over the same packed words
(:mod:`nucbench.reference.myers`).  The control is that reference with the
PAM's ``N`` read as a literal ``A``, which drops the wildcard.

Traffic keys: ``guide_pool``, ``spacer_nt``, ``pam``, ``from_genome``,
``checked_guides``.  Config keys: ``chromosomes`` (name -> length).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from nucbench import generate, roofline
from nucbench.harness import Check
from nucbench.reference import myers

#: 2-bit code of each query byte, as the crate folds bytes: A 0, C 1, T 2, G 3
CODE2 = {ord("A"): 0, ord("C"): 1, ord("T"): 2, ord("G"): 3}
#: text nt a reference row, before its overlap
ROW_NT = 1024


@dataclasses.dataclass
class State:
    words: torch.Tensor
    offsets: list
    lengths: list
    pool: list
    search: object
    floor_ops: int
    checked: int
    sent: int = 0
    window_s: float = 0.0
    latencies: list = dataclasses.field(default_factory=list)
    #: (pool index, [(dist, end)] by chromosome then strand) of each answered guide
    answers: list = dataclasses.field(default_factory=list)


def reference(words: torch.Tensor, offsets: list, lengths: list, queries: list[bytes],
              literal_n: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """``(dist, end)`` int64[len(queries), chromosomes] of each query's best
    occurrence in each chromosome: rows of :data:`ROW_NT` nt overlapping by
    ``2 m`` nt, so that every alignment better than ``m`` lies whole in one
    row."""
    dev = words.device
    m = len(queries[0])
    ov = 2 * m
    starts, chrom, rlen = [], [], []
    for c, n in enumerate(lengths):
        s = np.arange(0, n, ROW_NT, dtype=np.int64)
        starts.append(s)
        chrom.append(np.full(len(s), c, np.int64))
        rlen.append(np.minimum(ROW_NT + ov, n - s))
    start = torch.from_numpy(np.concatenate(starts)).to(dev)
    chrom_t = torch.from_numpy(np.concatenate(chrom)).to(dev)
    rows = start.shape[0]
    base = torch.tensor(offsets, dtype=torch.int64, device=dev)[chrom_t] * 16
    first = base + start
    last = base + torch.tensor(lengths, dtype=torch.int64, device=dev)[chrom_t] - 1
    w = words.view(torch.int32)
    Q = len(queries)

    def codes(s0, s1):
        g = torch.minimum(first[None, :] + torch.arange(s0, s1, device=dev)[:, None], last[None, :])
        c = (w[g >> 4] >> ((g & 15) * 2).to(torch.int32)) & 3
        return c.long().repeat(1, Q)

    code_of = {**CODE2, ord("N"): 0} if literal_n else CODE2
    tables = [myers.peq(q, code_of, 4, b"" if literal_n else b"N") for q in queries]
    lane_query = torch.arange(Q, device=dev).repeat_interleave(rows)
    best, end = myers.scan(codes, ROW_NT + ov, tables, lane_query, m,
                           torch.from_numpy(np.concatenate(rlen)).to(dev).repeat(Q))
    group = lane_query * len(lengths) + chrom_t.repeat(Q)
    d, e = myers.first_best(best, start.repeat(Q) + end, group, Q * len(lengths), m)
    return d.view(Q, -1).cpu().numpy(), e.view(Q, -1).cpu().numpy()


def _program(align, views: list):
    def search(ctx, strands):
        out = []
        for view, n in views:
            for q in strands:
                with ctx.spans("packed_ops.best_match_stream"):
                    out.append(align.best_match_stream(view, n, q))
        return out

    return search


def _control(st_ref):
    def search(ctx, strands):
        d, e = reference(*st_ref, list(strands), literal_n=True)
        return [(int(d[s, c]), int(e[s, c])) for c in range(d.shape[1]) for s in range(len(strands))]

    return search


def setup(ctx, config: dict, traffic: dict) -> State:
    from cute_nucleotides_tpu_torch.ops import align

    lengths = list(config["chromosomes"].values())
    words, offsets = generate.genome_2bit(ctx.device, ctx.seed, lengths)
    pool = generate.guides(generate.np_rng(ctx.seed, "guides"), words, offsets, lengths, traffic["guide_pool"],
                           traffic["spacer_nt"], traffic["pam"].encode(), traffic["from_genome"])
    views = [(words[o: o + 4 * -(-n // 64)], n) for o, n in zip(offsets, lengths)]
    search = _control((words, offsets, lengths)) if ctx.control else _program(align, views)
    nb = -(-len(pool[0]) // 32)
    floor = 2 * sum(roofline.myers_ops(n, nb, mode="semiglobal") for n in lengths)
    st = State(words, offsets, lengths, pool, search, floor, traffic["checked_guides"])
    search(ctx, (pool[-1], generate.revcomp(pool[-1])))  # warm-up: every chromosome's shapes once
    return st


def measure(ctx, st: State, seconds: float) -> None:
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        i = st.sent % len(st.pool)
        sent = time.perf_counter()
        with ctx.spans("client.guide"):
            got = st.search(ctx, (st.pool[i], generate.revcomp(st.pool[i])))
        done = time.perf_counter()
        st.latencies.append(done - sent)
        st.answers.append((i, got))
        st.sent += 1
        if ctx.tracing:
            ctx.work["queries"] += 1
            ctx.work["myers_floor_ops"] += st.floor_ops
        if done >= t_end:
            break
    ctx.sync()
    st.window_s += time.perf_counter() - t0


def summary(ctx, st: State) -> dict:
    return {"attempted": st.sent, "queries": len(st.answers), "latencies_s": st.latencies, "window_s": st.window_s}


def check(ctx, st: State) -> list[Check]:
    picks = generate.np_rng(ctx.seed, "checked").choice(len(st.answers), min(len(st.answers), st.checked),
                                                        replace=False)
    bad = 0
    for a in picks:
        i, got = st.answers[a]
        d, e = reference(st.words, st.offsets, st.lengths, [st.pool[i], generate.revcomp(st.pool[i])])
        want = [(int(d[s, c]), int(e[s, c])) for c in range(len(st.lengths)) for s in range(2)]
        bad += sum(g != w for g, w in zip(got, want))
    return [Check("dist_end_mismatch", bad, 0)]
