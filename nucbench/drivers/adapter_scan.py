"""Adapter scan over packed base-5 read batches resident on the card.

Each step is ``ops.align.best_match_packed_b5`` of one resident batch of
packed reads u32[R, 2 W] against the adapter, semiglobal: the per-read
``(distance, end)`` of the adapter's best occurrence, kernel #19 in base-5
mode with the per-row Peq build beside it.  The query's words are
replicated per read in set-up, as the API takes them.  The codec is
bypassed: the benchmark packs the reads itself (the reference's packer).

Reads are the configuration's read model; a share of them carries a 3'
adapter prefix with a few edits (cutadapt's error rate).  Checked: the
``(distance, end)`` of the sampled reads of the sampled steps and of every
read of each batch's last step, against the plain Myers reference
(:mod:`nucbench.reference.myers`).  The control is that reference with the
adapter cut to its first 32 nt, one 32-row block, the shortcut that drops
the query's second block.

Traffic keys: ``reads_a_batch``, ``batches``, ``adapter``, ``planted``
(``{"share", "len_lo", "len_hi", "edits_hi"}``), ``sampled_steps``.
"""

from __future__ import annotations

import dataclasses

import torch

from nucbench import generate, roofline, window
from nucbench.harness import Check
from nucbench.reference import b5 as ref, myers

#: base-5 digit of each query byte
CODE5 = {ord("A"): 0, ord("C"): 1, ord("T"): 2, ord("G"): 3, ord("N"): 4}
#: query rows a bit-vector block
BLOCK = 32


@dataclasses.dataclass
class State:
    loop: window.Batches
    #: digits u8[R, L] of each batch, for the reference
    digits: list
    adapter: bytes
    read_nt: int
    floor_ops: int


def _batch(ctx, config: dict, traffic: dict, b: int) -> torch.Tensor:
    x = generate.reads(ctx.device, ctx.seed, (ctx.rank, b), traffic["reads_a_batch"], config["read_nt"],
                       config["padded_nt"], config["n_share"])
    p = traffic["planted"]
    rng = generate.np_rng(ctx.seed, "adapters", ctx.rank, b)
    rows = rng.choice(x.shape[0], round(p["share"] * x.shape[0]), replace=False)
    tails, lens = generate.edited_tails(rng, len(rows), traffic["adapter"].encode(), p["len_lo"], p["len_hi"],
                                        p["edits_hi"])
    generate.plant_tails(x, rows, tails, lens, config["read_nt"])
    return x


def _query_words(adapter: bytes, rows: int, device) -> torch.Tensor:
    nt = ref.NT_PER_WORD * -(-len(adapter) // ref.NT_PER_WORD)
    q = torch.full((1, nt), ord("A"), dtype=torch.uint8, device=device)
    q[0, : len(adapter)] = torch.tensor(list(adapter), dtype=torch.uint8, device=device)
    return ref.pack(ref.digits(q)).expand(rows, -1).contiguous()


def reference(digits: torch.Tensor, adapter: bytes) -> tuple[torch.Tensor, torch.Tensor]:
    """``(distance, end)`` int64[R] of ``adapter`` in each read."""
    lanes = digits.shape[0]
    dev = digits.device
    return myers.scan(lambda s0, s1: digits[:, s0:s1].T.contiguous().long(), digits.shape[1],
                      [myers.peq(adapter, CODE5, 5)], torch.zeros(lanes, dtype=torch.int64, device=dev), len(adapter),
                      torch.full((lanes,), digits.shape[1], dtype=torch.int64, device=dev))


def setup(ctx, config: dict, traffic: dict) -> State:
    from cute_nucleotides_tpu_torch.ops import align

    adapter = traffic["adapter"].encode()
    words, digits = [], []
    for b in range(traffic["batches"]):
        d = ref.digits(_batch(ctx, config, traffic, b))
        words.append(ref.pack(d))
        digits.append(d[:, : config["read_nt"]].contiguous())
    R, L = digits[0].shape
    qwords = _query_words(adapter, R, ctx.device)
    qlens = torch.full((R,), len(adapter), dtype=torch.int32, device=ctx.device)
    tlens = torch.full((R,), L, dtype=torch.int32, device=ctx.device)

    if ctx.control:
        def step(c, b):
            return reference(digits[b], adapter[:BLOCK]), None
    else:
        def step(c, b):
            with c.spans("packed_ops.best_match_packed_b5"):
                return align.best_match_packed_b5(qwords, qlens, words[b], tlens), None

    nb = -(-len(adapter) // BLOCK)
    floor = roofline.myers_ops(R * L, nb, b5=True, mode="semiglobal")
    st = State(window.Batches(list(range(len(words))), step, window.sample_steps(ctx.seed, traffic["sampled_steps"])), digits, adapter,
               L, floor)
    window.warm(ctx, st.loop, 1)
    return st


def measure(ctx, st: State, seconds: float) -> None:
    def work(c):
        c.work["myers_floor_ops"] += st.floor_ops

    window.run(ctx, st.loop, seconds, work)


def summary(ctx, st: State) -> dict:
    R = st.digits[0].shape[0]
    return {"attempted": st.loop.steps, "nt": st.loop.steps * R * st.read_nt, "window_s": st.loop.window_s,
            "pace": st.loop.pace}


def check(ctx, st: State) -> list[Check]:
    bad = 0
    for b, d in enumerate(st.digits):
        want_d, want_e = reference(d, st.adapter)
        for (dist, end), (wd, we) in st.loop.against(b, (want_d, want_e)):
            bad += int(((dist.long() != wd) | (end.long() != we)).sum())
    return [Check("dist_end_mismatch", bad, 0)]
