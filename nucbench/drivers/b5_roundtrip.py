"""Base-5 batch codec round trips on read batches resident on the card.

Each step is ``Base5Codec.encode_checked`` of one resident u8[R, L] batch,
then ``Base5Codec.decode_checked`` of its words: the main path of a GPU-side
pipeline (basecaller output or parsed reads already on the card), kernels
#5 and #6.  Steps take the batches in turns and are dispatched ahead with no
synchronize; the flags stay on the card until the window closes.

Checked: the packed words and decoded bytes of the sampled rows of the
sampled steps and of each batch's last step whole, and every step's two
flags, against the plain reference (:mod:`nucbench.reference.b5`).  The
control is that reference with N dropped to A, the 2-bit shortcut that
loses the guarantee that N survives.

Traffic keys: ``reads_a_batch``, ``batches``, ``no_call`` (``{"batch",
"count", "byte"}``: bytes outside the alphabet planted in one batch, so
that its encode flag reads true), ``sampled_steps``.  Config keys:
``read_nt``, ``padded_nt``, ``n_share``.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from nucbench import generate, roofline, window
from nucbench.harness import Check
from nucbench.reference import b5 as ref

#: bursts, and round trips a burst, of the enqueue probe (traced runs only)
PROBE_BURSTS, PROBE_STEPS = 20, 16


@dataclasses.dataclass
class State:
    loop: window.Batches
    read_nt: int
    reads: int
    bound_s: float


def inputs(ctx, config: dict, traffic: dict, rank: int) -> list[torch.Tensor]:
    """Rank ``rank``'s resident batches, from the seed."""
    out = []
    for b in range(traffic["batches"]):
        x = generate.reads(ctx.device, ctx.seed, (rank, b), traffic["reads_a_batch"], config["read_nt"],
                           config["padded_nt"], config["n_share"])
        nc = traffic.get("no_call")
        if nc and nc["batch"] == b:
            rng = generate.np_rng(ctx.seed, "no_call", rank)
            rows = torch.from_numpy(rng.integers(0, x.shape[0], nc["count"])).to(ctx.device)
            cols = torch.from_numpy(rng.integers(0, config["read_nt"], nc["count"])).to(ctx.device)
            x[rows, cols] = ord(nc["byte"])
        out.append(x)
    return out


def program_step(codec):
    def step(ctx, x):
        with ctx.spans("batch_codec.encode_checked"):
            words, bad_in = codec.encode_checked(x)
        with ctx.spans("batch_codec.decode_checked"):
            back, bad_words = codec.decode_checked(words)
        return (words, back), (bad_in, bad_words)

    return step


def control_step(ctx, x):
    """The reference in the program's place, with N dropped to A."""
    d = ref.digits(x)
    d[d == 4] = 0
    words = ref.pack(d)
    return (words, ref.chars(ref.unpack(words))), (torch.tensor(ref.has_invalid(x)), torch.tensor(False))


def round_trip_bound_s(nt: int) -> float:
    return roofline.bound_s(roofline.encode_b5_bytes(nt)) + roofline.bound_s(roofline.decode_b5_bytes(nt))


def setup(ctx, config: dict, traffic: dict) -> State:
    from cute_nucleotides_tpu_torch import models

    xs = inputs(ctx, config, traffic, ctx.rank)
    step = control_step if ctx.control else program_step(models.Base5Codec(device=ctx.device))
    st = State(window.Batches(xs, step, window.sample_steps(ctx.seed, traffic["sampled_steps"])),
               config["read_nt"], xs[0].shape[0], round_trip_bound_s(xs[0].numel()))
    window.warm(ctx, st.loop, traffic["sampled_steps"] // len(xs) + 2)
    return st


def probe(ctx, st: State) -> None:
    """Host time to enqueue round trips right after a synchronize, in bursts
    short enough that the launch queue never fills: spans
    ``probe.enqueue``."""
    for _ in range(PROBE_BURSTS):
        ctx.sync()
        with ctx.spans("probe.enqueue", always=True):
            for k in range(PROBE_STEPS):
                st.loop.step(ctx, st.loop.inputs[k % len(st.loop.inputs)])
        ctx.work["probe.round_trips"] += PROBE_STEPS
    ctx.sync()


def measure(ctx, st: State, seconds: float) -> None:
    def work(c):
        c.work["codec_bound_s"] += st.bound_s

    window.run(ctx, st.loop, seconds, work)


def summary(ctx, st: State) -> dict:
    return {"attempted": st.loop.steps, "nt": st.loop.steps * st.reads * st.read_nt, "window_s": st.loop.window_s,
            "pace": st.loop.pace}


def check(ctx, st: State) -> list[Check]:
    """One number, compared exactly: the words, decoded bytes and flags of
    the kept steps (every step's flags) that differ from the reference's.
    Its parts go to standard error before the checks."""
    words_bad = back_bad = in_flag_bad = word_flag_bad = 0
    for b, x in enumerate(st.loop.inputs):
        d = ref.digits(x)
        want_words, want_back = ref.pack(d), ref.chars(d)
        del d
        for (words, back), (ww, wb) in st.loop.against(b, (want_words, want_back)):
            words_bad += ref.mismatches(words, ww)
            back_bad += ref.mismatches(back, wb)
        flags = st.loop.small.get(b, [])
        in_flag_bad += int(np.sum(window.flat([f for f, _ in flags]) != ref.has_invalid(x)))
        word_flag_bad += int(np.sum(window.flat([f for _, f in flags])))
    print(f"nucbench: round-trip mismatches: words {words_bad}, decoded bytes {back_bad}, input flags {in_flag_bad}, "
          f"word flags {word_flag_bad}", file=sys.stderr)
    return [Check("roundtrip_mismatch", words_bad + back_bad + in_flag_bad + word_flag_bad, 0)]
