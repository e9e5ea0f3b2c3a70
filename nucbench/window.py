"""What the batch drivers share: the measured loop, the outputs kept for
the check, and the flags read at the end.

A batch driver takes its resident batches in turns, one call (a "step") at
a time, and dispatches ahead with no synchronize per step; the window ends
with one synchronize, so its time covers all the work it dispatched.  For the
check it keeps every step's small outputs (flags), the newest output of each
batch whole (what a pipeline holds while the next is made), and of a few
steps drawn from the seed among the first :data:`SAMPLE_FROM` only the
:data:`SAMPLE_ROWS` rows drawn from the seed, gathered on the card as the
step ends; so the card holds the resident batches and what is in flight,
and not a pool of kept outputs.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from . import generate

#: sampled steps are drawn among the window's first steps
SAMPLE_FROM = 64
#: rows of a sampled step's outputs kept for the check (all where fewer)
SAMPLE_ROWS = 1 << 16
#: steps between two of rank 0's votes on the window's end, where a cell has
#: several ranks (a vote is a gloo all-reduce, about a millisecond)
VOTE_EVERY = 8


def sample_steps(seed: int, k: int) -> set[int]:
    return set(int(i) for i in generate.np_rng(seed, "sample").choice(SAMPLE_FROM, k, replace=False))


def sample_rows(seed: int, n: int, device):
    """The rows of an n-row output kept from a sampled step, ascending."""
    import torch

    rows = np.sort(generate.np_rng(seed, "rows").choice(n, min(n, SAMPLE_ROWS), replace=False))
    return torch.from_numpy(rows).to(device)


def rows_of(out, rows):
    """The ``rows`` of an output: a tensor, or a tuple of tensors of one
    length."""
    if isinstance(out, (tuple, list)):
        return tuple(t.index_select(0, rows) for t in out)
    return out.index_select(0, rows)


def _length(out) -> int:
    return (out[0] if isinstance(out, (tuple, list)) else out).shape[0]


@dataclasses.dataclass
class Batches:
    """The loop's state: the resident inputs, the step to run, the outputs
    kept and the window's totals."""

    inputs: list
    step: object
    sample: set
    steps: int = 0
    window_s: float = 0.0
    #: the rows kept of a sampled step's outputs (set by :func:`warm`)
    rows: object = None
    #: (batch, the kept rows of its outputs) of the sampled steps
    kept: list = dataclasses.field(default_factory=list)
    #: the newest outputs of each batch
    last: dict = dataclasses.field(default_factory=dict)
    #: each step's small outputs, by batch
    small: dict = dataclasses.field(default_factory=dict)
    #: steps dispatched in each whole second of the windows, on the host's
    #: clock (a stall shows as a low second)
    pace: list = dataclasses.field(default_factory=list)

    def against(self, b: int, want):
        """Each kept output of batch ``b`` beside what the reference says of
        the same rows: ``want`` is the reference's answer for the whole
        batch, in the output's form."""
        for bb, out in self.kept:
            if bb == b:
                yield out, rows_of(want, self.rows)
        if b in self.last:
            yield self.last[b], want


def run(ctx, st: Batches, seconds: float, work=None) -> None:
    """Steps in turns until ``seconds`` have passed on rank 0's clock
    (checked every :data:`VOTE_EVERY` steps across ranks), then one
    synchronize.  ``st.step(ctx, batch) -> (large, small)``; ``work(ctx)``
    counts one step's yardstick work while tracing."""
    t0 = time.perf_counter()
    t_end = t0 + seconds
    n = len(st.inputs)
    first, second = st.steps, 1
    while True:
        b = st.steps % n
        large, small = st.step(ctx, st.inputs[b])
        st.small.setdefault(b, []).append(small)
        st.last[b] = large
        if st.steps in st.sample:
            st.kept.append((b, rows_of(large, st.rows)))
        if ctx.tracing and work is not None:
            work(ctx)
        st.steps += 1
        if time.perf_counter() >= t0 + second:
            st.pace.append(st.steps - first)
            first, second = st.steps, second + 1
        if ctx.world == 1:
            if time.perf_counter() >= t_end:
                break
        elif st.steps % VOTE_EVERY == 0:
            with ctx.spans("client.vote"):
                if ctx.vote(time.perf_counter() >= t_end):
                    break
    ctx.sync()
    st.window_s += time.perf_counter() - t0


def warm(ctx, st: Batches, rounds: int) -> None:
    """Run ``rounds`` (at least two) steps of every batch as the window does:
    the newest output of each batch held while the next is made, and the
    sampled rows of every step kept, so that the caching allocator holds the
    blocks the window asks for before it opens; then drop them."""
    last, kept = {}, []
    for _ in range(max(rounds, 2)):
        for b, x in enumerate(st.inputs):
            last[b] = st.step(ctx, x)[0]
            if st.rows is None:
                st.rows = sample_rows(ctx.seed, _length(last[b]), ctx.device)
            kept.append(rows_of(last[b], st.rows))
    ctx.sync()


def flat(values) -> np.ndarray:
    """Small outputs (0-d tensors on one device) as one host array: one
    stack and one copy, after the window."""
    import torch

    if not values:
        return np.zeros(0)
    return torch.stack([v.reshape(()) for v in values]).cpu().numpy()
