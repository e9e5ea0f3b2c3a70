"""Data-parallel base-5 encode with its all-gather merge, one rank a card.

Each rank holds its own resident read batches and every step is
``parallel.data_parallel.data_parallel_encode(codec="base5", gather=True)``
over the process mesh that ``default_mesh()`` spans (NCCL on the cards, one
collective a step), so that every rank ends with the whole batch's words.
The batches are taken in turns, as in the one-card codec cell; rank 0's
clock ends the window (a gloo vote every few steps).

Checked: on every rank, the sampled rows of the gathered words of the
sampled steps and each batch's last gathered words whole, against the plain
reference's encode of every rank's batch (each rank makes all of them from
the seed).  The control is that
reference with N dropped to A.

Traffic keys: ``reads_a_batch`` (a rank's), ``batches``, ``sampled_steps``.
"""

from __future__ import annotations

import dataclasses

import torch

from nucbench import roofline, window
from nucbench.harness import Check
from nucbench.drivers import b5_roundtrip
from nucbench.reference import b5 as ref


@dataclasses.dataclass
class State:
    loop: window.Batches
    config: dict
    traffic: dict
    bound_s: float
    recv_bytes: int


def setup(ctx, config: dict, traffic: dict) -> State:
    from cute_nucleotides_tpu_torch.parallel import data_parallel, mesh as mesh_lib, runtime

    runtime.initialize()
    mesh = mesh_lib.default_mesh()
    axis = mesh.axis(mesh_lib.DATA_AXIS)
    xs = b5_roundtrip.inputs(ctx, config, traffic, ctx.rank)
    nt = xs[0].numel()
    if ctx.control:
        inputs = _every_rank(ctx, config, traffic)

        def step(c, batch):
            return torch.cat([b5_roundtrip.control_step(c, y)[0][0] for y in batch]), None
    else:
        inputs = [mesh_lib.ShardedTensor([x], axis=axis) for x in xs]

        def step(c, sharded):
            with c.spans("parallel.data_parallel_encode"):
                out = data_parallel.data_parallel_encode(sharded, mesh=mesh, codec="base5", gather=True)
            return out.shards[0], None

    words_bytes = roofline.B5_WORD_BYTES * (nt // roofline.NT_PER_WORD_B5)
    st = State(window.Batches(inputs, step, window.sample_steps(ctx.seed, traffic["sampled_steps"])), config, traffic,
               roofline.bound_s(roofline.encode_b5_bytes(nt)), (ctx.world - 1) * words_bytes)
    window.warm(ctx, st.loop, traffic["sampled_steps"] // len(xs) + 2)
    return st


def _every_rank(ctx, config: dict, traffic: dict) -> list[list[torch.Tensor]]:
    """Batch ``b`` of every rank, by ``b``: what the gathered words hold."""
    by_rank = [b5_roundtrip.inputs(ctx, config, traffic, r) for r in range(ctx.world)]
    return [list(xs) for xs in zip(*by_rank)]


def measure(ctx, st: State, seconds: float) -> None:
    def work(c):
        c.work["codec_bound_s"] += st.bound_s
        c.work["allgather_recv_bytes"] += st.recv_bytes

    window.run(ctx, st.loop, seconds, work)


def summary(ctx, st: State) -> dict:
    reads = st.traffic["reads_a_batch"] * ctx.world
    return {"attempted": st.loop.steps, "nt": st.loop.steps * reads * st.config["read_nt"],
            "window_s": st.loop.window_s,
            "pace": st.loop.pace}


def check(ctx, st: State) -> list[Check]:
    want: list[list] = [[] for _ in st.loop.inputs]
    for r in range(ctx.world):
        for b, x in enumerate(b5_roundtrip.inputs(ctx, st.config, st.traffic, r)):
            want[b].append(ref.pack(ref.digits(x)))
    bad = 0
    for b, parts in enumerate(want):
        for words, w in st.loop.against(b, torch.cat(parts)):
            bad += ref.mismatches(words, w)
    return [Check("gathered_words_mismatch", bad, 0)]
