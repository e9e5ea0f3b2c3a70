"""Kernel #19 (the Myers scan, ``csrc/align.cu``) on the card, beside the
checks and timings of ``chip_smoke.py``.  Needs CUDA and ``nvcc``::

    python -m cute_nucleotides_tpu_torch.bench_myers sweep
    python cute_nucleotides_tpu_torch/bench_myers.py rows [--tree DIR]

``sweep`` times the two lane forms that the launch plan chooses between for
queries of two or more blocks -- one block a lane on pow2(nb) lanes, and two
blocks a lane on half as many -- at nb = 2, 4 and 8 over 1024..32768 pairs of
a full-length query and a 1024-nt text, in every mode.  It
builds ``csrc/align.cu`` twice with ``CN_MYERS_BPL`` set to 1 and 2, so that
each build takes one form at every batch size, and times each build's
``cn_myers``, and the shipped library's beside them, by CUDA events (the best
of 2 runs of 20 calls); the three must agree on every pair.

``rows`` runs the bench's rows that launch #19 (``edit_distance_m128_n2048``
and ``approx_stream_m21``, at the bench's full workload) as the bench times
them (``bench.cuda_timer``, ``RUNS`` times), then ``PROFILED`` calls of each
under ``torch.profiler``: #19's device time a call beside that of every
device event.  ``--tree DIR`` imports the package, its bench included, from
another checkout (a parent unpacked by ``git archive``), so that two trees run
through the same harness; run the file by its path for that.

Both print the card's name and power limit and its SM clock after."""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))

#: the sweep's blocks a query, pair counts and text length (nt)
SWEEP_NB = (2, 4, 8)
SWEEP_ROWS = (1024, 2048, 4096, 6144, 8192, 16384, 32768)
SWEEP_NT = 1024
#: the bench rows that launch #19, their timed runs, and calls under the profiler
ROWS = ("edit_distance_m128_n2048", "approx_stream_m21")
RUNS, PROFILED = 5, 20


def _smi(query: str) -> str:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi did not run: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def _forced_libs() -> dict:
    """{blocks a lane: ctypes library of csrc/align.cu built with CN_MYERS_BPL}."""
    from cute_nucleotides_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.CSRC_DIR, "align.cu")
    paths = {b: os.path.join(_build.BUILD_DIR, f"myers_bpl{b}-{os.getpid()}.so") for b in (1, 2)}
    t0 = time.perf_counter()
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, f"-DCN_MYERS_BPL={b}", "-shared", "-o", path, src]
                     for b, path in paths.items()])
    print(f"timing builds of align.cu: {time.perf_counter() - t0:.1f} s", flush=True)
    libs = {}
    for b, path in paths.items():
        lib = ctypes.CDLL(path)
        for name in ("cn_myers", "cn_myers_plan"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _build._SIGNATURES[name], ctypes.c_int
        libs[b] = lib
        os.unlink(path)  # loaded; the build directory keeps only the shipped library
    return libs


def _plan(lib, nb: int, rows: int, mode: int) -> tuple[int, int]:
    out = (ctypes.c_int * 2)()
    if lib.cn_myers_plan(nb, rows, mode, out):
        raise RuntimeError("cn_myers_plan failed")
    return out[0], out[1]


def sweep() -> None:
    import numpy as np
    import torch

    from cute_nucleotides_tpu_torch.ops import _build, kernels as K

    libs = {"plan": _build.load(), **{f"{b} block(s) a lane": lib for b, lib in _forced_libs().items()}}
    rng = np.random.default_rng(19)
    wt = SWEEP_NT // 16
    stream = torch.cuda.current_stream().cuda_stream
    for nb in SWEEP_NB:
        for R in SWEEP_ROWS:
            peq = torch.from_numpy(rng.integers(0, 2**32, (R, 4, nb), dtype=np.uint32)).cuda()
            ql = torch.full((R,), 32 * nb, dtype=torch.int32, device="cuda")
            words = torch.from_numpy(rng.integers(0, 2**32, R * wt, dtype=np.uint32)).cuda()
            tl = torch.full((R,), SWEEP_NT, dtype=torch.int32, device="cuda")
            errs = torch.full((R,), 3 * nb, dtype=torch.int32, device="cuda")
            for mode, code in K.MYERS_MODES.items():
                parts, outs = [], []
                for name, lib in libs.items():
                    # score (global), best and its end (semiglobal, prefix), or the ends rows
                    out = [torch.empty(R, dtype=torch.int32, device="cuda") for _ in range(3)]
                    out.append(torch.zeros((R, SWEEP_NT), dtype=torch.uint8, device="cuda"))
                    use = {"global": (0,), "ends": (3,)}.get(mode, (1, 2))
                    ptrs = [out[i].data_ptr() if i in use else None for i in range(4)]

                    def call(lib=lib, ptrs=ptrs):
                        K._launch(lib.cn_myers, peq.data_ptr(), peq.stride(0), nb, ql.data_ptr(), words.data_ptr(),
                                  words.numel(), wt, wt, tl.data_ptr(), errs.data_ptr(), code, 0, R, *ptrs, None,
                                  stream)

                    ms = _time_ms(call)
                    outs.append(torch.cat([out[i].view(torch.uint8).reshape(-1) for i in use]))
                    parts.append(f"{name} {_plan(lib, nb, R, code)} {ms:.4f}")
                same = all(torch.equal(o, outs[0]) for o in outs[1:])
                print(f"sweep nb={nb} R={R} ({SWEEP_NT}-nt texts) {mode}: {'; '.join(parts)} ms (lanes, blocks a "
                      f"lane){'' if same else '; FORMS DISAGREE'}", flush=True)
                if not same:
                    raise SystemExit(f"the forms disagree at nb={nb} R={R} {mode}")


def rows() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cute_nucleotides_tpu_torch import bench

    print(f"package: {os.path.dirname(bench.__file__)}", flush=True)
    table = {r.name: r for r in bench.build_rows("cuda") if r.name in ROWS}
    for name in ROWS:
        row = table[name]
        runs = [bench.cuda_timer(row)[0] * 1e3 for _ in range(RUNS)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                row.step()
            torch.cuda.synchronize()
        myers = device = 0.0
        launches = 0
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            ms = ev.duration_ns() / 1e6
            device += ms
            if "myers_" in ev.name():
                myers += ms
                launches += 1
        print(f"row {name}: {' '.join(f'{t:.4f}' for t in runs)} ms a call (bench.cuda_timer, {RUNS} runs); "
              f"profiled {PROFILED} calls: #19 {myers / PROFILED:.4f} ms a call over {launches / PROFILED:g} "
              f"launch(es), every device event {device / PROFILED:.4f} ms a call", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("sweep", "rows"))
    parser.add_argument("--tree", help="import the package from this checkout (rows only)")
    args = parser.parse_args(argv)
    # run by its path, this file's directory comes first on the path: the checkout's root takes its place
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else os.path.dirname(_HERE))
    if args.tree and args.what != "rows":
        parser.error("--tree is for rows")
    import torch

    if not torch.cuda.is_available():
        print("error: bench_myers measures the card, and CUDA is not available", file=sys.stderr)
        return 1
    print(f"card: {_smi('name,power.limit')}", flush=True)
    if args.what == "sweep":
        sweep()
    else:
        rows()
    print(f"clocks after (SM, max SM, power): {_smi('clocks.sm,clocks.max.sm,power.draw')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
