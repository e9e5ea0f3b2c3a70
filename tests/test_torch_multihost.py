"""The port's runtime across processes, the mirror of
``tests/test_multihost.py``: two CPU processes of the port join one gloo
group through ``runtime.initialize`` and stream a shared record set through
``StreamingEncoder`` (host-sharded by record index); each writes its sunk
words, and the parent checks that the union covers every record bit-exactly
against the oracle and that each process consumed exactly its residue
class, and that ``default_mesh()`` spans what ``initialize`` reports as
``global_devices``.  The workers import only the port (the cards hidden), as
a rank on a GPU host would."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from cute_nucleotides_tpu.ops import oracle, spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import json, os, sys

proc_id, coord, outdir, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]

from cute_nucleotides_tpu_torch import parallel
from cute_nucleotides_tpu_torch.parallel import runtime
from cute_nucleotides_tpu_torch.utils import io as io_lib

if mode == "args":
    info = runtime.initialize(coordinator_address=coord, num_processes=2, process_id=proc_id)
else:  # a coordinator address alone: the count and the id come from the environment
    info = runtime.initialize(coordinator_address=coord)
assert info["process_count"] == 2 and info["process_index"] == proc_id, info
mesh_size = parallel.default_mesh().size  # the process mesh spans the group

reads = [("r%d" % i).encode() for i in range(10)]
seqs = [bytes((b"ACGT" * (i + 3))[: 4 * (i + 3)]) for i in range(10)]
records = [io_lib.Record(n, s) for n, s in zip(reads, seqs)]

got = {}
enc = runtime.StreamingEncoder(batch_size=4, max_len=64, tier="torch")
def sink(words, batch):
    for row in range(batch.count):
        got[int(batch.indices[row])] = words[row].tolist()
agg = enc.run(records, sink=sink)
with open(os.path.join(outdir, "h%d.json" % proc_id), "w") as f:
    json.dump({"agg": agg, "info": info, "mesh_size": mesh_size, "got": {str(k): v for k, v in got.items()}}, f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    return dict(env, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO, **extra)


def _run_pair(tmp_path, mode: str) -> list[dict]:
    coord = f"localhost:{_free_port()}"
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), coord, str(tmp_path), mode],
            env=_env(WORLD_SIZE="2", RANK=str(i)) if mode == "env" else _env(),
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed rc={p.returncode}:\n{se[-2000:]}"
    return [json.load(open(tmp_path / f"h{i}.json")) for i in range(2)]


@pytest.mark.parametrize("mode", ["args", "env"])
def test_two_process_streaming(tmp_path, mode):
    results = _run_pair(tmp_path, mode)
    seqs = [bytes((b"ACGT" * (i + 3))[: 4 * (i + 3)]) for i in range(10)]
    seen = {}
    for h, res in enumerate(results):
        assert res["info"] == {"process_index": h, "process_count": 2, "local_devices": 1, "global_devices": 2}
        assert res["mesh_size"] == res["info"]["global_devices"]
        assert (res["agg"]["host_id"], res["agg"]["num_hosts"]) == (h, 2)
        for k, words in res["got"].items():
            idx = int(k)
            assert idx % 2 == h, f"record {idx} on wrong host {h}"
            seen[idx] = np.asarray(words, dtype=np.uint32)
    assert sorted(seen) == list(range(10))
    for idx, w32 in seen.items():
        want = oracle.n_to_bits_lut(np.frombuffer(seqs[idx], np.uint8))
        got = spec.u32_pairs_to_u64(w32)[: want.size]
        assert np.array_equal(got, want), idx
    assert sum(r["agg"]["total_reads"] for r in results) == 10


def test_a_coordinator_address_alone_is_never_one_process():
    """With neither a process count nor an id, in the call or the
    environment, initialize raises rather than report a one-process
    topology (every process would then consume the whole stream)."""
    code = (
        "import sys\n"
        "from cute_nucleotides_tpu_torch.parallel import runtime\n"
        f"try:\n    info = runtime.initialize('localhost:{_free_port()}')\n"
        "except (ValueError, RuntimeError) as e:\n    print('RAISED', type(e).__name__)\n"
        "else:\n    sys.exit(f'returned {info}')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and "RAISED" in proc.stdout, proc.stdout + proc.stderr
