"""The port's stream-position manifest (``utils/checkpoint.py``) against the
JAX package's: the same files on disk and the same positions, and the one
settled deviation, the repair of the reference's stale re-publish (a save
overrides only the hosts this instance advanced, under a lock).

Only the port is imported at the top: the two-process test's workers import
this module, and the JAX package is loaded only inside the tests that
compare with it."""

import multiprocessing
import time

import pytest

from cute_nucleotides_tpu_torch.utils import checkpoint

SAVES = 200


def _fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)


def test_shared_path_merges_hosts_as_reference(tmp_path, monkeypatch):
    from cute_nucleotides_tpu.utils import checkpoint as ref

    _fixed_clock(monkeypatch)
    out = {}
    for name, mod in (("port", checkpoint), ("ref", ref)):
        p = tmp_path / f"{name}.json"
        host_a, host_b = mod.Manifest(p), mod.Manifest(p)  # both opened before either saved
        host_a.advance(0, batches=5, records=500)
        host_a.save()
        host_b.advance(1, batches=7, records=700)
        host_b.save()
        merged = mod.Manifest(p)
        host_a.advance(0, batches=1)
        host_a.save()
        out[name] = ((merged.batches_done(0), merged.batches_done(1)), p.read_bytes())
    assert out["port"] == out["ref"]
    assert out["port"][0] == (5, 7)


def test_a_stale_entry_is_not_republished(tmp_path, monkeypatch):
    """host_a opens after host_b saved 7; host_b saves 8; host_a advances its
    own host and saves: the port keeps host_b's 8, the reference writes back
    the 7 it read at open."""
    from cute_nucleotides_tpu.utils import checkpoint as ref

    _fixed_clock(monkeypatch)
    kept = {}
    for name, mod in (("port", checkpoint), ("ref", ref)):
        p = tmp_path / f"{name}.json"
        host_b = mod.Manifest(p)
        host_b.advance(1, batches=7)
        host_b.save()
        host_a = mod.Manifest(p)
        host_b.advance(1, batches=1)
        host_b.save()
        host_a.advance(0, batches=3)
        host_a.save()
        kept[name] = (mod.Manifest(p).batches_done(1), mod.Manifest(p).batches_done(0))
    assert kept == {"port": (8, 3), "ref": (7, 3)}


def _save_many(path: str, host: int, start) -> None:
    m = checkpoint.Manifest(path)
    start.wait(timeout=60)  # both processes save at once
    for _ in range(SAVES):
        m.advance(host, batches=1, records=10)
        m.save()


def test_two_processes_saving_to_one_path_keep_both_counts(tmp_path):
    path = str(tmp_path / "m.json")
    ctx = multiprocessing.get_context("spawn")
    start = ctx.Barrier(2)
    procs = [ctx.Process(target=_save_many, args=(path, host, start)) for host in (0, 1)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert [p.is_alive() for p in procs] == [False, False]
    assert [p.exitcode for p in procs] == [0, 0]
    m = checkpoint.Manifest(path)
    assert [(m.batches_done(h), m.records_done(h)) for h in (0, 1)] == [(SAVES, 10 * SAVES)] * 2


def test_a_failed_write_leaves_the_file_and_no_temporary(tmp_path, monkeypatch):
    p = tmp_path / "m.json"
    m = checkpoint.Manifest(p)
    m.advance(0)
    m.save()
    before = p.read_bytes()

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.json, "dump", broken)
    m.advance(0)
    with pytest.raises(OSError, match="disk full"):
        m.save()
    assert p.read_bytes() == before
    assert sorted(f.name for f in tmp_path.iterdir()) == ["m.json", "m.json.lock"]
