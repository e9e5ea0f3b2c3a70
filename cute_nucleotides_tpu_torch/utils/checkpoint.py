"""Stream-position checkpointing for resumable encode and decode runs.

The port's copy of ``cute_nucleotides_tpu/utils/checkpoint.py``, with the
same file format byte for byte.  The codec is stateless, so recovery is
trivial by design: a manifest records, per host, how many batches have been
durably consumed; resume = re-open the input stream and skip that many
batches (:class:`..utils.io.BatchStream` ``skip=``).  Atomic write-rename
keeps the manifest consistent under crashes mid-update.

One deviation from the reference, a repair: its ``save`` merged every entry
this instance held over the file, so an entry of another host, as it stood
when this instance was opened, could overwrite that host's newer position
(and on resume its records were delivered twice).  Here ``save`` overrides
only the host ids this instance advanced, and holds an exclusive
``fcntl.flock`` on the sidecar ``<path>.lock`` around the read, the merge
and the ``os.replace``, so two hosts saving to one path never lose each
other's updates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import json
import os
import tempfile
import time


@dataclasses.dataclass
class StreamPosition:
    host_id: int
    batches_done: int
    records_done: int
    updated_at: float


class Manifest:
    """JSON manifest of per-host stream positions."""

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self.positions: dict[int, StreamPosition] = {}
        #: host ids this instance advanced: the only entries its save overrides
        self._advanced: set[int] = set()
        if os.path.exists(self.path):
            self._load()

    def _load(self) -> None:
        with open(self.path) as f:
            data = json.load(f)
        self.positions = {
            int(k): StreamPosition(**v) for k, v in data["hosts"].items()
        }

    @contextlib.contextmanager
    def _locked(self):
        fd = os.open(f"{self.path}.lock", os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # closing the descriptor releases the lock

    def save(self) -> None:
        with self._locked():
            merged: dict[int, StreamPosition] = {}
            try:
                with open(self.path) as f:
                    data = json.load(f)
                merged = {
                    int(k): StreamPosition(**v)
                    for k, v in data.get("hosts", {}).items()
                }
            except (OSError, ValueError, TypeError):
                pass  # absent or torn file: nothing to merge
            # this instance's own advances win; another host's entry as it
            # was read at open only fills a gap, never overwrites the file's
            for host, pos in self.positions.items():
                if host in self._advanced or host not in merged:
                    merged[host] = pos
            data = {
                "hosts": {
                    str(k): dataclasses.asdict(v) for k, v in merged.items()
                }
            }
            d = os.path.dirname(self.path) or "."
            fd, tmp = tempfile.mkstemp(dir=d, prefix=".manifest-")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(data, f, indent=1)
                os.replace(tmp, self.path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            self.positions = merged

    def advance(self, host_id: int, batches: int = 1, records: int = 0) -> None:
        pos = self.positions.get(
            host_id, StreamPosition(host_id, 0, 0, time.time())
        )
        pos.batches_done += batches
        pos.records_done += records
        pos.updated_at = time.time()
        self.positions[host_id] = pos
        self._advanced.add(host_id)

    def batches_done(self, host_id: int) -> int:
        pos = self.positions.get(host_id)
        return pos.batches_done if pos else 0

    def records_done(self, host_id: int) -> int:
        pos = self.positions.get(host_id)
        return pos.records_done if pos else 0
