"""The ``.nup`` packed container and FASTA output of the CLI.

The port's copy of ``write_nup``, ``NupReader``, ``read_nup`` and
``_write_fasta`` from ``cute_nucleotides_tpu/cli.py``; files are
byte-identical between the two packages::

    magic b"NUPK" | version u32 | codec u8 (2=2bit, 5=base5) | reserved[3]
    count u64 | (name_len u32, length u64)*count | names | packed words

Words are the reference crate's little-endian u64 stream per record,
concatenated (each record starts word-aligned).  numpy only.
"""

from __future__ import annotations

import struct

import numpy as np

from .ops import spec

MAGIC = b"NUPK"
VERSION = 1


def write_nup(path: str, names: list[bytes], seqs_words: list[np.ndarray],
              lengths: list[int], codec: str) -> None:
    code = 2 if codec == "2bit" else 5
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<IB3x", VERSION, code))
        f.write(struct.pack("<Q", len(names)))
        for name, length in zip(names, lengths):
            f.write(struct.pack("<IQ", len(name), length))
        for name in names:
            f.write(name)
        for words in seqs_words:
            f.write(np.ascontiguousarray(words, dtype="<u8").tobytes())


class NupReader:
    """A .nup container: the header (magic + per-record name/length table)
    is read eagerly, a record's packed words with one ``seek`` when it is
    reached, so extracting one region of a many-GB container reads the
    header and that record only.  Duplicate record names resolve to the
    first occurrence."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        try:
            if self._f.read(4) != MAGIC:
                raise ValueError("not a .nup file")
            version, code = struct.unpack("<IB3x", self._f.read(8))
            if version != VERSION:
                raise ValueError(f"unsupported version {version}")
            if code == 2:
                self.codec = "2bit"
            elif code == 5:
                self.codec = "base5"
            else:
                raise ValueError(f"unknown codec byte {code} (expected 2 or 5)")
            (count,) = struct.unpack("<Q", self._f.read(8))
            meta = [struct.unpack("<IQ", self._f.read(12)) for _ in range(count)]
            self.names = [self._f.read(nl) for nl, _ in meta]
            self.lengths = [int(length) for _, length in meta]
            per_word = spec.NT_PER_WORD_2BIT if self.codec == "2bit" else spec.NT_PER_WORD_B5
            off = self._f.tell()
            self._offsets, self._nwords = [], []
            for length in self.lengths:
                nw = spec.cdiv(length, per_word)
                self._offsets.append(off)
                self._nwords.append(nw)
                off += 8 * nw
            self._by_name: dict[bytes, int] = {}
            for i, name in enumerate(self.names):
                self._by_name.setdefault(name, i)
        except Exception:
            self._f.close()
            raise

    def __len__(self) -> int:
        return len(self.names)

    def __contains__(self, name: bytes) -> bool:
        return name in self._by_name

    def words(self, i: int) -> np.ndarray:
        """Packed u64 words of record ``i`` (one seek + one read)."""
        self._f.seek(self._offsets[i])
        raw = self._f.read(8 * self._nwords[i])
        if len(raw) != 8 * self._nwords[i]:
            # a truncated container errors instead of decoding zero padding
            raise ValueError(
                f"truncated container: record {i} "
                f"({self.names[i].decode(errors='replace')!s}) needs "
                f"{8 * self._nwords[i]} bytes, file holds {len(raw)}"
            )
        return np.frombuffer(raw, dtype="<u8")

    def get(self, name: bytes) -> tuple[int, np.ndarray]:
        """``(length, words)`` of the first record named ``name``."""
        i = self._by_name[name]
        return self.lengths[i], self.words(i)

    def __iter__(self):
        for i, (name, length) in enumerate(zip(self.names, self.lengths)):
            yield name, length, self.words(i)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "NupReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_nup(path: str):
    with NupReader(path) as r:
        return r.codec, list(r)


def write_fasta(out, name: bytes, data: bytes) -> None:
    """One FASTA record, sequence lines of 80 characters."""
    out.write(b">" + name + b"\n")
    for i in range(0, len(data), 80):
        out.write(data[i : i + 80] + b"\n")
