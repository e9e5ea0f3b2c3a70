"""Host-side input: FASTA/FASTQ readers and batch assembly.

The port's copy of the parts of ``cute_nucleotides_tpu/utils/io.py`` it
uses, with the same behaviour: record parsers for FASTA and FASTQ (plain or
gzip; plain FASTQ through the chunked NumPy scan), :class:`BatchStream`
(fixed-shape 'A'-padded u8 batches for the batch codecs) and
:func:`pack_words_batch` (the packed-word batches of ``grep --batch``).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
from typing import BinaryIO, Iterable, Iterator

import numpy as np

from ..ops import native as _native
from ..ops import spec


@dataclasses.dataclass
class Record:
    name: bytes
    seq: bytes


def _open(path: str | os.PathLike) -> BinaryIO:
    f = open(path, "rb")
    if str(path).endswith(".gz"):
        return gzip.open(f)  # type: ignore[return-value]
    return f


def read_fasta(source) -> Iterator[Record]:
    """Iterate FASTA records from a path or binary file object."""
    f = _open(source) if isinstance(source, (str, os.PathLike)) else source
    name, chunks = None, []
    for raw in f:
        line = raw.strip()
        if not line:
            continue
        if line.startswith(b">"):
            if name is not None:
                yield Record(name, b"".join(chunks))
            name, chunks = line[1:], []
        else:
            chunks.append(line)
    if name is not None:
        yield Record(name, b"".join(chunks))


def read_fastq(source) -> Iterator[Record]:
    """Iterate FASTQ records (4-line) from a path or binary file object.

    Plain (non-gzip) paths take the NumPy chunk parser (newline indexing
    over 64 MiB blocks, with line-count framing, so ``@``/``+`` inside
    quality strings cannot desynchronize it).  File objects and gzip take
    the line reader.
    """
    if isinstance(source, (str, os.PathLike)) and not str(source).endswith(".gz"):
        return _read_fastq_np(source)
    return _read_fastq_lines(_open(source) if isinstance(source, (str, os.PathLike)) else source)


def _read_fastq_lines(f: BinaryIO) -> Iterator[Record]:
    while True:
        header = f.readline()
        if not header:
            return
        seq = f.readline().strip()
        plus = f.readline()
        f.readline()  # quality
        if not header.startswith(b"@") or not plus.startswith(b"+"):
            raise ValueError("malformed FASTQ record")
        yield Record(header[1:].strip(), seq)


def _read_fastq_np(path: str | os.PathLike, chunk_bytes: int = 1 << 26) -> Iterator[Record]:
    """Chunked NumPy FASTQ parse (4-line records; see :func:`read_fastq`)."""
    carry = b""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            buf = carry + chunk
            arr = np.frombuffer(buf, np.uint8)
            nl = np.flatnonzero(arr == ord("\n"))
            nrec = nl.size // 4
            if nrec == 0:
                carry = buf
                continue
            end = int(nl[4 * nrec - 1]) + 1
            carry = buf[end:]
            starts = np.concatenate([[0], nl[: 4 * nrec - 1] + 1])
            if not (np.all(arr[starts[0::4]] == ord("@")) and np.all(arr[starts[2::4]] == ord("+"))):
                raise ValueError("malformed FASTQ record")
            for r in range(nrec):
                yield Record(
                    buf[starts[4 * r] + 1 : nl[4 * r]].strip(),
                    buf[starts[4 * r + 1] : nl[4 * r + 1]].strip(),
                )
    if carry.strip():  # trailing record(s) without a final newline
        yield from _read_fastq_lines(io.BytesIO(carry))


def open_reads(path: str | os.PathLike) -> Iterator[Record]:
    """Dispatch on extension: .fa/.fasta/.fna[.gz] or .fq/.fastq[.gz]."""
    s = str(path)
    base = s[:-3] if s.endswith(".gz") else s
    if base.endswith((".fa", ".fasta", ".fna")):
        return read_fasta(path)
    if base.endswith((".fq", ".fastq")):
        return read_fastq(path)
    raise ValueError(f"unrecognized reads format: {path}")


@dataclasses.dataclass
class Batch:
    """One device-ready batch: 'A'-padded bytes + true lengths."""

    reads: np.ndarray    # u8[B, L]
    lengths: np.ndarray  # i32[B]
    count: int           # number of real rows


class BatchStream:
    """Assemble records into fixed-shape padded batches.

    Reads longer than ``max_len`` (rounded up to ``block``) raise.  The
    final partial batch is padded with empty rows.
    """

    def __init__(self, records: Iterable[Record], batch_size: int, max_len: int, *, block: int = 32):
        self.batch_size = batch_size
        self.max_len = -(-max_len // block) * block
        self._records = records

    def __iter__(self) -> Iterator[Batch]:
        B, L = self.batch_size, self.max_len
        seqs: list[bytes] = []

        def assemble() -> Batch:
            # one join and one memcpy/memset pass per batch (native.fill_rows)
            n = len(seqs)
            lens = np.fromiter((len(s) for s in seqs), np.int64, n)
            buf = np.frombuffer(b"".join(seqs), np.uint8)
            starts = np.zeros(n, np.int64)
            np.cumsum(lens[:-1], out=starts[1:])
            reads = np.empty((B, L), np.uint8)
            _native.fill_rows(buf, starts, lens, reads)
            lengths = np.zeros(B, np.int32)
            lengths[:n] = lens
            return Batch(reads, lengths, n)

        for rec in self._records:
            # checked per record, so the error fires before further records
            # are consumed from the caller's iterator
            if len(rec.seq) > L:
                raise ValueError(f"read of length {len(rec.seq)} exceeds max_len {L}")
            seqs.append(rec.seq)
            if len(seqs) == B:
                yield assemble()
                seqs = []
        if seqs:
            yield assemble()


def pack_words_batch(chunk: list[tuple[bytes, int, np.ndarray]], batch_size: int) -> np.ndarray:
    """Pack ``(name, length, u64-words)`` entries into one fixed-shape
    batch: u32[batch_size, 2 * bucket] (little-endian u32 pairs).

    The word width buckets to the next power of two; short records zero-pad
    (tail words read as 'A' runs that the caller's per-record ``length``
    drops).
    """
    wmax = max((e[2].size for e in chunk), default=1)
    bucket = 1 << max(wmax - 1, 0).bit_length()
    mat = np.zeros((batch_size, bucket), dtype="<u8")
    for i, (_, _, words) in enumerate(chunk):
        mat[i, : words.size] = words
    return spec.u64_to_u32_pairs(mat).reshape(batch_size, 2 * bucket)
