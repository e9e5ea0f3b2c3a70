"""The yardstick's peaks and work models, frozen inside the benchmark.

A copy of the arithmetic of ``cute_nucleotides_tpu_torch/utils/profiling.py``
as it stood when the benchmark was defined, so that a later change to the
program cannot move the bounds its cells are held to.  Imports nothing.

* Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM
  at 3.35 TB/s; integer instructions at 33.5 T lanes/s (four schedulers an
  SM, one warp instruction a clock each: the rate behind the 67 TFLOP/s FP32
  figure, an FMA counted as two).
* Base-5 codec (kernels #5 and #6): each input byte read once, each output
  byte written once; 8 packed bytes per 27 nt.
* Myers scan (kernel #19): the least integer instructions a text nt needs
  (11 per 32-row block, one for the char, and the mode's score work), plus
  the text decode; loop control and loads are left out, so it is a floor.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT_INSTR_PER_S = 67e12 / 2

NT_PER_WORD_B5 = 27
B5_WORD_BYTES = 8

MYERS_OPS_BLOCK, MYERS_OPS_CHAR = 11, 1
MYERS_OPS_MODE = {"global": 0, "semiglobal": 6, "prefix": 6, "ends": 5}


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """The least seconds the card could take: the larger of the bytes at the
    HBM rate and the integer instructions at the issue rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_INSTR_PER_S)


def encode_b5_bytes(nt: int) -> int:
    """Base-5 encode of ``nt`` bytes (a multiple of 27): read ``nt``, write
    8 bytes a 27-nt word."""
    return nt + B5_WORD_BYTES * (nt // NT_PER_WORD_B5)


def decode_b5_bytes(nt: int) -> int:
    """Base-5 decode to ``nt`` bytes: read 8 bytes a word, write ``nt``."""
    return B5_WORD_BYTES * (nt // NT_PER_WORD_B5) + nt


def myers_ops(chars: int, nb: int, *, b5: bool = False, mode: str = "global") -> int:
    """Kernel #19's floor in integer instructions for ``chars`` text nt
    against queries of ``nb`` 32-row blocks in ``mode``; a 2-bit code costs
    one mask to decode, a base-5 triplet 8 for its 3 digits."""
    per_char = MYERS_OPS_BLOCK * nb + MYERS_OPS_CHAR + MYERS_OPS_MODE[mode]
    return chars * per_char + (chars * 8 // 3 if b5 else chars)
