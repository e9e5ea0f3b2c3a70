"""Roofline of one op on the card: the least time an H100 could take for it.

The port's copy of the part of ``cute_nucleotides_tpu/utils/profiling.py``
that the bench needs: :class:`Roofline` and the four codec byte models.  The
reference's bound was the larger of HBM time, MXU time and a measured VPU
rate, all TPU resources; here it is the largest of

* the bytes the op must move (each input read once, each output written
  once) at the HBM rate,
* the integer instructions its data needs, where a row counts them, at the
  issue rate, and
* the int8 tensor-core operations of a library matrix product (the
  all-pairs distances), where a row counts them, at the tensor-core rate.

Both peaks are the card's (NVIDIA's H100 SXM data sheet, at its 700 W power
limit).  ``chip_smoke.py`` takes its bounds from :func:`bound` here, so the
smoke's and the bench's cannot drift apart.  Imports nothing.
"""

from __future__ import annotations

import dataclasses

#: HBM bytes per second
HBM_BYTES_PER_S = 3.35e12
#: integer instructions (one per lane) per second at the issue limit: an SM
#: issues one warp instruction per clock on each of its four schedulers, 128
#: lanes, the rate behind the 67 TFLOP/s FP32 figure (an FMA counted as two
#: operations).  Integer work spreads over the INT32 pipe (64 lanes) and the
#: FMA pipe (multiplies, and the shifts, adds and moves ptxas puts there as
#: IMAD), so no mix of it issues faster.
INT_INSTR_PER_S = 67e12 / 2
#: dense int8 tensor-core operations per second (a multiply-add is two)
INT8_TENSOR_OPS_PER_S = 1979e12


#: the Myers scan's least instructions a text nt (kernel #19): 11 a 32-row
#: block (one to fetch Eq, two for the adder and its carry, Xh, Ph, Mh, the
#: two funnel shifts of Ph and Mh, Xv, the new PV and MV), and a char's own:
#: its Eq address, and by mode the score (global mode reads it from the
#: last column, so none a char; else the score bit's two tests and add)
#: with the best (a compare and two selects) or the ends mask (a compare
#: and a store)
MYERS_OPS_BLOCK, MYERS_OPS_CHAR = 11, 1
MYERS_OPS_MODE = {"global": 0, "semiglobal": 6, "prefix": 6, "ends": 5}


def bound(nbytes: float, ops: float = 0.0, tensor_ops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) the card could take, and what sets it ("bytes"
    or "operations"): the largest of the bytes at the HBM rate, the integer
    instructions at the issue rate and the int8 tensor operations at the
    tensor-core rate."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = max(1e3 * ops / INT_INSTR_PER_S, 1e3 * tensor_ops / INT8_TENSOR_OPS_PER_S)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Roofline:
    """Bytes moved (and, where counted, integer instructions) of one op at
    a given input size."""

    read_bytes: int
    write_bytes: int
    #: integer instructions the op's data needs (0: not counted)
    int_ops: int = 0
    #: int8 tensor-core operations of its matrix products (0: none)
    tensor_ops: int = 0

    @property
    def total(self) -> int:
        return self.read_bytes + self.write_bytes

    def speed_of_light_s(self) -> float:
        """Least seconds: the memory and the issue bounds must both be met."""
        return bound(self.total, self.int_ops, self.tensor_ops)[0] / 1e3

    def bound_kind(self) -> str:
        """Which resource sets the ceiling: "bytes" or "operations"."""
        return bound(self.total, self.int_ops, self.tensor_ops)[1]

    def efficiency(self, measured_s: float) -> float:
        """Fraction of speed-of-light achieved (1.0 == at the bound)."""
        return self.speed_of_light_s() / max(measured_s, 1e-12)


def encode_2bit_roofline(nt: int) -> Roofline:
    """2-bit encode reads nt bytes, writes nt/4 packed bytes."""
    return Roofline(nt, nt // 4)


def decode_2bit_roofline(nt: int) -> Roofline:
    return Roofline(nt // 4, nt)


def encode_b5_roofline(nt: int) -> Roofline:
    """base-5: 8 packed bytes per 27 nt."""
    return Roofline(nt, 8 * (nt // 27))


def decode_b5_roofline(nt: int) -> Roofline:
    return Roofline(8 * (nt // 27), nt)


def myers_ops(chars: int, nb: int, *, b5: bool = False, mode: str = "global") -> int:
    """The integer instructions kernel #19 needs at least for ``chars`` text
    nt against queries of ``nb`` 32-row blocks: the block and char counts
    above, plus the decode (a 2-bit code is one mask; a base-5 triplet is
    an extract, two multiply-shifts and two multiply-subtracts, 8 for its 3
    digits).  Loop control and the text loads (a few a 16-nt word) are left
    out, so this is a floor, not the kernel's count."""
    per_char = MYERS_OPS_BLOCK * nb + MYERS_OPS_CHAR + MYERS_OPS_MODE[mode]
    return chars * per_char + (chars * 8 // 3 if b5 else chars)
