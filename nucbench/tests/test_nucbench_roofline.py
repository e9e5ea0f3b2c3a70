"""The frozen yardstick equals the formulas it copies (the port's
``utils/profiling.py`` as it stood when the benchmark was defined)."""

import pytest

from cute_nucleotides_tpu_torch.utils import profiling
from nucbench import roofline


def test_peaks_are_the_cards():
    assert roofline.HBM_BYTES_PER_S == profiling.HBM_BYTES_PER_S == 3.35e12
    assert roofline.INT_INSTR_PER_S == profiling.INT_INSTR_PER_S == 33.5e12


@pytest.mark.parametrize("nt", [27, 162 * 2097152, 27 * 12345])
def test_codec_bytes(nt):
    assert roofline.encode_b5_bytes(nt) == profiling.encode_b5_roofline(nt).total
    assert roofline.decode_b5_bytes(nt) == profiling.decode_b5_roofline(nt).total
    assert roofline.bound_s(roofline.encode_b5_bytes(nt)) == pytest.approx(
        profiling.encode_b5_roofline(nt).speed_of_light_s())


def test_the_round_trip_of_a_codec_batch():
    nt = 2097152 * 162
    assert roofline.encode_b5_bytes(nt) + roofline.decode_b5_bytes(nt) == 880_803_840
    assert 1e3 * roofline.bound_s(880_803_840) == pytest.approx(0.2629, abs=1e-4)


@pytest.mark.parametrize("mode", ["global", "semiglobal", "prefix", "ends"])
@pytest.mark.parametrize("nb,b5", [(1, False), (2, True), (5, False)])
def test_myers_floor(mode, nb, b5):
    for chars in (1, 150 * 1048576, 248956422):
        assert roofline.myers_ops(chars, nb, b5=b5, mode=mode) == profiling.myers_ops(chars, nb, b5=b5, mode=mode)


def test_the_adapter_scans_floor():
    ops = roofline.myers_ops(150 * 1048576, 2, b5=True, mode="semiglobal")
    assert ops == pytest.approx(4.98e9, rel=2e-3)
    assert 1e3 * roofline.bound_s(0, ops) == pytest.approx(0.149, abs=1e-3)
