"""The port's ``stats`` against the reference CLI's: the same stdout, stderr
and exit code from ``cute_nucleotides_tpu.cli.main`` and the port's
``cli.main`` on the same FASTA and ``.nup`` files (k from 2 to 32,
canonical or not, records shorter than k, a base-5 container)."""

import numpy as np
import pytest

from cute_nucleotides_tpu import cli as ref_cli
from cute_nucleotides_tpu_torch import cli

#: records across the word seams, the empty record and records shorter
#: than every k; mixed case and U; one poly-A record for ties and long runs
LENGTHS = (0, 1, 5, 20, 31, 32, 33, 150, 700, 3000)


def _fasta(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGTUacgtu", np.uint8)
    out = [b">r%d\n%s\n" % (i, rng.choice(alpha, n).tobytes()) for i, n in enumerate(LENGTHS)]
    out.append(b">polyA\n" + b"A" * 400 + b"\n")
    return b"".join(out)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("stats")
    fa = d / "reads.fa"
    fa.write_bytes(_fasta(3))
    paths = {"fasta": str(fa)}
    for codec, name in (("2bit", "nup"), ("base5", "b5nup")):
        paths[name] = str(d / f"reads_{codec}.nup")
        assert ref_cli.main(["encode", str(fa), paths[name], "--codec", codec, "--tier", "oracle"]) == 0
    short = d / "short.fa"
    short.write_bytes(b">a\nACGTACGTAC\n>b\nGGG\n")
    paths["short"] = str(short)
    return paths


def _both_clis(capsys, argv):
    capsys.readouterr()
    rc = cli.main(argv)
    got = capsys.readouterr()
    ref_rc = ref_cli.main(argv)
    want = capsys.readouterr()
    return (rc, got.out, got.err), (ref_rc, want.out, want.err)


CASES = [("-k", "2"), ("-k", "8"), ("-k", "8", "--canonical", "--top", "10"), ("-k", "10"),
         ("-k", "10", "--canonical"), ("-k", "21"), ("-k", "21", "--canonical", "--top", "10"), ("-k", "32")]


@pytest.mark.parametrize("source", ("fasta", "nup"))
@pytest.mark.parametrize("case", CASES, ids=[" ".join(c) for c in CASES])
def test_stats_identical_to_reference(inputs, capsys, source, case):
    got, want = _both_clis(capsys, ["stats", inputs[source], *case])
    assert got == want
    if case[1] == "32":
        assert got[0] == 1 and got[2] == "error: k must be in [1, 31]\n"
    else:
        assert got[0] == 0 and '"top_kmers"' in got[1]


def test_stats_refuses_a_base5_container(inputs, capsys):
    got, want = _both_clis(capsys, ["stats", inputs["b5nup"], "-k", "8"])
    assert got == want == (1, "", "stats requires a 2-bit stream\n")


@pytest.mark.parametrize("k", ("8", "12", "31"))
def test_stats_records_shorter_than_k(inputs, capsys, k):
    """k past every record (31), past one of two (8, 12): the short ones
    count towards GC and composition only."""
    got, want = _both_clis(capsys, ["stats", inputs["short"], "-k", k])
    assert got == want and got[0] == 0


def test_stats_tiers_agree(inputs, capsys):
    """The torch tier and the oracle tier (host encode) print alike."""
    out = []
    for tier in ("torch", "oracle"):
        assert cli.main(["stats", inputs["fasta"], "-k", "6", "--tier", tier]) == 0
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
