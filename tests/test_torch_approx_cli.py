"""The port's ``approx`` command against the reference CLI's on the CPU:
the same stdout bytes, stderr and exit code for both codecs and every flag
(``--both``, ``--max-errors``, ``--all``, ``--cigar``, ``--batch`` 1, 7 and
4096), and the error exits (``--all`` without ``--max-errors``, with
``--cigar``, on a base-5 file, and a query outside the alphabet).  The
``.nup`` files hold ragged seeded reads, a primer planted with up to two
edits on either strand in some, and empty and one-nt records."""

import contextlib
import io

import numpy as np
import pytest

from cute_nucleotides_tpu import cli as ref_cli
from cute_nucleotides_tpu_torch import cli
from cute_nucleotides_tpu_torch.ops import native

PRIMER = b"GTTCAGAGTTCTACAG"
PATTERN = {"2bit": "GTTCAGAGTNCTACAG", "base5": "GTTCAGAG?TCTNCAG"}
FORMS = (
    (),
    ("--both",),
    ("--max-errors", "2"),
    ("--both", "--max-errors", "1"),
    ("--max-errors", "0"),
    ("--both", "--cigar", "--batch", "7"),
    ("--cigar", "--batch", "1"),
    ("--both", "--batch", "4096"),
    ("--all", "--max-errors", "2"),
    ("--all", "--both", "--max-errors", "1", "--batch", "4096"),
    ("--all",),
    ("--all", "--max-errors", "1", "--cigar"),
)


def _revcomp(s: bytes) -> bytes:
    return s[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))


@pytest.fixture(scope="module")
def nups(tmp_path_factory):
    """One .nup per codec over the same 30 records (2-bit reads over ACGT,
    base-5 reads with N)."""
    rng = np.random.default_rng(2024)
    d = tmp_path_factory.mktemp("approx")
    out = {}
    for codec, alphabet, encode in (("2bit", b"ACGT", native.n_to_bits), ("base5", b"ACGTN", native.n_to_bits2)):
        names, seqs = [], []
        for i in range(30):
            n = (0, 1, 15)[i] if i < 3 else int(rng.integers(16, 240))
            s = bytearray(rng.choice(np.frombuffer(alphabet, np.uint8), n).tobytes())
            if i % 3 == 0 and n > 40:
                p = bytearray(PRIMER if i % 2 else _revcomp(PRIMER))
                for _ in range(int(rng.integers(0, 3))):
                    p[int(rng.integers(0, len(p)))] = int(rng.choice(np.frombuffer(b"ACGT", np.uint8)))
                at = int(rng.integers(0, n - len(p)))
                s[at : at + len(p)] = p
            names.append(b"read%d" % i)
            seqs.append(bytes(s))
        path = str(d / f"reads_{codec}.nup")
        cli.write_nup(path, names, [encode(s) for s in seqs], [len(s) for s in seqs], codec)
        out[codec] = path
    return out


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("form", FORMS, ids=lambda f: " ".join(f) or "default")
@pytest.mark.parametrize("codec", ("2bit", "base5"))
def test_approx_equals_reference_cli(nups, codec, form):
    argv = ["approx", nups[codec], PATTERN[codec], *form]
    got, want = _run(cli.main, argv), _run(ref_cli.main, argv)
    assert got == want
    if "--all" in form and ("--max-errors" not in form or "--cigar" in form or codec == "base5"):
        assert got[0] == 1 and got[1] == "" and got[2].startswith("error: --all")


@pytest.mark.parametrize("codec, pattern", (("2bit", "GATXACA"), ("2bit", "GA?TACA"), ("base5", "GATXACA"),
                                            ("base5", "")))
def test_approx_bad_query_exits_as_the_reference(nups, codec, pattern):
    argv = ["approx", nups[codec], pattern, "--both"]
    got = _run(cli.main, argv)
    assert got == _run(ref_cli.main, argv)
    assert got[0] == 1 and got[1] == "" and got[2].startswith("error: ")


def test_approx_missing_file_is_one_error_line(tmp_path):
    rc, out, err = _run(cli.main, ["approx", str(tmp_path / "none.nup"), "ACGT"])
    assert rc == 1 and out == "" and err.startswith("error: ") and len(err.splitlines()) == 1
