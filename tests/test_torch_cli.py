"""The port's CLI against the reference CLI: byte-identical .nup and FASTA."""

import json

import numpy as np
import pytest

from cute_nucleotides_tpu import cli as ref_cli
from cute_nucleotides_tpu_torch import api, cli

ALPHABET = np.frombuffer(b"ACGTUacgtu", np.uint8)


def _records(n=23, seed=12):
    rng = np.random.default_rng(seed)
    lengths = [0, 1, 15, 16, 17, 31, 32, 33] + rng.integers(1, 400, n - 8).tolist()
    return [(b"rec%d desc" % i, rng.choice(ALPHABET, size=L).tobytes()) for i, L in enumerate(lengths)]


@pytest.fixture(params=["fa", "fq"])
def reads(request, tmp_path):
    path = tmp_path / f"reads.{request.param}"
    with open(path, "wb") as f:
        for name, seq in _records():
            if request.param == "fa":
                f.write(b">%s\n%s\n" % (name, seq))
            else:
                f.write(b"@%s\n%s\n+\n%s\n" % (name, seq, b"I" * len(seq)))
    return path


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("batch", [0, 5])
@pytest.mark.parametrize("validate", [False, True])
def test_encode_nup_identical_to_reference(reads, tmp_path, batch, validate):
    flags = ["--batch", str(batch)] + (["--validate"] if validate else [])
    assert cli.main(["encode", str(reads), str(tmp_path / "port.nup"), "--tier", "torch", *flags]) == 0
    assert ref_cli.main(["encode", str(reads), str(tmp_path / "ref.nup"), "--tier", "xla", *flags]) == 0
    assert _read(tmp_path / "port.nup") == _read(tmp_path / "ref.nup")


@pytest.mark.parametrize("batch", [0, 5])
def test_decode_fasta_identical_to_reference(reads, tmp_path, batch):
    nup = tmp_path / "in.nup"
    assert ref_cli.main(["encode", str(reads), str(nup), "--tier", "oracle"]) == 0
    flags = ["--batch", str(batch)]
    assert cli.main(["decode", str(nup), str(tmp_path / "port.fa"), "--tier", "torch", *flags]) == 0
    assert ref_cli.main(["decode", str(nup), str(tmp_path / "ref.fa"), "--tier", "xla", *flags]) == 0
    assert _read(tmp_path / "port.fa") == _read(tmp_path / "ref.fa")
    assert not (tmp_path / "port.fa.tmp").exists()


def test_parity_passes(capsys):
    assert cli.main(["parity", "--trials", "6", "--max-len", "300", "--tiers", "oracle,torch,auto"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "parity": "PASS", "trials": 6, "failures": 0,
    }


@pytest.mark.parametrize("batch", [0, 5])
def test_validate_names_the_bad_record(tmp_path, capsys, batch):
    fa = tmp_path / "bad.fa"
    fa.write_bytes(b">ok\nACGT\n>bad one\nACGNT\n")
    out = tmp_path / "bad.nup"
    rc = cli.main(["encode", str(fa), str(out), "--tier", "torch", "--validate", "--batch", str(batch)])
    assert rc == 1
    assert "at 3 in bad one" in capsys.readouterr().err
    assert not out.exists()


def test_refusals(tmp_path, capsys):
    fa = tmp_path / "r.fa"
    fa.write_bytes(b">r\nACGTN\n")
    assert cli.main(["encode", str(fa), str(tmp_path / "o.nup"), "--tier", "oracle", "--batch", "4"]) == 2
    b5 = tmp_path / "b5.nup"
    assert ref_cli.main(["encode", str(fa), str(b5), "--codec", "base5", "--tier", "oracle"]) == 0
    assert cli.main(["decode", str(b5), str(tmp_path / "o.fa"), "--tier", "oracle", "--batch", "4"]) == 2
    assert "no batch device path" in capsys.readouterr().err
    assert not (tmp_path / "o.fa").exists()
    with pytest.raises(SystemExit):
        cli.main(["encode", str(fa), str(tmp_path / "o.nup"), "--codec", "base7"])
    with pytest.raises(SystemExit):
        cli.main(["encode", str(fa), str(tmp_path / "o.nup"), "--tier", "pallas"])


def test_cli_tiers_mirror_api():
    assert cli.TIERS is api.TIERS == ("oracle", "torch", "cuda", "auto")
