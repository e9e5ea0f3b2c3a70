"""The port's ``region``, ``translate`` and ``dedup`` against the reference
CLI's, for both codecs: the same stdout, stderr, exit code and output file
bytes from ``cute_nucleotides_tpu.cli.main`` and the port's ``cli.main`` on
the same ``.nup`` files, with missing records, overruns, duplicate names,
bad region and frame specs, and ``region --packed`` without ``-o``; and the
port's fix of ``region --packed`` (a failed write leaves an existing output
intact)."""

import json
import os

import numpy as np
import pytest

from cute_nucleotides_tpu import cli as ref_cli
from cute_nucleotides_tpu_torch import cli

CODECS = ("2bit", "base5")


def _seq(seed: int, n: int, alphabet: bytes) -> bytes:
    return np.random.default_rng(seed).choice(np.frombuffer(alphabet, np.uint8), n).tobytes()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Per codec: a .nup of records r0 (empty), r1 (5 nt), r2 (1000 nt, mixed
    case), two records named dup, and a read set with planted duplicates."""
    d = tmp_path_factory.mktemp("region")
    out = {}
    for codec in CODECS:
        alpha = b"ACGTacgtu" if codec == "2bit" else b"ACGTNacgtun"
        recs = [(b"r0", b""), (b"r1", _seq(1, 5, alpha)), (b"r2", _seq(2, 1000, alpha)),
                (b"dup", _seq(3, 40, alpha)), (b"dup", _seq(4, 50, alpha))]
        pool = [_seq(10 + i, 20 + 13 * i, alpha) for i in range(6)]
        rng = np.random.default_rng(5)
        reads = [(b"q%d" % i, pool[int(rng.integers(0, 6))]) for i in range(40)]
        reads[7] = (b"q7", reads[3][1].lower())  # case folds at encode: a duplicate
        reads[9] = (b"q9", reads[3][1][:-1])  # a prefix: not one
        for name, rs in (("recs", recs), ("reads", reads)):
            fa, nup = d / f"{name}_{codec}.fa", d / f"{name}_{codec}.nup"
            fa.write_bytes(b"".join(b">%s\n%s\n" % r for r in rs))
            assert ref_cli.main(["encode", str(fa), str(nup), "--codec", codec, "--tier", "oracle"]) == 0
            out[name, codec] = str(nup)
        long = d / f"long_{codec}.fa"
        long.write_bytes(b">big\n" + _seq(6, 256 * (32 if codec == "2bit" else 27) + 1, alpha) + b"\n")
        out["long", codec] = str(d / f"long_{codec}.nup")
        assert ref_cli.main(["encode", str(long), out["long", codec], "--codec", codec, "--tier", "oracle"]) == 0
        ref_cli.write_nup(str(d / f"empty_{codec}.nup"), [], [], [], codec)
        out["empty", codec] = str(d / f"empty_{codec}.nup")
    out["dir"] = d
    return out


def _both(capsysbinary, argv_port, argv_ref):
    capsysbinary.readouterr()
    rc = cli.main(argv_port)
    got = capsysbinary.readouterr()
    ref_rc = ref_cli.main(argv_ref)
    want = capsysbinary.readouterr()
    return (rc, got.out, got.err), (ref_rc, want.out, want.err)


def _run_both(files, capsysbinary, tmp_path, argv, with_output, ref_extra=()):
    """Run argv through both CLIs (the reference's with ``ref_extra`` added);
    with_output ("-o" for region, "pos" for a positional path) adds an
    output path of each one's own, and returns both files' bytes (None
    where no file was left)."""
    outs = [tmp_path / "port.out", tmp_path / "ref.out"]
    argvs = []
    for o in outs:
        extra = [] if with_output is None else ["-o", str(o)] if with_output == "-o" else [str(o)]
        argvs.append([*argv, *extra])
    argvs[1] += ref_extra
    got, want = _both(capsysbinary, *argvs)
    left = [o.read_bytes() if o.exists() else None for o in outs]
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    return got, want, left


REGION = {
    "windows": ["r1:0-5", "r2:5-105", "r2:95-100", "r2:0-1000", "r1:2-2"],
    "seams": ["r2:31-97", "r2:26-82", "r2:64-128", "r2:54-55"],
    "empty record": ["r0:0-0"],
    "duplicate name": ["dup:0-3"],
    "missing record": ["r1:0-2", "nope:0-5"],
    "overrun": ["r2:10-1001"],
    "bad spec": ["r2"],
    "bad bounds": ["r2:5-3"],
}


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("case", REGION)
@pytest.mark.parametrize("mode", ("stdout", "file", "packed"))
def test_region_identical_to_reference(files, capsysbinary, tmp_path, codec, case, mode):
    """The reference runs with ``--tier oracle``: its device tiers fail on a
    window whose word count is not a power of two (see the next test)."""
    argv = ["region", files["recs", codec], *REGION[case]]
    if mode == "packed":
        argv.append("--packed")
    got, want, left = _run_both(files, capsysbinary, tmp_path, argv, None if mode == "stdout" else "-o",
                                ref_extra=["--tier", "oracle"])
    assert got == want
    assert left[0] == left[1]
    ok = case in ("windows", "seams", "empty record", "duplicate name")
    assert got[0] == (0 if ok else 1)
    if mode == "stdout" and ok and case != "duplicate name":
        assert got[1].startswith(b">") and got[2] == b""
    if mode == "packed" and ok:
        assert left[0][:4] == b"NUPK"


@pytest.mark.parametrize("codec", CODECS)
def test_region_decodes_every_window_size(files, capsysbinary, tmp_path, codec):
    """A fault of the reference, not carried over: its ``region`` hands the
    window's words to ``api.bits_to_n`` as a (k, 1) array, and the device
    tiers' power-of-two padding then fails, so the default tier exits 1 on
    a 66-nt window (3 words).  The port prints what the reference's oracle
    tier prints, on every tier."""
    argv = ["region", files["recs", codec], "r2:31-97"]
    got, want, _ = _run_both(files, capsysbinary, tmp_path, argv, None)
    assert want[0] == 1 and want[2].startswith(b"error: all the input arrays must have same number of dimensions")
    for tier in ("oracle", "torch", "auto"):
        got, want = _both(capsysbinary, [*argv, "--tier", tier], [*argv, "--tier", "oracle"])
        assert got == want and got[0] == 0 and got[1].startswith(b">r2:31-97\n")


@pytest.mark.parametrize("codec", CODECS)
def test_region_tiers_and_packed_without_output(files, capsysbinary, tmp_path, codec):
    for extra in (["--tier", "oracle"], ["--packed"]):
        got, want, _ = _run_both(files, capsysbinary, tmp_path, ["region", files["recs", codec], "r2:3-77", *extra],
                                 None)
        assert got == want
    assert got[0] == 1 and got[2] == b"error: --packed needs an output path\n"


def test_region_packed_failed_write_leaves_existing_output(files, capsysbinary, tmp_path, monkeypatch):
    """The reference writes ``--packed`` output straight to its path, so a
    failed write clobbers it; the port writes <output>.tmp and renames it
    on success."""
    out = tmp_path / "win.nup"
    out.write_bytes(b"an existing file")

    def failing_write(path, *args):
        with open(path, "wb") as f:
            f.write(b"NUPK half a header")
        raise OSError("No space left on device")

    monkeypatch.setattr(cli, "write_nup", failing_write)
    rc = cli.main(["region", files["recs", "2bit"], "r2:0-100", "--packed", "-o", str(out)])
    assert rc == 1 and capsysbinary.readouterr().err == b"error: No space left on device\n"
    assert out.read_bytes() == b"an existing file"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["win.nup"]
    monkeypatch.undo()
    assert cli.main(["region", files["recs", "2bit"], "r2:0-100", "--packed", "-o", str(out)]) == 0
    ref_out = tmp_path / "ref.nup"
    assert ref_cli.main(["region", files["recs", "2bit"], "r2:0-100", "--packed", "-o", str(ref_out)]) == 0
    assert out.read_bytes() == ref_out.read_bytes()


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("frames", ("1", "all", "2,-3", "4", "x"))
@pytest.mark.parametrize("to_file", (False, True), ids=("stdout", "file"))
def test_translate_identical_to_reference(files, capsysbinary, tmp_path, codec, frames, to_file):
    argv = ["translate", files["recs", codec], "--frames", frames]
    got, want, left = _run_both(files, capsysbinary, tmp_path, argv, "pos" if to_file else None)
    assert got == want and left[0] == left[1]
    if frames in ("4", "x"):
        assert got[0] == 2 and got[2].startswith(b"error: ")
        assert left[0] is None
    else:
        assert got[0] == 0
        text = left[0] if to_file else got[1]
        assert text.count(b">") == 4 * (6 if frames == "all" else len(frames.split(",")))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("which", ("reads", "recs", "long", "empty"))
def test_dedup_identical_to_reference(files, capsysbinary, tmp_path, codec, which):
    got, want, left = _run_both(files, capsysbinary, tmp_path, ["dedup", files[which, codec]], "pos")
    assert got == want and left[0] == left[1]
    if which == "long":
        assert got[0] == 1 and b"read-batch-scoped" in got[2]
    else:
        assert got[0] == 0
        summary = json.loads(got[1])
        if which == "reads":
            assert summary["removed"] >= 30 and summary["kept"] + summary["removed"] == 40


def test_missing_input_is_one_error_line(capsysbinary, tmp_path):
    for argv in (["region", str(tmp_path / "no.nup"), "a:0-1"], ["translate", str(tmp_path / "no.nup")],
                 ["dedup", str(tmp_path / "no.nup"), str(tmp_path / "o.nup")]):
        got, want = _both(capsysbinary, argv, argv)
        assert got == want and got[0] == 1 and got[2].startswith(b"error: ")
    assert not os.path.exists(tmp_path / "o.nup")
