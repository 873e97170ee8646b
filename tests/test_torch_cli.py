"""The port's nanomagick CLI against ``grayskull_tpu.cli``, on the CPU.

Each of the 14 commands runs in-process through ``grayskull_tpu_torch.cli.main``
under ``host_arrays_to("cpu")`` (the autouse fixture) and through the JAX
package's ``main`` on the same argv; the output PGMs must be byte-identical
and stdout, stderr and the exit code the same.  Errors are compared as
``tests/test_cli.py:173-177`` checks them.  ``python -m grayskull_tpu_torch.cli``
runs on the card: with no card, a command that computes raises, and
``identify``, which reads only the header, still runs.
"""

import json
import os
import subprocess
import sys

import pytest

from grayskull_tpu import cli as jax_cli
from grayskull_tpu_torch import cli, structlog
from grayskull_tpu_torch import io as gio
from tests.test_torch_cuda import host_arrays_on_cpu  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, "tests", "golden", "testdata")
LENA = os.path.join(TESTDATA, "lena.pgm")
RECEIPT = os.path.join(TESTDATA, "receipt.pgm")
DOCUMENT = os.path.join(TESTDATA, "document.pgm")

# (argv after the command name, without the input and output paths; input)
COMMANDS = [
    (["resize", "100", "40"], LENA),
    (["resize", "300", "170"], LENA),
    (["crop", "20", "10", "40", "30"], LENA),
    (["blur", "2"], LENA),
    (["threshold", "otsu"], LENA),
    (["threshold", "100"], LENA),
    (["adaptive", "15", "5"], LENA),
    (["adaptive", "15", "5"], RECEIPT),
    (["sobel"], LENA),
    (["morph", "erode", "2"], LENA),
    (["morph", "dilate", "2"], RECEIPT),
    (["blobs", "50"], LENA),
    (["scan"], DOCUMENT),
    (["keypoints", "50", "20"], LENA),
    (["orb", "TEMPLATE"], LENA),
    (["faces", "2"], LENA),
]


def _run(main, argv, capsys):
    rc = main(["nanomagick"] + argv)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.fixture(scope="module")
def template(tmp_path_factory):
    """A 60x70 crop of lena, for ``orb``."""
    path = tmp_path_factory.mktemp("tmpl") / "tmpl.pgm"
    assert gio.write_pgm(gio.read_pgm(LENA)[30:90, 20:90].copy(), str(path)) == 0
    return str(path)


@pytest.mark.parametrize("args,src", COMMANDS,
                         ids=["-".join(a) + "-" + os.path.basename(s)[:-4] for a, s in COMMANDS])
def test_command_output_is_byte_identical(args, src, template, tmp_path, capsys):
    args = [template if a == "TEMPLATE" else a for a in args]
    ours, theirs = tmp_path / "ours.pgm", tmp_path / "theirs.pgm"
    got = _run(cli.main, args + [src, str(ours)], capsys)
    want = _run(jax_cli.main, args + [src, str(theirs)], capsys)
    assert got == want and got[0] == 0, args
    assert ours.read_bytes() == theirs.read_bytes(), args


@pytest.mark.parametrize("term", ["xterm-256color", "dumb"])
def test_view_and_identify_stdout(term, monkeypatch, capsys):
    """Both renderer branches under a pinned TERM; under capture both packages
    fall back to the same 80-column terminal."""
    monkeypatch.setenv("TERM", term)
    monkeypatch.delenv("COLUMNS", raising=False)
    for argv in (["view", LENA], ["identify", LENA], ["identify", RECEIPT]):
        got = _run(cli.main, argv, capsys)
        assert got == _run(jax_cli.main, argv, capsys), argv
        assert got[0] == 0 and len(got[1]) > 40


@pytest.mark.parametrize("argv", [
    [], ["--help"], ["nonsense"], ["blur", "1"], ["blur", "1", "/does/not/exist.pgm", "x.pgm"],
    ["blur", "0", LENA, "OUT"], ["threshold", "0", LENA, "OUT"],
    ["adaptive", "0", "5", LENA, "OUT"], ["adaptive", "3", "-1", LENA, "OUT"],
    ["morph", "open", "1", LENA, "OUT"],
    ["morph", "erode", "0", LENA, "OUT"], ["crop", "100", "100", "40", "40", LENA, "OUT"],
    ["resize", "0", "10", LENA, "OUT"], ["blobs", "0", LENA, "OUT"],
    ["keypoints", "0", "5", LENA, "OUT"], ["faces", "0", LENA, "OUT"],
    ["orb", "/does/not/exist.pgm", LENA, "OUT"], ["identify", LENA, "extra"],
])
def test_errors_and_exit_codes(argv, tmp_path, capsys):
    argv = [str(tmp_path / "out.pgm") if a == "OUT" else a for a in argv]
    got = _run(cli.main, argv, capsys)
    assert got == _run(jax_cli.main, argv, capsys), argv
    assert got[0] == 1 and not (tmp_path / "out.pgm").exists()


def test_unwritable_output(tmp_path, capsys):
    argv = ["sobel", LENA, str(tmp_path / "no-such-dir" / "out.pgm")]
    got = _run(cli.main, argv, capsys)
    assert got == _run(jax_cli.main, argv, capsys) and got[0] == 1


def test_stdout_output(capsysbinary):
    """``-`` writes the PGM to stdout."""
    assert cli.main(["nanomagick", "crop", "0", "0", "5", "4", LENA, "-"]) == 0
    out = capsysbinary.readouterr().out
    assert out == gio.encode_pgm(gio.read_pgm(LENA)[:4, :5])


def test_structlog_event(tmp_path, capsys):
    """With a sink, each command logs one ``cli.command`` line."""
    log = tmp_path / "log.jsonl"
    structlog.configure(str(log))
    try:
        assert cli.main(["nanomagick", "morph", "dilate", "1", LENA,
                         str(tmp_path / "out.pgm")]) == 0
    finally:
        structlog.configure(None)
    rec = json.loads(log.read_text().strip())
    assert rec["event"] == "cli.command" and rec["command"] == "morph"
    assert rec["shape"] == [128, 128] and rec["elapsed_ms"] >= 0
    capsys.readouterr()


def test_module_entry_runs_on_the_card_only(tmp_path):
    """``python -m grayskull_tpu_torch.cli`` sends images to the CUDA device;
    there is no flag or variable that falls back to the CPU."""
    import torch

    env = dict(os.environ, PYTHONPATH=REPO, TERM="dumb")
    cmd = [sys.executable, "-m", "grayskull_tpu_torch.cli"]
    ident = subprocess.run(cmd + ["identify", LENA], env=env, capture_output=True, text=True,
                           timeout=300)
    assert ident.returncode == 0 and ident.stdout == "Portable Graymap, 128x128 (16384) pixels\n"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run on it")
    out = tmp_path / "out.pgm"
    blur = subprocess.run(cmd + ["blur", "1", LENA, str(out)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert blur.returncode != 0 and "CUDA device" in blur.stderr and not out.exists()
