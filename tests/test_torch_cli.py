"""The port's CLI (sla_tpu_torch.cli.main, device="cpu") against sla_tpu's
(sla_tpu.cli.main): every mode and error path of the same command line
writes the same files, returns the same exit code and prints the same
stdout and stderr. Each side runs in its own directory on its own copy of
the inputs, with relative paths, so the printed text can match exactly."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import sla_tpu
import sla_tpu.cli
from sla_tpu import wavio

import sla_tpu_torch.cli

from .test_encode_decode import gen_wave

REPO = pathlib.Path(__file__).resolve().parent.parent


def _inputs(root: pathlib.Path) -> None:
    """The inputs every case reads: a stereo and a mono WAV, the stereo one
    encoded at preset 1, a copy of that stream with a corrupt block, and a
    directory of three WAVs for corpus mode."""
    root.mkdir(parents=True, exist_ok=True)
    stereo = gen_wave("chirp", 20000, 2, 16, 0, seed=9)
    mono = gen_wave("sine", 9000, 1, 24, 0, seed=3)
    wavio.write_wav(str(root / "in.wav"), wavio.WavFile(2, 44100, 16, stereo))
    wavio.write_wav(str(root / "mono.wav"), wavio.WavFile(1, 48000, 24, mono))
    assert sla_tpu.cli.main(["sla", "-e", "-q", "-m", "1", str(root / "in.wav"),
                             str(root / "in.sla")]) == 0
    blob = bytearray((root / "in.sla").read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    (root / "bad.sla").write_bytes(bytes(blob))
    (root / "wavs").mkdir()
    for i in range(3):
        pcm = gen_wave("sine" if i % 2 else "noise", 4000 + 777 * i, 1 + i % 2, 16, 0, seed=i)
        wavio.write_wav(str(root / "wavs" / f"t{i}.wav"),
                        wavio.WavFile(pcm.shape[0], 44100, 16, pcm))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_inputs")
    _inputs(root)
    return root


def _untimed(text: str) -> str:
    """Text with its wall times (verbose stage and corpus lines) blanked."""
    return re.sub(r"\d+\.\d+(ms|s)\b", "<t>", text)


def _run(main, argv, cwd, capsys, monkeypatch, **kw):
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    rc = main(argv, **kw)
    out, err = capsys.readouterr()
    return rc, _untimed(out), _untimed(err)


def _files(root: pathlib.Path) -> dict[str, bytes]:
    return {
        str(p.relative_to(root)): p.read_bytes()
        for p in sorted(root.rglob("*")) if p.is_file() and "manifest" not in p.name
    }


def _both(argv, inputs, tmp_path, capsys, monkeypatch, seq=()):
    """Runs `seq` then `argv` on both CLIs in two copies of the inputs;
    asserts equal exit codes, stdout, stderr and files; returns the port's
    result and directory."""
    results = []
    for name, main, kw in (("ref", sla_tpu.cli.main, {}),
                           ("port", sla_tpu_torch.cli.main, {"device": "cpu"})):
        work = tmp_path / name
        shutil.copytree(inputs, work)
        got = [_run(main, a, work, capsys, monkeypatch, **kw) for a in (*seq, argv)]
        results.append((got, _files(work)))
    (ref, ref_files), (port, port_files) = results
    assert port == ref
    assert port_files.keys() == ref_files.keys()
    for k in ref_files:
        assert port_files[k] == ref_files[k], k
    return port[-1], tmp_path / "port"


@pytest.mark.parametrize("src", ["in.wav", "mono.wav"])
@pytest.mark.parametrize("preset", [0, 1, 2, 3, 4])
def test_encode_presets(inputs, tmp_path, capsys, monkeypatch, preset, src):
    (rc, _, _), _ = _both(["sla", "-e", "-q", "-m", str(preset), src, "o.sla"],
                          inputs, tmp_path, capsys, monkeypatch)
    assert rc == 0


@pytest.mark.parametrize("argv", [
    ["-d", "-q", "in.sla", "o.wav"],
    ["-d", "in.sla", "o.wav"],  # verbose: the header line on stdout
    ["-d", "-s", "-q", "in.sla", "o.wav"],
    ["-d", "-s", "in.sla", "o.wav"],
    ["-d", "-w", "5000:7000", "-q", "in.sla", "o.wav"],
    ["-d", "-w", "19000:5000", "in.sla", "o.wav"],
    ["-d", "-w", "30000:10", "-q", "in.sla", "o.wav"],
    ["-d", "-r", "-q", "bad.sla", "o.wav"],
    ["-d", "-r", "in.sla", "o.wav"],
    ["-d", "-q", "bad.sla", "o.wav"],
    ["-d", "-q", "-c", "no", "bad.sla", "o.wav"],
    ["-i", "in.sla"],
    ["-i", "bad.sla"],
    ["-i", "-c", "no", "bad.sla"],
], ids=lambda a: " ".join(a))
def test_decode_modes(inputs, tmp_path, capsys, monkeypatch, argv):
    _both(["sla", *argv], inputs, tmp_path, capsys, monkeypatch)


def test_decode_gives_the_pcm(inputs, tmp_path, capsys, monkeypatch):
    (rc, _, _), work = _both(["sla", "-d", "-s", "-q", "in.sla", "o.wav"],
                             inputs, tmp_path, capsys, monkeypatch)
    assert rc == 0
    assert np.array_equal(wavio.read_wav(str(work / "o.wav")).data,
                          wavio.read_wav(str(work / "in.wav")).data)


def test_index_sidecar_emit_and_use(inputs, tmp_path, capsys, monkeypatch):
    (rc, _, _), work = _both(
        ["sla", "-d", "-w", "1000:3000", "-x", "o.idx", "o.sla", "w.wav"],
        inputs, tmp_path, capsys, monkeypatch,
        seq=[["sla", "-e", "-q", "-x", "o.idx", "in.wav", "o.sla"]],
    )
    assert rc == 0 and (work / "o.idx").exists()


def test_index_sidecar_built_at_decode(inputs, tmp_path, capsys, monkeypatch):
    (rc, _, _), work = _both(
        ["sla", "-d", "-w", "0:100", "-x", "n.idx", "-q", "in.sla", "w.wav"],
        inputs, tmp_path, capsys, monkeypatch,
        seq=[["sla", "-d", "-w", "0:100", "-x", "n.idx", "in.sla", "w0.wav"]],
    )
    assert rc == 0 and (work / "n.idx").exists()


@pytest.mark.parametrize("argv", [
    ["-e", "-V", "-q", "in.wav", "o.sla"],
    ["-e", "-O", "1", "-q", "mono.wav", "o.sla"],
    ["-e", "-b", "-q", "-m", "0", "wavs", "out"],
    ["-e", "-b", "-q", "-f", "3", "-m", "1", "wavs", "out"],
    ["-e", "-b", "-V", "-f", "2", "-q", "wavs", "out"],
], ids=lambda a: " ".join(a))
def test_encode_options(inputs, tmp_path, capsys, monkeypatch, argv):
    (rc, _, _), _ = _both(["sla", *argv], inputs, tmp_path, capsys, monkeypatch)
    assert rc == 0


def test_corpus_decode(inputs, tmp_path, capsys, monkeypatch):
    (rc, _, _), work = _both(
        ["sla", "-d", "-b", "-q", "out", "dec"], inputs, tmp_path, capsys, monkeypatch,
        seq=[["sla", "-e", "-b", "-q", "-f", "2", "wavs", "out"]],
    )
    assert rc == 0
    for i in range(3):
        assert np.array_equal(wavio.read_wav(str(work / "dec" / f"t{i}.wav")).data,
                              wavio.read_wav(str(work / "wavs" / f"t{i}.wav")).data)


@pytest.mark.parametrize("argv", [
    [],
    ["-e", "a"],
    ["a", "b"],
    ["-e", "-d", "a", "b"],
    ["-e", "-m", "9", "a", "b"],
    ["-e", "-m", "x", "a", "b"],
    ["-y", "a", "b"],
    ["-e", "-q", "nope.wav", "o"],
    ["-d", "-q", "nope.sla", "o"],
    ["-e", "-O", "3", "in.wav", "o"],
    ["-e", "-b", "-O", "1", "wavs", "o"],
    ["-e", "-b", "-x", "i", "wavs", "o"],
    ["-e", "-b", "-f", "z", "wavs", "o"],
    ["-e", "-b", "-q", "mono", "o"],
    ["-d", "-b", "-w", "0:1", "wavs", "o"],
    ["-d", "-b", "-q", "wavs", "o"],
    ["-d", "-w", "1:2", "-r", "in.sla", "o"],
    ["-d", "-w", "bad", "in.sla", "o"],
    ["-d", "-w", "-5:2", "in.sla", "o"],
    ["-x", "i", "in.sla", "o"],
    ["-i", "-e", "in.sla"],
    ["-i"],
    ["-d", "-s", "-q", "in.wav", "o.wav"],
    ["-h"],
    ["-v"],
], ids=lambda a: " ".join(a) or "no-args")
def test_error_paths_and_help(inputs, tmp_path, capsys, monkeypatch, argv):
    """The error paths of tests/test_cli.py, -h and -v. The help text differs
    in one word: the port's -t takes a profiler trace, not a TPU's."""
    results = []
    for name, main, kw in (("ref", sla_tpu.cli.main, {}),
                           ("port", sla_tpu_torch.cli.main, {"device": "cpu"})):
        work = tmp_path / name
        shutil.copytree(inputs, work)
        (work / "mono").mkdir()
        results.append(_run(main, ["sla", *argv], work, capsys, monkeypatch, **kw))
    ref, port = results
    ref = (ref[0], ref[1].replace("a TPU profiler trace", "a profiler trace"), ref[2])
    assert port == ref


def test_trace_dir_leaves_a_trace(inputs, tmp_path, capsys, monkeypatch):
    work = tmp_path / "port"
    shutil.copytree(inputs, work)
    monkeypatch.chdir(work)
    assert sla_tpu_torch.cli.main(["sla", "-e", "-q", "-t", "tr", "in.wav", "t.sla"],
                                  device="cpu") == 0
    assert sla_tpu_torch.cli.main(["sla", "-e", "-q", "in.wav", "u.sla"], device="cpu") == 0
    assert (work / "t.sla").read_bytes() == (work / "u.sla").read_bytes()
    traces = list((work / "tr").glob("*.json"))
    assert traces and traces[0].stat().st_size > 0


def test_main_needs_a_card_unless_asked_for_the_cpu(inputs, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(inputs)
    for argv in (["-e", "-q", "in.wav", str(tmp_path / "o.sla")],
                 ["-d", "-q", "in.sla", str(tmp_path / "o.wav")],
                 ["-d", "-s", "-q", "in.sla", str(tmp_path / "o.wav")],
                 ["-i", "in.sla"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sla_tpu_torch.cli.main(["sla", *argv])
    assert sla_tpu_torch.cli.main(["sla", "-v"]) == 0


def test_python_m_runs_the_port_cli(inputs, tmp_path):
    """`python -m sla_tpu_torch` is cli.main: -v prints sla_tpu's version
    line, and -e without a card stops with the no-CUDA error."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-m", "sla_tpu_torch", "-v"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout == (f"SLA - Solitary Lossless Audio Compressor Version "
                        f"{sla_tpu.SLA_VERSION_STRING}\n")
    import torch

    if not torch.cuda.is_available():
        r = subprocess.run(
            [sys.executable, "-m", "sla_tpu_torch", "-e", "-q", str(inputs / "in.wav"),
             str(tmp_path / "o.sla")],
            cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
        assert r.returncode != 0 and "no CUDA device" in r.stderr
        assert not (tmp_path / "o.sla").exists()
