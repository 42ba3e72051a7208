"""sla_tpu_torch stands alone: it never imports jax, never imports or runs
a file of the sla_tpu package, and its entry points need a CUDA card unless
the caller asks for the CPU.

- A fresh interpreter that refuses every jax import runs a port
  encode/decode round trip on the device, host and mesh backends (the
  mesh over two CPU shards, `sla_tpu_torch.parallel`), the known-parameter entry
  step, the entry points (the CLI with corpus mode and the streaming
  decode, `encode_whole_batch`, `optimize_encode`, `python -m`, the
  benchmark twin `bench`, and the modules `hostref`, `command_line` and
  `debug`), the device tools'
  checks and the robustness and measurement tools (`tools/fuzz_*`,
  `run_sanitized`, `profile_decode`, `measure_*`, `bench_synth_micro`,
  their generator `tools/signals`); no loaded module may come from
  `sla_tpu/`, by name or by file.
- A copy of `sla_tpu_torch/` and `chip_smoke.py` alone in a temporary
  directory runs the round trip with `verify=True`, `entry()` and the
  entry points (the benchmark twin among them) on the CPU, and `python -m sla_tpu_torch -v` (the native
  library it would build is taken from this checkout's build cache, so the
  test stays short).
"""

import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_GUARD = r"""
import builtins, sys
_real = builtins.__import__
def _guard(name, *args, **kwargs):
    if name == "jax" or name.startswith(("jax.", "jaxlib")):
        raise ImportError("jax is refused in this interpreter: " + name)
    if name == "sla_tpu" or name.startswith("sla_tpu."):
        raise ImportError("the sla_tpu package is refused in this interpreter: " + name)
    return _real(name, *args, **kwargs)
builtins.__import__ = _guard
"""

_ROUND_TRIP = r"""
import numpy as np
import sla_tpu_torch as st

rng = np.random.default_rng(3)
pcm = (rng.integers(-3000, 3000, (2, 6000)).astype(np.int32) << 16)
blobs = []
for backend in ("device", "host"):
    enc = st.Encoder(st.EncoderConfig(backend=backend, verify=True), device="cpu")
    enc.set_wave_format(st.WaveFormat(2, 16, 44100))
    enc.set_encode_parameter(st.PRESETS[1])
    blobs.append(enc.encode_whole(pcm))
    dec = st.Decoder(st.DecoderConfig(backend=backend), device="cpu")
    assert np.array_equal(dec.decode_whole(blobs[-1])[1], pcm)
assert blobs[0] == blobs[1]
assert st.native.available()

# the mesh backend (sla_tpu_torch.parallel) over two CPU shards
from sla_tpu_torch.parallel import sharding
sharding.SHARDS = 2
enc = st.Encoder(st.EncoderConfig(backend="mesh"), device="cpu")
enc.set_wave_format(st.WaveFormat(2, 16, 44100))
enc.set_encode_parameter(st.PRESETS[1])
assert enc.encode_whole(pcm) == blobs[1]
dec = st.Decoder(st.DecoderConfig(backend="mesh"), device="cpu")
assert np.array_equal(dec.decode_whole(blobs[1])[1], pcm)

from sla_tpu_torch import entry
forward, args = entry.entry(device="cpu")
assert forward(*args).shape == (16, 4096)
"""

# the entry points: every module the port has beside the encoder and decoder
_ENTRY_POINTS = r"""
import io, contextlib, runpy, tempfile, pathlib
from sla_tpu_torch import cli, command_line, corpus, debug, hostref, optimize, streaming, wavio
from sla_tpu_torch.encoder import encode_whole_batch

d = pathlib.Path(tempfile.mkdtemp())
(d / "wavs").mkdir()
wavio.write_wav(str(d / "wavs" / "a.wav"), wavio.WavFile(2, 44100, 16, pcm))
wavio.write_wav(str(d / "wavs" / "b.wav"), wavio.WavFile(1, 44100, 16, pcm[:1]))
assert cli.main(["sla", "-e", "-q", "-b", "-f", "2", str(d / "wavs"), str(d / "slas")],
                device="cpu") == 0
assert cli.main(["sla", "-d", "-s", "-q", str(d / "slas" / "a.sla"), str(d / "a.wav")],
                device="cpu") == 0
assert np.array_equal(wavio.read_wav(str(d / "a.wav")).data, pcm)
jobs = [(st.WaveFormat(2, 16, 44100), st.PRESETS[2], pcm)]
assert encode_whole_batch(jobs, device="cpu")[0] == (d / "slas" / "a.sla").read_bytes()
assert st.optimize_encode(pcm, st.WaveFormat(2, 16, 44100), device="cpu")[0]
buf = io.StringIO()
sys.argv = ["sla_tpu_torch", "-v"]
with contextlib.redirect_stdout(buf):
    try:
        runpy.run_module("sla_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0
assert "Version" in buf.getvalue()

# the benchmark twin (bench.py's), on a one-second signal
from sla_tpu_torch import bench
bench.main(device="cpu", seconds=1)
"""

_TOOLS = r"""
from sla_tpu_torch.tools import bench_device, verify_device
assert all(ok for _, ok in bench_device.check_cells("cpu", rows=4, samples=256))
assert all(ok for _, ok in verify_device.check_cascades("cpu", rows=4, samples=256))
# the robustness and measurement twins: their own signal generator, streams
# and mutants made without sla_tpu or tests/
from sla_tpu_torch.tools import (bench_synth_micro, common, fuzz_corruption,
    fuzz_device_entropy, fuzz_salvage, fuzz_streaming, measure_multiproc,
    measure_streaming, profile_decode, run_sanitized, signals)
rng = np.random.default_rng(0)
_, streams = fuzz_corruption.base_streams(rng, "cpu")
assert [k for _, k, _, _ in fuzz_corruption.mutants(streams, 2, rng)] == [0, 1]
assert fuzz_salvage.damage(np.random.default_rng(0), 0, 0, "cpu") is not None
assert signals.gen_wave("gauss", 8, 2, 16, 0).shape == (2, 8)
"""

_REPORT = r"""
import os
ref = os.path.join(os.path.abspath(sys.argv[1]), "")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sla_tpu"))
files = sorted(
    m for m, mod in list(sys.modules.items())
    if os.path.abspath(getattr(mod, "__file__", None) or "").startswith(ref)
)
print("LOADED", loaded)
print("FROM_SLA_TPU", files)
"""


def _run(script: str, cwd: pathlib.Path) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", script, str(REPO / "sla_tpu")], cwd=cwd,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_port_round_trip_loads_no_jax():
    out = _run(_GUARD + _ROUND_TRIP + _ENTRY_POINTS + _TOOLS + _REPORT, REPO)
    assert "LOADED []" in out, out
    assert "FROM_SLA_TPU []" in out, out


def test_port_runs_without_the_sla_tpu_package(tmp_path):
    shutil.copytree(REPO / "sla_tpu_torch", tmp_path / "sla_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    # reuse the native library this checkout built (same source and command,
    # so the same key); without it the copy builds its own
    cache = REPO / "build" / "sla_tpu_torch"
    (tmp_path / "build" / "sla_tpu_torch").mkdir(parents=True)
    for lib in cache.glob("libsla_native_*.so"):
        shutil.copy(lib, tmp_path / "build" / "sla_tpu_torch" / lib.name)
    assert not (tmp_path / "sla_tpu").exists()
    out = _run(_GUARD + _ROUND_TRIP + _ENTRY_POINTS + _REPORT, tmp_path)
    assert "LOADED []" in out, out
    assert "FROM_SLA_TPU []" in out, out
    assert not list((tmp_path / "sla_tpu_torch").rglob("*.so")), "a build wrote into the package"
    # `python -m sla_tpu_torch` from the copy, with no sla_tpu/ beside it
    proc = subprocess.run([sys.executable, "-m", "sla_tpu_torch", "-v"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("SLA - Solitary Lossless Audio Compressor Version")


@pytest.mark.parametrize("which", ["Encoder", "Decoder"])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch, which):
    import sla_tpu_torch as st

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls = getattr(st, which)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(device="cuda")
    assert cls(device="cpu").device.type == "cpu"
