"""sla_tpu_torch never imports jax: a fresh interpreter that refuses every
jax import runs a port encode/decode round trip on both backends, the
known-parameter entry step and the device tools' checks."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import builtins, sys
_real = builtins.__import__
def _guard(name, *args, **kwargs):
    if name == "jax" or name.startswith(("jax.", "jaxlib")):
        raise ImportError("jax is refused in this interpreter: " + name)
    return _real(name, *args, **kwargs)
builtins.__import__ = _guard

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

from sla_tpu_torch import entry
from sla_tpu_torch.tools import bench_device, verify_device
forward, args = entry.entry(device="cpu")
assert forward(*args).shape == (16, 4096)
assert all(ok for _, ok in bench_device.check_cells("cpu", rows=4, samples=256))
assert all(ok for _, ok in verify_device.check_cascades("cpu", rows=4, samples=256))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "sla_tpu"))
print("LOADED", loaded)
"""


def test_port_round_trip_loads_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOADED []" in proc.stdout, proc.stdout
