"""On-card identity check of the port's seven CUDA kernels: the twin of
tools/verify_device.py.

    python -m sla_tpu_torch.tools.verify_device

Each check runs kernels on the card and holds their output, exactly,
against the plain PyTorch filters on the same inputs, at the JAX tool's
shapes (128 rows x 4,096 samples, p 16, M 8; 256 x 4,096, p 16, T 3, M 8
for 5 and 6). For a single-stage kernel the plain version is the plain
filter chain (kernels/{emphasis,lattice,lms,longterm}.py) itself.

  1.  lattice predict (K1) and synthesize (K5), with pre-/de-emphasis and
      without;
  2.  LMS predict (K2 with no long-term stage) and synthesize (K6);
  2b. long-term synthesize (K7) at T 1, 3 and 5, mixed active and
      inactive rows;
  3.  Encoder(backend='device') against backend='host', byte for byte;
  4.  Decoder(backend='device') against backend='host' and the input PCM;
  5.  the synthesis cascade (K3) against its plain chain;
  6.  the fused encode (K4) against K1 then K2 on the card, and against
      the plain chain `pipeline.encode_filters`.

Left out: the JAX tool's checks 3b and 4b (encode with host entropy on the
device backend, decode with on-chip Rice) need on-chip entropy coding
(sla_tpu/rice_device.py), which is not ported yet (ROADMAP.md, Queue 1,
item 6). Its wide-vs-narrow checks (2c) and its windowed-vs-one-hot decode
(5) have no counterpart: the port has one kernel for each narrow/wide
pair and no window plan, so 5 holds K3 against its plain chain instead.

`run_checks(device, ...)` returns the results; `chip_smoke.py` and the
tests call it (the tests on the CPU, where every wrapper runs its plain
version). `main()` exits 0 only if every check passes, and non-zero
without a CUDA device.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import pipeline
from ..kernels import cuda_filters as cf
from ..params import longterm_params

ROWS, SAMPLES = 128, 4096  # checks 1-2b (TILE_B x 2 * TILE_L in the JAX tool)
CASCADE_ROWS = 256  # checks 5 and 6
PCM_SAMPLES = 6 * 12288  # checks 3 and 4: six preset-2 blocks of stereo
P, M, CASCADE_T = 16, 8, 3


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def _same(out: torch.Tensor, ref: torch.Tensor) -> bool:
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out.shape == ref.shape and torch.equal(out, ref)


def check_filters(device, rows: int = ROWS, samples: int = SAMPLES, seed: int = 0):
    """Checks 1-2b: K1, K5, K2 (LMS alone), K6 and K7 against their plain
    versions. Returns [(name, ok)]."""
    rng = np.random.default_rng(seed)
    data = rng.integers(-30000, 30000, (rows, samples), dtype=np.int32)
    coef = rng.integers(-25000, 25000, (rows, P), dtype=np.int32)
    x, c = _t(data, device), _t(coef, device)
    results = []
    for emphasis in (True, False):
        tag = "" if emphasis else ", no emphasis"
        results.append((f"lattice predict (K1{tag})", _same(
            cf.lattice_predict(x, c, emphasis), cf.lattice_predict_plain(x, c, emphasis))))
        results.append((f"lattice synth (K5{tag})", _same(
            cf.lattice_synth(x, c, emphasis), cf.lattice_synth_plain(x, c, emphasis))))
    no_lt = torch.zeros((rows,), dtype=torch.int32, device=x.device)
    no_taps = torch.zeros((rows, 0), dtype=torch.int32, device=x.device)
    results.append(("lms predict (K2, no long-term stage)", _same(
        cf.stage2_predict(x, no_lt, no_taps, M), cf.stage2_predict_plain(x, no_lt, no_taps, M))))
    results.append(("lms synth (K6)", _same(cf.lms_synth(x, M), cf.lms_synth_plain(x, M))))
    for T in (1, 3, 5):
        pitch = rng.integers(0, 256, (rows,), dtype=np.int32)
        pitch[::3] = 0
        pitch[(pitch > 0) & (pitch < T)] += T
        ltm = rng.integers(-32768, 32768, (rows, T), dtype=np.int32) << 16
        md, q15 = longterm_params(pitch, ltm, T, x.device)
        results.append((f"longterm synth T={T} (K7)", _same(
            cf.longterm_synth(x, md, q15), cf.longterm_synth_plain(x, md, q15))))
    return results


def _test_pcm(samples: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 44100.0
    sig = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(0, 1, samples)
    pcm = np.stack([sig, 0.9 * sig])
    return np.clip(pcm * 32767, -32768, 32767).astype(np.int32) << 16


def check_codec(device, pcm_samples: int = PCM_SAMPLES, seed: int = 0):
    """Checks 3 and 4: preset-2 encode and decode on the device backend
    against the host backend. Returns [(name, ok)]."""
    import sla_tpu_torch as st

    pcm = _test_pcm(pcm_samples, seed)

    def encode(backend, dev):
        enc = st.Encoder(st.EncoderConfig(backend=backend), device=dev)
        enc.set_wave_format(st.WaveFormat(2, 16, 44100))
        enc.set_encode_parameter(st.PRESETS[2])
        return enc.encode_whole(pcm)

    def decode(blob, backend, dev):
        return st.Decoder(st.DecoderConfig(backend=backend), device=dev).decode_whole(blob)[1]

    blob_host = encode("host", "cpu")
    blob_dev = encode("device", device)
    pcm_host = decode(blob_host, "host", "cpu")
    pcm_dev = decode(blob_host, "device", device)
    return [
        (f"device-vs-host encode ({len(blob_host)} bytes)", blob_dev == blob_host),
        ("device-vs-host decode", np.array_equal(pcm_dev, pcm_host)
         and np.array_equal(pcm_host, pcm)),
    ]


def check_cascades(device, rows: int = CASCADE_ROWS, samples: int = SAMPLES, seed: int = 5):
    """Checks 5 and 6: K3 against its plain chain; K4 against K1 then K2
    and against the plain encode chain. Lags 16-249 (sorted, as the JAX
    tool draws them) with some rows off. Returns [(name, ok)]."""
    T = CASCADE_T
    rng = np.random.default_rng(seed)
    data = rng.integers(-(1 << 20), 1 << 20, (rows, samples), dtype=np.int32)
    coef = rng.integers(-25000, 25000, (rows, P), dtype=np.int32)
    pitch = np.sort(rng.integers(16, 250, rows).astype(np.int32))[::-1].copy()
    pitch[5::37] = 0
    ltm = rng.integers(-32768, 32768, (rows, T), dtype=np.int32) << 16
    x, c = _t(data, device), _t(coef, device)
    md, q15 = longterm_params(pitch, ltm, T, x.device)
    results = [("synth cascade (K3)", _same(
        cf.synth_cascade(x, c, md, q15, M), cf.synth_cascade_plain(x, c, md, q15, M)))]
    fused = pipeline.encode_filters_fused(x, c, pitch, ltm, P, T, M)
    staged = pipeline.encode_stage2(pipeline.encode_stage1(x, c, P), pitch, ltm, T, M)
    results.append(("fused encode (K4) vs K1 + K2", _same(fused, staged)))
    results.append(("fused encode (K4) vs the plain chain", _same(
        fused, pipeline.encode_filters(x, c, pitch, ltm, P, T, M))))
    return results


def run_checks(device, rows: int = ROWS, samples: int = SAMPLES,
               cascade_rows: int = CASCADE_ROWS, pcm_samples: int = PCM_SAMPLES):
    """Every check at the given sizes, in the JAX tool's order."""
    return (check_filters(device, rows, samples)
            + check_codec(device, pcm_samples)
            + check_cascades(device, cascade_rows, samples))


def main() -> int:
    if not torch.cuda.is_available():
        print("verify_device: torch finds no CUDA device; run this on a machine "
              "with an NVIDIA GPU", file=sys.stderr)
        return 2
    print(f"device={torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    results = run_checks("cuda")
    for name, ok in results:
        print(f"{name}: {'OK' if ok else 'MISMATCH'}", flush=True)
    ok = all(ok for _, ok in results)
    print(f"{'all bit-identical' if ok else 'MISMATCH DETECTED'}; "
          f"total {time.perf_counter() - t0:.1f} s")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
