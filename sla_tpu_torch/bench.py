"""Benchmark: end-to-end SLA encode throughput, CD stereo 44.1 kHz/16-bit,
default preset 2 (reference src/main.c:63-76), against the single-core
reference C encoder: the twin of bench.py on the port.

    python -m sla_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line last:
    {"metric": ..., "value": N, "unit": "Msamples/s", "vs_baseline": N}

`value` counts PCM samples (frames x channels) per wall second of
`Encoder.encode_whole`, best of five after a warmup run, with the encoder's
backend left at 'auto' (pipeline.select_backend decides each filter chunk
by its row-samples; SLA_TPU_DEVICE_THRESHOLD moves the threshold, and 0
sends every chunk to the card). `vs_baseline` is the ratio to the reference
C binary's throughput measured on the same host when tools/sla_ref is
present, else to the stored constant below. The stream must decode back
to the exact PCM, or the script raises and prints no result.

The line before it, on stderr, gives the best encode, the ratio, the
reference's rate, the five encode times, the gate decode's time, each
filter chunk's row-samples and backend, and the card's name and power
limit as nvidia-smi reports them.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import PRESETS, Decoder, Encoder, EncoderConfig, WaveFormat, wavio
from .encoder import resolve_device
from .tools.bench_device import card_line
from .tools.common import open_device

REPO = pathlib.Path(__file__).resolve().parent.parent  # the directory holding the package

# Reference C binary throughput on this config, as bench.py stores it
# (gcc -std=c89 -O3 -DNDEBUG, single core): 30 s CD stereo -> 1.57 s.
REF_BASELINE_MSPS = 1.685

SECONDS = 30
RATE = 44100
METRIC = "encode_throughput_cd_stereo_preset2"


def make_signal(seconds: int = SECONDS) -> np.ndarray:
    """Correlated stereo test signal: tones + smoothed noise, realistic
    compressibility (reference ratio ~0.56 at preset 2)."""
    rng = np.random.default_rng(7)
    n = RATE * seconds
    t = np.arange(n) / RATE
    sig = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 1320 * t)
    noise = rng.normal(0, 0.02, (2, n))
    k = np.ones(8) / 8
    noise = np.stack([np.convolve(noise[0], k, "same"), np.convolve(noise[1], k, "same")])
    pcm = np.clip(
        (sig[None, :] * np.array([[1.0], [0.9]]) + noise) * 32767, -32768, 32767
    ).astype(np.int32)
    return pcm << 16  # canonical left-justified int32


def reference_binary() -> pathlib.Path | None:
    """The reference C encoder at tools/sla_ref in the checkout, if one was
    built there; the port builds none (the reference sources are not in the
    repository)."""
    ref = REPO / "tools" / "sla_ref"
    return ref if ref.exists() else None


def time_reference_once(ref: pathlib.Path, wav_path: pathlib.Path) -> float | None:
    out = wav_path.parent / "bench_ref.sla"
    t0 = time.time()
    r = subprocess.run(
        [str(ref), "-e", "-q", "-m", "2", str(wav_path), str(out)],
        capture_output=True,
    )
    if r.returncode != 0:
        return None
    return time.time() - t0


def reference_overhead_floor(ref: pathlib.Path, tmp: pathlib.Path) -> float:
    """Wall-clock floor of a reference run that does ~no encoding work
    (process spawn + tiny WAV parse + tiny write): subtracted from the
    measured encode walls so the ratio compares encode cost against
    encode cost, not our in-memory call against spawn+IO. The ~10 MB
    input read is NOT captured here (a residual ~2% bias against us)."""
    tiny = tmp / "bench_tiny.wav"
    wavio.write_wav(str(tiny), wavio.WavFile(2, RATE, 16, np.zeros((2, 256), dtype=np.int32)))
    floors = []
    for _ in range(3):
        t = time_reference_once(ref, tiny)
        if t is not None:
            floors.append(t)
    return min(floors) if floors else 0.0


def encoder(device, backend: str = "auto") -> Encoder:
    """The benchmarked encoder: CD stereo at preset 2, on `backend` ('auto'
    in the benchmark)."""
    enc = Encoder(EncoderConfig(backend=backend), device=device)
    enc.set_wave_format(WaveFormat(2, 16, RATE))
    enc.set_encode_parameter(PRESETS[2])
    return enc


def main(device=None, seconds: int = SECONDS) -> None:
    """The benchmark on `device` (None: the CUDA card; raises without
    one). `seconds` shortens the signal for the tests."""
    device = resolve_device(device)
    data = make_signal(seconds)
    n = data.shape[1]

    enc = encoder(device)

    # warmup: load the kernels and the native library, warm the card
    enc.encode_whole(np.ascontiguousarray(data[:, : 4 * 12288]))

    with tempfile.TemporaryDirectory(prefix="sla_bench_") as tmp_dir:
        tmp = pathlib.Path(tmp_dir)
        ref = reference_binary()
        wav_path = tmp / "bench_cd.wav"
        if ref is not None:
            wavio.write_wav(str(wav_path), wavio.WavFile(2, RATE, 16, data))

        # interleaved best-of pairs: sample ours and the reference back to
        # back and take each side's best, so load spikes hit both
        # measurements instead of skewing the ratio
        spawn_floor = reference_overhead_floor(ref, tmp) if ref is not None else 0.0
        times = []
        ref_dt = None
        for _ in range(5):  # best-of-5: the host's load swings the walls
            t0 = time.time()
            blob = enc.encode_whole(data)
            times.append(time.time() - t0)
            if ref is not None:
                rt = time_reference_once(ref, wav_path)
                if rt is not None:
                    ref_dt = rt if ref_dt is None else min(ref_dt, rt)
    dt = min(times)
    msps = 2 * n / dt / 1e6

    # correctness gate: round-trip must be bit-exact
    t0 = time.time()
    _, out = Decoder(device=device).decode_whole(blob)
    decode_s = time.time() - t0
    if out.shape != data.shape or not np.array_equal(out, data):
        raise AssertionError("round-trip mismatch")

    if ref_dt:
        ref_dt = max(ref_dt - spawn_floor, 1e-6)
    ref_msps = 2 * n / ref_dt / 1e6 if ref_dt else REF_BASELINE_MSPS

    ratio = len(blob) / (4 * n)
    card = card_line() if device.type == "cuda" else f"no card (device {device})"
    chunks = ", ".join(f"{rows} on {backend}" for rows, backend in enc.filter_chunks)
    print(
        f"encode {dt:.2f}s  ratio {ratio:.4f}  ref {ref_msps:.3f} Msamples/s  "
        f"encodes {', '.join(f'{t:.4f}' for t in times)} s  decode {decode_s:.4f} s  "
        f"filter chunks (row-samples) {chunks}  card {card}",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": METRIC,
                "value": round(msps, 3),
                "unit": "Msamples/s",
                "vs_baseline": round(msps / ref_msps, 3),
            }
        )
    )


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m sla_tpu_torch.bench",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device of the filter stages (default cuda; cpu runs the "
                        "kernels' plain versions)")
    device = open_device("bench", p.parse_args(argv).device)
    if device is None:
        return 2
    main(device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
