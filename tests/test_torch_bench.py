"""sla_tpu_torch.bench, the twin of bench.py, on the CPU: the same signal
bit for bit, the same stream as sla_tpu's encoder (JAX on the CPU, host
backend) for the same input, bench.py's last line (keys, metric name and
unit) from `main(device="cpu")` at a short signal, the round-trip gate, and
no run without a card unless the CPU is asked for. Signals, streams and
PCM compare exactly (integer codec, tolerance 0)."""

import json

import numpy as np
import pytest
import torch

import bench as bench_py
import sla_tpu
from sla_tpu import wavio as sla_wavio

from sla_tpu_torch import bench, native

pytestmark = pytest.mark.skipif(not native.available(), reason="native build unavailable")


def _last_line(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("seconds", [1, 2, 30])
def test_make_signal_equals_bench_py(seconds):
    got, want = bench.make_signal(seconds), bench_py.make_signal(seconds)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_constants_equal_bench_py():
    assert (bench.SECONDS, bench.RATE, bench.REF_BASELINE_MSPS) == (
        bench_py.SECONDS, bench_py.RATE, bench_py.REF_BASELINE_MSPS)


def test_encode_equals_sla_tpu_and_round_trips():
    pcm = bench.make_signal(2)
    enc = bench.encoder("cpu")
    blob = enc.encode_whole(pcm)
    ref = sla_tpu.Encoder(sla_tpu.EncoderConfig(backend="host"))
    ref.set_wave_format(sla_tpu.WaveFormat(2, 16, bench_py.RATE))
    ref.set_encode_parameter(sla_tpu.PRESETS[2])
    assert blob == ref.encode_whole(pcm)
    # the benchmarked encoder leaves the backend at 'auto': a CPU device
    # keeps every chunk on the host, and the record says so
    assert enc.config.backend == "auto"
    assert enc.filter_chunks == [(pcm.size, "host")]
    _, out = bench.Decoder(device="cpu").decode_whole(blob)
    assert np.array_equal(out, pcm)


def test_main_last_line_matches_bench_py(monkeypatch, capsys):
    # bench.py's own main at the same short signal, with no reference
    # binary and its WAV write to a fixed path stubbed out
    monkeypatch.setattr(bench_py, "make_signal", lambda: bench.make_signal(2))
    monkeypatch.setattr(bench_py, "reference_binary", lambda: None)
    monkeypatch.setattr(sla_wavio, "write_wav", lambda *a, **k: None)
    bench_py.main()
    want = _last_line(capsys.readouterr().out)
    monkeypatch.setattr(bench, "reference_binary", lambda: None)
    bench.main(device="cpu", seconds=2)
    cap = capsys.readouterr()
    got = _last_line(cap.out)
    assert list(got) == list(want) == ["metric", "value", "unit", "vs_baseline"]
    assert (got["metric"], got["unit"]) == (want["metric"], want["unit"])
    assert got["metric"] == "encode_throughput_cd_stereo_preset2"
    # no reference binary: the ratio is to the stored constant (both numbers
    # rounded to 3 decimals, so they agree within 0.0005 + 0.0005 / 1.685)
    assert got["vs_baseline"] == pytest.approx(got["value"] / bench.REF_BASELINE_MSPS, abs=1e-3)
    assert got["value"] > 0
    # stderr: bench.py's line, then the five encodes, the gate decode, each
    # filter chunk's backend and the card
    err = cap.err.strip().splitlines()[-1]
    assert err.startswith("encode ") and "ratio 0.5" in err
    encodes = err.split("encodes ")[1].split(" s ")[0].split(", ")
    assert len(encodes) == 5 and all(float(t) > 0 for t in encodes)
    assert "decode " in err and f"filter chunks (row-samples) {2 * 2 * 44100} on host" in err
    assert "card no card (device cpu)" in err


def test_gate_raises_and_prints_no_result(monkeypatch, capsys):
    real = bench.Decoder

    class WrongDecoder(real):
        def decode_whole(self, data):
            header, pcm = super().decode_whole(data)
            pcm = pcm.copy()
            pcm[1, 1000] += 1 << 16
            return header, pcm

    monkeypatch.setattr(bench, "Decoder", WrongDecoder)
    monkeypatch.setattr(bench, "reference_binary", lambda: None)
    with pytest.raises(AssertionError, match="round-trip mismatch"):
        bench.main(device="cpu", seconds=1)
    out = capsys.readouterr().out
    assert "{" not in out and "metric" not in out


def test_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    # the command line: a message on stderr, a non-zero exit, no result
    assert bench.cli([]) != 0
    cap = capsys.readouterr()
    assert cap.out == "" and "no CUDA device" in cap.err
