"""Smoke run of sla_tpu_torch on one NVIDIA GPU: the port's encode/decode
path and its known-parameter path at a real size, through the seven
hand-written CUDA kernels.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. environment: the card, torch and CUDA versions, the kernels' nvcc build
   (from csrc/ in this checkout) and the native host library;
2. kernels: K1-K7 against their plain PyTorch versions on the card, exact,
   at the main path's shape (2,048 rows x 12,288 samples, p 16, T 1, M 8)
   and at p 32, T 3, M 8, L 16,384; kernel and plain times by CUDA events,
   and the fused encode (K4) against K1 + K2;
3. slice: five minutes of seeded CD stereo (44.1 kHz, 16 bit) at preset 2
   through Encoder/Decoder(backend='device', device='cuda') — the stream
   must equal backend='host' byte for byte and decode to the exact PCM —
   with K1-K3's launch counts above 0; then one minute of 96 kHz / 24-bit
   stereo at preset 4, checked the same way;
4. known parameters: the bench twin's cells (checked, then timed) at 256
   and 2,048 rows, the verify twin's checks, and entry()'s forward step
   against the plain encode chain, with all seven launch counts above 0.

The last lines are the kernels' JSON record, the card's name and power
limit as nvidia-smi reports them, and the result. Imports neither jax nor
sla_tpu.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sla_tpu_torch.tools.bench_device import card_line, cuda_ms  # noqa: E402

PALLAS = "sla_tpu/kernels/pallas_filters.py"
KERNELS = {  # wrapper name -> (Pallas function it replaces, file:line)
    "lattice_predict": f"{PALLAS}:1700",  # lattice_filter_tl(synthesize=False)
    "stage2_predict": f"{PALLAS}:839",  # fused_stage2_tl
    "synth_cascade": f"{PALLAS}:1574",  # fused_synth_tl
    "fused_encode": f"{PALLAS}:793",  # fused_encode_tl
    "lattice_synth": f"{PALLAS}:1700",  # lattice_filter_tl(synthesize=True)
    "lms_synth": f"{PALLAS}:1735",  # lms_filter_tl(synthesize=True)
    "longterm_synth": f"{PALLAS}:412",  # longterm_synth_tl
}
SLICE_KERNELS = ("lattice_predict", "stage2_predict", "synth_cascade")  # phase 3's path
SOURCE = "sla_tpu_torch/csrc/filters.cu"


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# -- phase 1 -----------------------------------------------------------------


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA device")
    from sla_tpu_torch.host import native
    from sla_tpu_torch.kernels import build

    card = card_line()
    t0 = time.perf_counter()
    build.cuda_library()
    nvcc_s = build.build_seconds.get("sla_filters_cuda", 0.0)
    load_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in build.build_log().splitlines() if "registers" in ln]
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("the native host library did not build (g++ -O3, sla_tpu/native)")
    native_s = time.perf_counter() - t0
    log("env", f"{card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | nvcc build {nvcc_s:.1f} s (load {load_s:.1f} s) "
        f"| native host library {native_s:.1f} s")
    for ln in ptxas:
        log("env", f"ptxas {ln}")
    return card


# -- phase 2 -----------------------------------------------------------------


def kernel_inputs(seed: int, B: int, L: int, p: int, T: int):
    """Seeded rows and parameters: pitch 0 rows, lags under 8 (which the
    TPU window plan refuses) and lags up to 257."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << 20), 1 << 20, (B, L), dtype=np.int32)
    x[0, ::11] = -(2**31)
    coef = rng.integers(-25000, 25000, (B, p), dtype=np.int32)
    pitch = rng.integers(T // 2 + 1, 257, B)
    pitch[::5] = 0
    pitch[1::7] = rng.integers(T // 2 + 1, 8, len(pitch[1::7]))
    pitch[2] = 256  # the longest lag a stream can carry
    md = np.where(pitch > 0, pitch + T // 2, 0).astype(np.int32)
    q15 = rng.integers(-32768, 32768, (B, T), dtype=np.int32)
    dev = torch.device("cuda")
    return [torch.from_numpy(a).to(dev) for a in (x, coef, md, q15)]


def check_kernel(name, kern, plain, reps: int):
    out = kern()
    torch.cuda.synchronize()
    ref_holder = []
    plain_ms = cuda_ms(lambda: ref_holder.append(plain()))
    ref = ref_holder[0]
    err = int((out.to(torch.int64) - ref.to(torch.int64)).abs().max())
    if not torch.equal(out, ref):
        raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err})")
    ms = cuda_ms(kern, reps)
    return err, ms, plain_ms


def phase_kernels() -> dict:
    from sla_tpu_torch.kernels import cuda_filters as cf

    results = {}
    for B, L, p, T, M in ((2048, 12288, 16, 1, 8), (2048, 16384, 32, 3, 8)):
        x, coef, md, q15 = kernel_inputs(B + L + p, B, L, p, T)
        r1 = cf.lattice_predict_plain(x, coef)
        cases = {
            "lattice_predict": (lambda: cf.lattice_predict(x, coef),
                                lambda: cf.lattice_predict_plain(x, coef)),
            "stage2_predict": (lambda: cf.stage2_predict(r1, md, q15, M),
                               lambda: cf.stage2_predict_plain(r1, md, q15, M)),
            "synth_cascade": (lambda: cf.synth_cascade(x, coef, md, q15, M),
                              lambda: cf.synth_cascade_plain(x, coef, md, q15, M)),
            "fused_encode": (lambda: cf.fused_encode(x, coef, md, q15, M),
                             lambda: cf.fused_encode_plain(x, coef, md, q15, M)),
            "lattice_synth": (lambda: cf.lattice_synth(x, coef),
                              lambda: cf.lattice_synth_plain(x, coef)),
            "lms_synth": (lambda: cf.lms_synth(x, M), lambda: cf.lms_synth_plain(x, M)),
            "longterm_synth": (lambda: cf.longterm_synth(x, md, q15),
                               lambda: cf.longterm_synth_plain(x, md, q15)),
        }
        shape = {}
        for name, (kern, plain) in cases.items():
            err, ms, plain_ms = check_kernel(name, kern, plain, reps=5)
            shape[name] = ms
            log("kernels", f"{name} B {B} L {L} p {p} T {T} M {M}: exact, kernel "
                f"{ms:.3f} ms, plain {plain_ms:.1f} ms (x{plain_ms / ms:.0f})")
            if (B, L) == (2048, 12288):  # the main path's shape: the record
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            else:
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        staged = shape["lattice_predict"] + shape["stage2_predict"]
        log("kernels", f"B {B} L {L}: fused_encode {shape['fused_encode']:.3f} ms against "
            f"lattice_predict + stage2_predict {staged:.3f} ms")
    return results


# -- phase 3 -----------------------------------------------------------------


def music(seconds: float, rate: int, bits: int, seed: int, f_lo: float, f_hi: float):
    """Seeded stereo test signal: a new harmonic note every half second
    (periods within the long-term predictor's reach), vibrato, noise.
    Canonical left-justified int32, (2, n)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    seg = rate // 2
    nseg = -(-n // seg)
    t = np.arange(n) / rate
    out = np.empty((2, n), dtype=np.int32)
    full = (1 << (bits - 1)) - 1
    for ch in range(2):
        f0 = np.repeat(rng.uniform(f_lo, f_hi, nseg), seg)[:n]
        phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.002 * np.sin(2 * np.pi * 5 * t))) / rate
        x = np.zeros(n)
        for k, a in enumerate((1.0, 0.5, 0.33, 0.25, 0.2, 0.1), start=1):
            x += a * np.sin(k * phase + ch)
        x = 0.3 * full * x / 2.38 + rng.normal(0, full * 0.002, n)
        out[ch] = np.clip(np.round(x), -full - 1, full).astype(np.int32) << (32 - bits)
    return out


def round_trip(st, label: str, pcm, bits: int, rate: int, preset: int, count: bool) -> dict:
    from sla_tpu_torch.kernels import cuda_filters as cf

    ep = st.preset_parameter(preset, 2)

    def encoder(backend, device):
        enc = st.Encoder(st.EncoderConfig(backend=backend), device=device)
        enc.set_wave_format(st.WaveFormat(2, bits, rate))
        enc.set_encode_parameter(ep)
        return enc

    if count:
        cf.reset_launch_counts()
    enc = encoder("device", "cuda")
    t0 = time.perf_counter()
    blob = enc.encode_whole(pcm)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    dec = st.Decoder(st.DecoderConfig(backend="device"), device="cuda")
    t0 = time.perf_counter()
    _, out = dec.decode_whole(blob)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = dict(cf.launches)
    host = encoder("host", "cpu")
    t0 = time.perf_counter()
    host_blob = host.encode_whole(pcm)
    host_s = time.perf_counter() - t0
    if blob != host_blob:
        raise AssertionError(f"{label}: device stream differs from the host backend's")
    if out.shape != pcm.shape or not np.array_equal(out, pcm):
        raise AssertionError(f"{label}: decoded PCM differs from the input")
    if count and not all(launches[k] > 0 for k in SLICE_KERNELS):
        raise AssertionError(f"{label}: a kernel of the path never launched: {launches}")
    raw = pcm.shape[0] * pcm.shape[1] * bits // 8
    log("slice", f"{label} preset {preset}: byte-identical to host, PCM exact; encode "
        f"{enc_s:.3f} s (host backend {host_s:.3f} s), decode {dec_s:.3f} s, ratio "
        f"{raw / len(blob):.4f}, launches {launches}")

    def stages(times):
        return ", ".join(f"{k} {v * 1e3:.1f}" for k, v in times.items())

    log("slice", f"{label} stage ms: device encode [{stages(enc.stage_times)}]; host "
        f"encode [{stages(host.stage_times)}]; device decode [{stages(dec.stage_times)}]")
    return launches


def phase_slice() -> dict:
    import sla_tpu_torch as st

    cd = music(300, 44100, 16, seed=2026, f_lo=180, f_hi=900)
    launches = round_trip(st, "5 min CD stereo 44.1 kHz/16", cd, 16, 44100, 2, count=True)
    del cd
    hi = music(60, 96000, 24, seed=2027, f_lo=400, f_hi=1800)
    round_trip(st, "1 min stereo 96 kHz/24", hi, 24, 96000, 4, count=False)
    return launches


# -- phase 4 -----------------------------------------------------------------


def phase_known_parameters() -> dict:
    from sla_tpu_torch import entry, pipeline
    from sla_tpu_torch.kernels import cuda_filters as cf
    from sla_tpu_torch.tools import bench_device, verify_device

    cf.reset_launch_counts()
    for rows in bench_device.ROWS:
        for name, ok in bench_device.check_cells("cuda", rows):
            if not ok:
                raise AssertionError(f"bench: {name} failed")
        for r in bench_device.time_cells(rows):
            log("bench", f"{r['cell']} B {rows} L {r['samples']}: {r['ms']:.3f} ms, "
                f"{r['g_row_samples_per_s']:.3f} G row-samples/s")
    t0 = time.perf_counter()
    results = verify_device.run_checks("cuda")
    failed = [name for name, ok in results if not ok]
    if failed:
        raise AssertionError(f"verify: {failed} failed")
    log("verify", f"{len(results)} checks bit-identical in {time.perf_counter() - t0:.1f} s: "
        + "; ".join(name for name, _ in results))
    forward, args = entry.entry()
    out = forward(*args)
    torch.cuda.synchronize()
    if out.shape != args[0].shape or out.dtype != torch.int32 or out.device.type != "cuda":
        raise AssertionError(f"entry: forward gave {tuple(out.shape)} {out.dtype} on {out.device}")
    ref = pipeline.encode_filters(*args, entry.PARCOR_ORDER, entry.NUM_TAPS, entry.LMS_ORDER)
    if not torch.equal(out, ref):
        raise AssertionError("entry: forward differs from the plain encode chain")
    launches = dict(cf.launches)
    log("known", f"entry forward {tuple(out.shape)} equals the plain chain; launches {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"known-parameter path: a kernel never launched: {launches}")
    return launches


def main() -> int:
    card = phase_environment()
    timing = phase_kernels()
    slice_launches = phase_slice()
    known_launches = phase_known_parameters()
    record = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": KERNELS[name],
         "launches": slice_launches[name] + known_launches[name], **timing[name]}
        for name in KERNELS
    ]
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
