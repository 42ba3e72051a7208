"""On-card identity check of the port's nine CUDA kernels: the twin of
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
  2d. the entropy kernels: K8 (payload bytes) and K9 (rows and flags) on
      seeded blocks whose payloads start at every bit alignment, with a
      short last block and full-range residuals (gamma escapes), and K9's
      flags on the three kinds of corrupt payload;
  3.  Encoder(backend='device') against backend='host', byte for byte (the
      device backend codes its entropy on the card, K8, by default);
  3b. the same with device_entropy='off': host entropy over the residual
      the device filters computed;
  4.  Decoder(backend='device') against backend='host' and the input PCM
      (K9 by default);
  4b. forced on-card entropy (SLA_TPU_DEVICE_ENTROPY=1) and
      device_entropy='off' on the device backend, both against the host
      PCM;
  5.  the synthesis cascade (K3) against its plain chain;
  6.  the fused encode (K4) against K1 then K2 on the card, and against
      the plain chain `pipeline.encode_filters`.

The JAX tool's wide-vs-narrow checks (2c) and its windowed-vs-one-hot
decode (5) have no counterpart: the port has one kernel for each
narrow/wide pair and no window plan, so 5 holds K3 against its plain chain
instead. 2d is the port's own: the JAX tool runs its scans only through
the codec.

`run_checks(device, ...)` returns the results; `chip_smoke.py` and the
tests call it (the tests on the CPU, where every wrapper runs its plain
version). `main()` exits 0 only if every check passes, and non-zero
without a CUDA device.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .. import native, pipeline, rice_device
from ..kernels import cuda_entropy as ce
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


def entropy_blocks(seed: int, B: int, C: int, L: int, scale: float, spread: float = 0.0):
    """Seeded recursive-Rice blocks: (rows (B*C, L) int32, counts (B,),
    inits (B, C) uint32). Residuals are normal, each block's scale `scale`
    times 2^u with u uniform in [-spread, spread], each sample times 1, 2,
    4, 8 or 16 (bursts, so the tail quotients around the escape at 16 all
    occur), with INT32_MIN and INT32_MAX sprinkled in (long gamma codes);
    the last block is short; initial parameters are the blocks' mean zigzag
    magnitudes, raised to 40 where the block would take the static-Golomb
    branch."""
    rng = np.random.default_rng(seed)
    scales = np.repeat(scale * 2.0 ** rng.uniform(-spread, spread, B), C)[:, None]
    bursts = 2.0 ** rng.integers(0, 5, (B * C, L))
    rows = (rng.normal(0, 1, (B * C, L)) * scales * bursts).clip(-(2**31), 2**31 - 1).astype(np.int32)
    rows[0, ::97] = -(2**31)
    rows[-1, 5::89] = 2**31 - 1
    counts = np.full(B, L, dtype=np.int32)
    counts[-1] = max(1, 3 * L // 4 + 1)
    rows.reshape(B, C, L)[-1, :, counts[-1]:] = 0
    zz = np.where(rows < 0, -2 * rows.astype(np.int64) - 1, 2 * rows.astype(np.int64))
    n = np.repeat(counts, C).astype(np.int64)
    inits = np.maximum(zz.sum(axis=1) // n, 1).astype(np.uint32).reshape(B, C)
    for b in range(B):
        if rice_device.is_golomb_block(inits[b]):
            inits[b] = np.maximum(inits[b], 40)
    return rows, counts, inits


def entropy_stream(seed: int, rows: np.ndarray, counts, inits, C: int):
    """The blocks' payloads (the host coder's, native.put_data_array) in one
    stream, each starting at a seeded bit offset: a few junk bits before the
    first and between any two, so the payloads start at every alignment.
    Returns (stream bytes, bit_offsets (B,), block_bits (B,) up to the next
    payload or the stream's end)."""
    rng = np.random.default_rng(seed)
    B, L = len(counts), rows.shape[1]
    parts, offsets, pos = [], [], 0
    for b in range(B):
        gap = rng.integers(0, 2, int(rng.integers(1, 40)), dtype=np.uint8)
        payload = native.put_data_array(rows[b * C : (b + 1) * C, : counts[b]], list(inits[b]))
        bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8))
        parts += [gap, bits]
        pos += gap.size
        offsets.append(pos)
        pos += bits.size
    stream = np.packbits(np.concatenate(parts)).tobytes()
    offsets = np.asarray(offsets, dtype=np.int64)
    ends = np.append(offsets[1:], 8 * len(stream))
    return stream, offsets, ends - offsets


def corrupt_entropy_stream(stream: bytes, offsets) -> bytes:
    """A copy of the stream with two of K9's flag conditions planted: block
    0 holds a unary run of more than 16 zeros, and block 1 opens with an
    escape whose gamma code has more than 32 digits (16 zeros, a one, 40
    zeros). The third, a cursor past the window, needs no change to the
    bytes: declare each block's region shorter than its payload."""
    bits = np.unpackbits(np.frombuffer(stream, dtype=np.uint8)).copy()
    o0, o1 = int(offsets[0]), int(offsets[1])
    bits[o0 + 3 : o0 + 3 + 200] = 0
    bits[o1 : o1 + 57] = 0
    bits[o1 + 16] = 1
    return np.packbits(bits).tobytes()


def decode_entropy_stream(device, stream: bytes, offsets, block_bits, counts, inits, C: int,
                          n_max: int):
    """K9 and its plain version on one stream: ((rows, bad), (rows, bad))."""
    dev = torch.device(device)
    words = rice_device.upload_stream(stream, dev)
    W = rice_device.window_width(np.asarray(offsets), np.asarray(block_bits))
    args = (torch.from_numpy(np.asarray(offsets, dtype=np.int64)).to(dev), W,
            torch.from_numpy(np.asarray(counts, dtype=np.int32)).to(dev),
            torch.from_numpy(np.asarray(inits, dtype=np.int64)).to(dev), C, n_max)
    return (ce.rice_decode_blocks(words, *args),
            ce.rice_decode_blocks_plain(words, *args))


def check_entropy(device, blocks: int = ROWS // 2, samples: int = SAMPLES, seed: int = 3):
    """Check 2d: K8 and K9 against their plain versions. Returns
    [(name, ok)]."""
    dev = torch.device(device)
    C = 2
    rows, counts, inits = entropy_blocks(seed, blocks, C, samples, 3000.0)
    x = torch.from_numpy(rows).to(dev)
    row0 = torch.arange(0, blocks * C, C, dtype=torch.int32, device=dev)
    cnt = torch.from_numpy(counts).to(dev)
    ini = torch.from_numpy(inits.astype(np.int64)).to(dev)
    got = ce.rice_encode_blocks(x, row0, cnt, ini, C)
    want = ce.rice_encode_blocks_plain(x, row0, cnt, ini, C)
    results = [("rice encode blocks (K8)", all(torch.equal(a, b) for a, b in zip(got, want)))]
    stream, offs, bits = entropy_stream(seed, rows, counts, inits, C)
    # (name, stream, block regions, the flags the blocks must raise)
    planted = np.zeros(blocks, dtype=bool)
    planted[:2] = True
    cases = (
        ("payloads at every alignment", stream, bits, np.zeros(blocks, dtype=bool)),
        ("a long unary run and a long gamma code flagged",
         corrupt_entropy_stream(stream, offs), bits, planted),
        ("a cursor past the window flagged", stream, np.full_like(bits, 64),
         np.ones(blocks, dtype=bool)),
    )
    for name, data, region, flags in cases:
        (k_rows, k_bad), plain = decode_entropy_stream(dev, data, offs, region, counts, inits, C,
                                                       samples)
        ok, _ = ce.decode_agrees(k_rows, k_bad, *plain, C)
        ok = ok and np.array_equal(k_bad.cpu().numpy(), flags)
        if not flags.any():  # valid payloads: the host coder's rows
            ok = ok and torch.equal(k_rows.cpu(), torch.from_numpy(rows))
        results.append((f"rice decode blocks (K9), {name}", ok))
    return results


def _test_pcm(samples: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 44100.0
    sig = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.normal(0, 1, samples)
    pcm = np.stack([sig, 0.9 * sig])
    return np.clip(pcm * 32767, -32768, 32767).astype(np.int32) << 16


def check_codec(device, pcm_samples: int = PCM_SAMPLES, seed: int = 0):
    """Checks 3, 3b, 4 and 4b: preset-2 encode and decode on the device
    backend, with on-card entropy (the default, and forced) and without it,
    against the host backend. Returns [(name, ok)]."""
    import sla_tpu_torch as st

    pcm = _test_pcm(pcm_samples, seed)

    def encode(backend, dev, **kw):
        enc = st.Encoder(st.EncoderConfig(backend=backend, **kw), device=dev)
        enc.set_wave_format(st.WaveFormat(2, 16, 44100))
        enc.set_encode_parameter(st.PRESETS[2])
        return enc.encode_whole(pcm)

    def decode(blob, backend, dev, **kw):
        cfg = st.DecoderConfig(backend=backend, **kw)
        return st.Decoder(cfg, device=dev).decode_whole(blob)[1]

    blob_host = encode("host", "cpu")
    blob_dev = encode("device", device)
    blob_dev_hostent = encode("device", device, device_entropy="off")
    pcm_host = decode(blob_host, "host", "cpu")
    pcm_dev = decode(blob_host, "device", device)
    saved = os.environ.get("SLA_TPU_DEVICE_ENTROPY")
    os.environ["SLA_TPU_DEVICE_ENTROPY"] = "1"
    try:
        pcm_dev_ent = decode(blob_host, "device", device)
    finally:
        if saved is None:
            del os.environ["SLA_TPU_DEVICE_ENTROPY"]
        else:
            os.environ["SLA_TPU_DEVICE_ENTROPY"] = saved
    pcm_dev_hostent = decode(blob_host, "device", device, device_entropy="off")
    return [
        (f"device-vs-host encode ({len(blob_host)} bytes)", blob_dev == blob_host),
        ("device-backend host-entropy encode", blob_dev_hostent == blob_host),
        ("device-vs-host decode", np.array_equal(pcm_dev, pcm_host)
         and np.array_equal(pcm_host, pcm)),
        ("device-entropy decode (forced on-card, and off)",
         np.array_equal(pcm_dev_ent, pcm_host) and np.array_equal(pcm_dev_hostent, pcm_host)),
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
            + check_entropy(device, max(rows // 2, 2), samples)
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
