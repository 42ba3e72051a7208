"""On-card throughput of the port's filter kernels: the twin of
tools/bench_device.py.

    python -m sla_tpu_torch.tools.bench_device

Cells, at B rows x 12,288 samples (B 256 and 2,048), p 16, T 1, M 8:

    encode_fused            K4: the whole encode cascade in one kernel
    encode_stage12          K1 then K2: the encoder's two-stage form
    decode_fused            K3: the synthesis cascade, on encode_fused's
                            residual
    decode_fused_low_pitch  K3 with pitches in 40-120 (40-200 elsewhere)

The samples and coefficients are drawn on the card from a seeded
torch.Generator; the pitches come from numpy. Each cell calls the kernel
wrappers as the pipeline does; K1-K4 read and write the (B, L) rows as they
are, so no cell times a transpose. Before timing, each batch must give
encode_fused == encode_stage12 exactly and decode_fused(encode_fused(x))
== x (every tap lies behind n at these pitches, so the cascade inverts).

Times are CUDA events over `reps` calls after `warmup` calls, reported as
ms per call and G row-samples/s. The JAX tool's roofline model holds a
TPU's constants and is not carried over; the card's name and power limit
are printed with the results instead.

`check_cells` runs on any device (the tests run it on the CPU);
`time_cells` needs a CUDA device. `main()` exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ..kernels import cuda_filters as cf
from ..params import longterm_params

L, P, T, M = 12288, 16, 1, 8
ROWS = (256, 2048)
CELLS = ("encode_fused", "encode_stage12", "decode_fused", "decode_fused_low_pitch")


def cuda_ms(fn, reps: int = 1, warmup: int = 0) -> float:
    """Mean milliseconds per call of fn() on the current stream, by CUDA
    events, after `warmup` untimed calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Batch:
    """One cell's seeded inputs on `device`: samples (B, L), PARCOR
    coefficients (B, p), and the long-term parameters of pitches drawn in
    [lo, hi)."""

    def __init__(self, device, rows: int, samples: int = L, seed: int = 0,
                 pitch_range: tuple[int, int] = (40, 200)):
        dev = torch.device(device)
        g = torch.Generator(device=dev).manual_seed(seed)

        def draw(lo, hi, shape):
            return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

        self.data = draw(-30000, 30000, (rows, samples))
        self.coef = draw(-25000, 25000, (rows, P))
        rng = np.random.default_rng(seed)
        self.pitch = rng.integers(*pitch_range, rows).astype(np.int32)
        ltm = rng.integers(-20000, 20000, (rows, T), dtype=np.int32) << 16
        self.md, self.q15 = longterm_params(self.pitch, ltm, T, dev)

    def encode_fused(self):
        return cf.fused_encode(self.data, self.coef, self.md, self.q15, M)

    def encode_stage12(self):
        return cf.stage2_predict(cf.lattice_predict(self.data, self.coef), self.md, self.q15, M)

    def decode_fused(self, residual):
        return cf.synth_cascade(residual, self.coef, self.md, self.q15, M)


def batches(device, rows: int, samples: int = L, seed: int = 0) -> dict[str, Batch]:
    """The cells' inputs: one batch for the 40-200 pitch cells, one for
    the low-pitch cell."""
    main = Batch(device, rows, samples, seed)
    low = Batch(device, rows, samples, seed + 1, pitch_range=(40, 120))
    return {"encode_fused": main, "encode_stage12": main, "decode_fused": main,
            "decode_fused_low_pitch": low}


def check_cells(device, rows: int, samples: int = L, seed: int = 0) -> list[tuple[str, bool]]:
    """encode_fused == encode_stage12 and the decode round trip, for both
    batches. Returns [(name, ok)]."""
    results = []
    bs = batches(device, rows, samples, seed)
    for tag, b in (("", bs["encode_fused"]), (" low pitch", bs["decode_fused_low_pitch"])):
        res = b.encode_fused()
        results.append((f"encode_fused == encode_stage12{tag} (B {rows})",
                        torch.equal(res, b.encode_stage12())))
        results.append((f"decode_fused(encode_fused(x)) == x{tag} (B {rows})",
                        torch.equal(b.decode_fused(res), b.data)))
    return results


def time_cells(rows: int, samples: int = L, reps: int = 20, warmup: int = 3,
               seed: int = 0) -> list[dict]:
    """Each cell's ms per call and G row-samples/s on the current CUDA
    device."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cells needs a CUDA device")
    bs = batches("cuda", rows, samples, seed)
    out = []
    for name in CELLS:
        b = bs[name]
        if name.startswith("decode"):
            res = b.encode_fused()
            fn = lambda b=b, res=res: b.decode_fused(res)  # noqa: E731
        else:
            fn = getattr(b, name)
        ms = cuda_ms(fn, reps, warmup)
        out.append({"cell": name, "rows": rows, "samples": samples, "ms": ms,
                    "g_row_samples_per_s": rows * samples / (ms * 1e-3) / 1e9})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_device: torch finds no CUDA device; run this on a machine "
              "with an NVIDIA GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(f"device={torch.cuda.get_device_name(0)} | {card}", flush=True)
    ok, rows_out = True, []
    for rows in ROWS:
        for name, good in check_cells("cuda", rows):
            ok &= good
            print(f"{name}: {'OK' if good else 'MISMATCH'}", flush=True)
        for r in time_cells(rows):
            rows_out.append(r)
            print(f"{r['cell']} (B={rows}, L={r['samples']}): {r['ms']:.3f} ms -> "
                  f"{r['g_row_samples_per_s']:.3f} G row-samples/s", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "unit": "G row-samples/s", "cells": rows_out}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
