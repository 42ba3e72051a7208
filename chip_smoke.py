"""Smoke run of sla_tpu_torch on one NVIDIA GPU: the port's encode/decode
path and its known-parameter path at a real size, through the nine
hand-written CUDA kernels (K1-K7, the filters; K8 and K9, the entropy
coder).

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. environment: the card, its clocks, torch and CUDA versions, and the
   builds started together: the kernels' nvcc build (csrc/filters.cu and
   csrc/entropy.cu from this checkout, one nvcc command), the port's
   native host library (sla_tpu_torch/native, g++) and, where build/parent/sla_tpu_torch/ holds the previous commit's
   package (git archive <commit> sla_tpu_torch | tar -x -C build/parent),
   its kernels, through its own build.py, for the before/after times of
   phase 2; the sanitized native library of phase 7 starts building too,
   in a process of its own, and builds on in the background;
2. kernels: K1-K7 against their plain PyTorch versions on the card, exact,
   at the main path's shape (2,048 rows x 12,288 samples, p 16, T 1, M 8)
   and at p 32, T 3, M 8, L 16,384; kernel and plain times by CUDA events,
   each kernel's bound (int32 operations or bytes, whichever takes longer
   at the card's peak), and the fused encode (K4) against K1 + K2; K5, K6
   and K7 also timed raw (ctypes, without the wrappers' checks), and K7
   again, exact too, on rows whose lags are all 32 or more; every kernel's
   ptxas resources and the shared memory of K2-K4, K6 and K7, and K1-K7's
   times beside the previous commit's kernels on the same inputs
   (previous, new, new, previous, each the median of three such
   sequences), each called through its own commit's
   wrappers, when that package was unpacked (K1-K7 unchanged: each must
   read 1.00 within 3 %); then K8 and K9 against their plain versions at
   the same 2,048 rows x 12,288 (1,024 stereo blocks, residual scales
   spread over 2^12, INT32 extremes for gamma escapes; K9 on the host
   coder's payloads at every bit alignment), exact, timed, each bound from
   the symbols' paths through the bodies; the new schedules' chains alone:
   K9 at 1 block (one warp) and 32, K8's chain pass (raw, emit 0) at one
   warp's blocks and all, its emit pass alone, in cycles a symbol or a step
   at the SM clock read under load; K8 and K9 at the preset-4 clip's block
   shape (384 stereo blocks x 16,384; K8's payloads decoded back by K9 and
   K9 on the host coder's stream, both equal to the residuals); and at both
   shapes beside the previous commit's K8 and K9 when it has them;
3. slice: five minutes of seeded CD stereo (44.1 kHz, 16 bit) at preset 2
   through Encoder/Decoder(backend='device', device='cuda'), entropy on the
   card by default (K8, K9) — the stream must equal backend='host' byte for
   byte and decode to the exact PCM — with K1-K3's, K8's and K9's launch
   counts above 0; the same with device_entropy='off' (before/after in one
   call); the number of static-Golomb blocks (host coder); the entropy
   stage split into kernel, copies and framing; one torch.profiler trace of
   one encode and one decode (top five device operations, the device's
   idle share); then one minute of 96 kHz / 24-bit stereo at preset 4,
   checked the same way;
4. known parameters: the bench twin's cells (checked, then timed) at 256
   and 2,048 rows, the verify twin's checks (the entropy kernels and the
   codec with on-card entropy on and off among them), and entry()'s forward
   step against the plain encode chain, with all seven filter launch counts
   above 0;
5. entry points, on the card at preset 2, each part with the launch counts
   set to 0 and its kernels required: (a) the CLI on phase 3's clip as a
   WAV: `-e -V` writes phase 3's device stream (K1, K2, K8; K3, K9 for the
   verify), `-d` (K3, K9), `-d -s` and `-d -w` give the exact PCM, and one
   `python -m sla_tpu_torch -e` subprocess writes the same bytes; (b)
   corpus mode, eight seeded WAVs (stereo 60, 45, 40, 35, 30, 25 s, mono 30
   and 20 s: 22.9M row-samples, over the 16M 'auto' threshold) in one
   `-e -b -f 8` batch (K1, K2, K8), each .sla equal to the host backend's,
   and `-d -b` back to the exact PCM (K3, K9; each file is under the
   threshold alone, so SLA_TPU_DEVICE_THRESHOLD sends it to the card);
   (c) optimize_encode(effort=1) on 30 s, the card's result equal to the
   CPU's; (d) SLA_TPU_DEBUG_ASSERTS=1: a 30-s device round trip through the
   checked plain versions on CUDA tensors (no filter kernel) writes the
   unchecked stream and decodes exactly, and a seeded LMS overflow on CUDA
   tensors raises. One line of wall times beside the card's name and limit;
6. mesh (sla_tpu_torch.parallel), each part with its kernels required:
   the card count and the 'auto' rule ('device' on one card, 'mesh' on
   more); phase 3's clip through Encoder/Decoder(backend='mesh') on the
   mesh of every card (K1, K2, K8; K3, K9) and on four shards (all on the
   card of a one-card machine) with SLA_TPU_MESH_CHANNELS=2 (blocks 2 x
   channels 2), K1 launched once a shard and chunk, each stream
   equal to phase 3's and decoded exactly; entry.dryrun_multichip(4) on the
   card (K4). Phase 3's trace also gives the device-to-host copy time with
   fetch_int32 beside a trace with the previous commit's int32 fetch. One
   line of wall times beside the card's name and limit.
7. tools (sla_tpu_torch/tools/), each in a process of its own with its
   kernels required from its JSON line (a CUDA fault poisons only its own
   context): side by side, fuzz_device_entropy 100 (K1, K2, K8, K3, K9),
   fuzz_corruption 200 --backend device (the same), fuzz_salvage 50 and
   fuzz_streaming 50 and 20 --seek (K3, K9), each case's card outcome equal
   to the host backend's; run_sanitized fuzz_corruption 50 on the card
   under ASan + UBSan (its native library built from phase 1 on, in the
   background; its build time on a line of its own), unless g++ finds no
   libasan; then one at a time profile_decode (K3, K9), measure_streaming
   (K1, K2, K8, K3, K9), measure_multiproc 8 2 (K1, K2, K8, serial and in
   the workers) and bench_synth_micro (host), their numbers beside the
   card's name and limit. Each tool's whole output goes to
   chiprun_out/tools/.
8. threshold and benchmark: the 'auto' device threshold swept on the
   card, bench.make_signal at 5, 15, 30, 60, 120, 180 and 300 s (0.44M to
   26.5M row-samples) encoded and decoded on backend='host' and on
   backend='device', best of 3 after a warm call, each device stream equal
   to the host's, every decode exact, the device rows launching K1, K2,
   K8, K3 and K9 and the host rows none; one line a size beside the
   card's name and limit, then the threshold the sweep gives for encode
   and for decode (pipeline.DEFAULT_DEVICE_THRESHOLD is set by it) and
   the largest size's stages; then the benchmark twin
   (sla_tpu_torch.bench, bench.py's metric) in this process under 'auto'
   as it stands and forced onto the card with SLA_TPU_DEVICE_THRESHOLD=0
   (K1, K2, K8, K3, K9 required), and once as
   `python -m sla_tpu_torch.bench`, each last line bench.py's four keys.

The last lines are the kernels' JSON record, the card's name and power
limit as nvidia-smi reports them, and the result. Imports neither jax nor
sla_tpu.
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sla_tpu_torch.tools.bench_device import card_line, cuda_ms  # noqa: E402

PALLAS = "sla_tpu/kernels/pallas_filters.py"
RICE = "sla_tpu/rice_device.py"
KERNELS = {  # wrapper name -> (the TPU function it replaces, file:line)
    "lattice_predict": f"{PALLAS}:1700",  # lattice_filter_tl(synthesize=False)
    "stage2_predict": f"{PALLAS}:839",  # fused_stage2_tl
    "synth_cascade": f"{PALLAS}:1574",  # fused_synth_tl
    "fused_encode": f"{PALLAS}:793",  # fused_encode_tl
    "lattice_synth": f"{PALLAS}:1700",  # lattice_filter_tl(synthesize=True)
    "lms_synth": f"{PALLAS}:1735",  # lms_filter_tl(synthesize=True)
    "longterm_synth": f"{PALLAS}:412",  # longterm_synth_tl
    # rice_encode_parts and rice_decode_blocks: lax.scans under XLA, not
    # Pallas kernels (K8 also does the host pack, native sla_pack_parts)
    "rice_encode_blocks": f"{RICE}:77",
    "rice_decode_blocks": f"{RICE}:145",
}
SLICE_KERNELS = ("lattice_predict", "stage2_predict", "synth_cascade")  # phase 3's path
ENTROPY_KERNELS = ("rice_encode_blocks", "rice_decode_blocks")  # phase 3's too
SOURCES = {name: ("sla_tpu_torch/csrc/entropy.cu" if name in ENTROPY_KERNELS
                  else "sla_tpu_torch/csrc/filters.cu") for name in KERNELS}
ROOT = pathlib.Path(__file__).resolve().parent
# the previous commit's sla_tpu_torch/, unpacked there (gitignored) for the
# before/after times (git archive <commit> sla_tpu_torch | tar -x -C
# build/parent); a plain checkout has none and skips that comparison
PARENT = ROOT / "build" / "parent"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak bandwidth
# int32 operations an SM can issue per clock: four schedulers, one 32-lane
# instruction each. The CUDA guide's 64 a clock is per class of integer
# instruction; IMAD issues to the FMA pipe beside IADD3/SHF/LOP3 on the
# integer pipe, and K1 ran at 125 % of a 64-lane bound on the H100.
INT32_LANES_PER_SM = 128


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# -- phase 1 -----------------------------------------------------------------


def clocks() -> tuple[float, float]:
    """(current, maximum) SM clock in MHz, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cur, top = (float(v) for v in out.split(","))
    return cur, top


def load_parent(root: pathlib.Path = PARENT, name: str = "sla_tpu_torch_previous"):
    """The previous commit's `kernels.cuda_filters`, imported from
    `root`/sla_tpu_torch/ (an archive of that commit's package) as the
    package `name`, or None when the archive is not there. Its top-level
    __init__ does not run, its relative imports resolve inside the archive,
    and its build.py builds its own csrc/ with its own C signatures into
    `root`/build/sla_tpu_torch/; its wrappers make their own layouts. The
    port's own `sla_tpu_torch` in sys.modules stays as it is."""
    pkg_dir = root / "sla_tpu_torch"
    if not (pkg_dir / "kernels" / "cuda_filters.py").exists():
        return None
    if name not in sys.modules:
        pkg = types.ModuleType(name)
        pkg.__path__ = [str(pkg_dir)]
        sys.modules[name] = pkg
    return importlib.import_module(f"{name}.kernels.cuda_filters")


def parent_library():
    """The previous kernels' wrappers with their library built, or None."""
    prev = load_parent()
    if prev is not None:
        prev.cuda_library()
    return prev


def phase_environment() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA device")
    from sla_tpu_torch import native
    from sla_tpu_torch.kernels import build

    card = card_line()
    clock, clock_max = clocks()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    sanitized = start_sanitized_build()  # phase 7's; it runs on in the background
    try:
        with ThreadPoolExecutor(2) as pool:  # the three builds at once
            parent = pool.submit(parent_library)
            nat = pool.submit(native.available)
            build.cuda_library()
            nvcc_done = time.perf_counter() - t0
            if not nat.result():
                raise RuntimeError("the port's native host library did not build "
                                   "(g++ -O3, sla_tpu_torch/native/sla_native.cpp)")
            parent_lib = parent.result()
    except BaseException:
        if sanitized is not None:
            stop(sanitized)
        raise
    builds_s = time.perf_counter() - t0
    if parent_lib is not None:
        prev_build = importlib.import_module(f"{parent_lib.__package__}.build")
        parent_note = ("kernels (build/parent/sla_tpu_torch, through their own wrappers) nvcc "
                       f"{prev_build.build_seconds.get('sla_filters_cuda', 0.0):.1f} s")
    else:
        parent_note = "kernels' package absent: no before/after times"
    ptxas = [ln.strip() for ln in build.build_log().splitlines() if "registers" in ln]
    log("env", f"{card} | {torch.cuda.get_device_name(0)}, {sms} SMs, clocks.sm {clock:.0f} MHz "
        f"(max {clock_max:.0f}) | torch {torch.__version__} cuda {torch.version.cuda}")
    log("env", f"builds {builds_s:.1f} s together: nvcc {build.build_seconds.get('sla_filters_cuda', 0.0):.1f} s "
        f"(loaded after {nvcc_done:.1f} s); native host library sla_tpu_torch/native/sla_native.cpp "
        f"-> build/sla_tpu_torch/, g++ {build.build_seconds.get('sla_native', 0.0):.1f} s; previous "
        + parent_note + ("; the sanitized native library (phase 7) builds on in the "
                         "background" if sanitized else "; g++ finds no libasan.so"))
    for ln in ptxas:
        log("env", f"ptxas {ln}")
    peak = INT32_LANES_PER_SM * sms * clock_max * 1e6
    log("env", f"int32 peak {peak / 1e12:.2f} T ops/s = {INT32_LANES_PER_SM} lanes x {sms} SMs x "
        f"{clock_max:.0f} MHz (clocks.max.sm); HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    return {"card": card, "int32_per_s": peak, "parent": parent_lib,
            "sanitized_build": sanitized, "t_start": t0}


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
    ms = cuda_ms(kern, reps, warmup=2)  # the clocks ramp back up after the plain version
    return err, ms, plain_ms


def work(name: str, B: int, L: int, p: int, T: int, M: int, md: np.ndarray):
    """(int32 operations, bytes) that `name` needs on these inputs, counted
    from the bodies in csrc/filters.cuh: per row-sample 8 per lattice stage
    (two Q15 products, two subtractions), 3 for pre- or de-emphasis,
    12 M + 10 for the LMS (2M products and adds, 2M sign-products and adds
    for the update, the step), and 4 T + 5 for the long-term stage, counted
    only where it is active (n >= md > 0); bytes read the input and the
    parameters once and write the output once."""
    rows = B * L
    lt_samples = int(np.maximum(L - md[md > 0].astype(np.int64), 0).sum())
    lat, lms, lt = 8 * p + 3, 12 * M + 10 if M else 0, (4 * T + 5) * lt_samples
    ops = {
        "lattice_predict": rows * lat, "lattice_synth": rows * lat,
        "stage2_predict": rows * lms + lt, "lms_synth": rows * lms,
        "synth_cascade": rows * (lms + lat) + lt, "fused_encode": rows * (lat + lms) + lt,
        "longterm_synth": lt,
    }[name]
    params = {"lattice_predict": p, "lattice_synth": p, "lms_synth": 0,
              "longterm_synth": 1 + T, "stage2_predict": 1 + T}.get(name, p + 1 + T)
    return ops, 4 * (2 * rows + B * params)


def bound(name, B, L, p, T, M, md, int32_per_s) -> tuple[float, str]:
    ops, nbytes = work(name, B, L, p, T, M, md)
    t_ops, t_bytes = ops / int32_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pipe_resources(lib) -> None:
    """Every kernel's ptxas registers, stack and spills per instantiation
    (K8's chain and emit passes apart), the pipelines' (K2-K4, K6) dynamic
    shared memory per block and K5's and K7's static rings."""
    from sla_tpu_torch.kernels import build

    names = ("lattice_predict|stage2_predict|synth_cascade|fused_encode|lattice_synth|"
             "lms_synth|longterm_synth|rice_chain|rice_emit|rice_decode")
    current = None
    for ln in build.build_log().splitlines():
        m = re.search(rf"Compiling entry function '\S*?({names})_kernelI(\w*?)EEv", ln)
        if m:
            args = [("true" if v == "1" else "false") if kind == "b" else v
                    for kind, v in re.findall(r"L([ib])(\d+)E", m.group(2) + "E")]
            current = f"{m.group(1)}<{','.join(args)}>"
        elif "Compiling entry function" in ln:
            current = None
        elif current and ("spill" in ln or "registers" in ln):
            log("kernels", f"ptxas {current}: {ln.strip()}")
    log("kernels", f"dynamic shared memory per block: stage2_predict {lib.sla_pipe_shared_bytes(2)} B, "
        f"synth_cascade {lib.sla_pipe_shared_bytes(3)} B, "
        f"fused_encode {lib.sla_pipe_shared_bytes(4)} B, "
        f"lms_synth {lib.sla_pipe_shared_bytes(6)} B; static: lattice_synth "
        f"{lib.sla_pipe_shared_bytes(5)} B up to p 32 (one warp's rings), longterm_synth "
        f"{lib.sla_pipe_shared_bytes(7)} B (four rows' rings)")


def ctypes_call(lib, fn, data, *args):
    """fn of `lib` on the (B, L) rows `data` through ctypes alone, without
    the wrappers' argument checks."""
    y = torch.empty_like(data)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(lib, fn)(data.data_ptr(), y.data_ptr(), *ptrs,
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fn}: cudaError {err}")
    return y


# the kernels whose code this commit did not change: their ratio must read
# 1.00 within 3 %
UNCHANGED = ("lattice_predict", "stage2_predict", "synth_cascade", "fused_encode",
             "lattice_synth", "lms_synth", "longterm_synth")


def kernel_calls(cf, x, coef, md, q15, r1, M) -> dict:
    """Each of K1-K7 of the wrapper module `cf` on these inputs, by name,
    through the public wrapper signatures (stable since K4-K7 came)."""
    return {
        "lattice_predict": lambda: cf.lattice_predict(x, coef),
        "stage2_predict": lambda: cf.stage2_predict(r1, md, q15, M),
        "synth_cascade": lambda: cf.synth_cascade(x, coef, md, q15, M),
        "fused_encode": lambda: cf.fused_encode(x, coef, md, q15, M),
        "lattice_synth": lambda: cf.lattice_synth(x, coef),
        "lms_synth": lambda: cf.lms_synth(x, M),
        "longterm_synth": lambda: cf.longterm_synth(x, md, q15),
    }


def four_times(prev, new, reps: int, rounds: int = 3) -> list[float]:
    """Milliseconds a call of the previous and the new kernel in the order
    previous, new, new, previous, each position the median of `rounds`
    such sequences: the wrappers of K2-K4 and K7 sync with the host, whose
    cores the card's machine shares, so one sequence can catch a stall."""
    runs = [[cuda_ms(f, reps, warmup=1) for f in (prev, new, new, prev)] for _ in range(rounds)]
    return [float(np.median(col)) for col in zip(*runs)]


def parent_times(parent, x, coef, md, q15, r1, M, reps: int = 5) -> dict:
    """The previous K1-K7 against the new ones on the same inputs, in the
    order previous, new, new, previous; both must give the same rows. Both
    are called through their own commit's wrappers, which make whatever
    layout their kernels take (the previous K5's two transposes included)."""
    from sla_tpu_torch.kernels import cuda_filters as cf

    prev_calls = kernel_calls(parent, x, coef, md, q15, r1, M)
    new_calls = kernel_calls(cf, x, coef, md, q15, r1, M)
    out = {}
    for name in new_calls:
        prev, new = prev_calls[name], new_calls[name]
        if not torch.equal(prev(), new()):
            raise AssertionError(f"{name}: the previous and the new kernel differ")
        t = four_times(prev, new, reps)
        ratio = (t[0] + t[3]) / (t[1] + t[2])
        out[name] = t
        note = ""
        if name in UNCHANGED:
            note = " unchanged code, " + ("within 3 %" if abs(ratio - 1) <= 0.03 else "OUTSIDE 3 %")
        log("kernels", f"{name} previous / new / new / previous: "
            + " / ".join(f"{v:.3f}" for v in t) + f" ms (x{ratio:.2f}{note})")
    return out


def long_lag_inputs(seed: int, B: int, L: int, T: int):
    """Rows whose smallest live lag md - T + 1 is 32 or more (pitches
    32 + T//2 .. 256, none 0): every K7 step holds 32 samples or more."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-(1 << 20), 1 << 20, (B, L), dtype=np.int32)
    pitch = rng.integers(32 + T // 2, 257, B)
    md = (pitch + T // 2).astype(np.int32)
    q15 = rng.integers(-32768, 32768, (B, T), dtype=np.int32)
    dev = torch.device("cuda")
    return [torch.from_numpy(a).to(dev) for a in (x, md, q15)]


def phase_kernels(env: dict) -> dict:
    from sla_tpu_torch.kernels import build, cuda_filters as cf

    pipe_resources(build.cuda_library())
    results = {}
    for B, L, p, T, M in ((2048, 12288, 16, 1, 8), (2048, 16384, 32, 3, 8)):
        x, coef, md, q15 = kernel_inputs(B + L + p, B, L, p, T)
        md_np = md.cpu().numpy()
        r1 = cf.lattice_predict_plain(x, coef)
        kernels = kernel_calls(cf, x, coef, md, q15, r1, M)
        plains = {
            "lattice_predict": lambda: cf.lattice_predict_plain(x, coef),
            "stage2_predict": lambda: cf.stage2_predict_plain(r1, md, q15, M),
            "synth_cascade": lambda: cf.synth_cascade_plain(x, coef, md, q15, M),
            "fused_encode": lambda: cf.fused_encode_plain(x, coef, md, q15, M),
            "lattice_synth": lambda: cf.lattice_synth_plain(x, coef),
            "lms_synth": lambda: cf.lms_synth_plain(x, M),
            "longterm_synth": lambda: cf.longterm_synth_plain(x, md, q15),
        }
        shape = {}
        for name, kern in kernels.items():
            err, ms, plain_ms = check_kernel(name, kern, plains[name], reps=10)
            bound_ms, bound_by = bound(name, B, L, p, T, M, md_np, env["int32_per_s"])
            shape[name] = ms
            log("kernels", f"{name} B {B} L {L} p {p} T {T} M {M}: exact, kernel "
                f"{ms:.3f} ms, plain {plain_ms:.1f} ms (x{plain_ms / ms:.0f}), bound "
                f"{bound_ms:.3f} ms ({bound_by}; {100 * bound_ms / ms:.1f} % of it reached)")
            if (B, L) == (2048, 12288):  # the main path's shape: the record
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 "library_ms": None}
            else:
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        staged = shape["lattice_predict"] + shape["stage2_predict"]
        log("kernels", f"B {B} L {L}: fused_encode {shape['fused_encode']:.3f} ms against "
            f"lattice_predict + stage2_predict {staged:.3f} ms")
        lib = build.cuda_library()
        raw = {"lattice_synth": lambda: ctypes_call(lib, "sla_lattice_synth", x, coef, B, L, p, 1),
               "lms_synth": lambda: ctypes_call(lib, "sla_lms_synth", x, B, L, M),
               "longterm_synth": lambda: ctypes_call(lib, "sla_longterm_synth", x, md, q15, B, L, T)}
        for name, fn in raw.items():
            log("kernels", f"{name} B {B} L {L} raw (ctypes): {cuda_ms(fn, 10, warmup=2):.3f} ms "
                f"against {shape[name]:.3f} through the wrapper")
        xl, mdl, ql = long_lag_inputs(B + L + T + 1, B, L, T)
        err, ms, plain_ms = check_kernel(
            "longterm_synth (lags >= 32)", lambda: cf.longterm_synth(xl, mdl, ql),
            lambda: cf.longterm_synth_plain(xl, mdl, ql), reps=10)
        raw_ms = cuda_ms(lambda: ctypes_call(lib, "sla_longterm_synth", xl, mdl, ql, B, L, T), 10,
                         warmup=2)
        bound_ms, bound_by = bound("longterm_synth", B, L, p, T, M, mdl.cpu().numpy(),
                                   env["int32_per_s"])
        results["longterm_synth"]["max_abs_err"] = max(results["longterm_synth"]["max_abs_err"], err)
        log("kernels", f"longterm_synth B {B} L {L} T {T}, every lag >= 32: exact, kernel "
            f"{ms:.3f} ms, raw (ctypes) {raw_ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}; {100 * bound_ms / raw_ms:.1f} % of it reached raw)")
        if env["parent"] is not None:
            parent_times(env["parent"], x, coef, md, q15, r1, M)
    return results


# int32 operations of one symbol on each path it can take, counted from the
# bodies in csrc/entropy.cuh (a 64-bit add, or, shift or widening multiply
# counts 2; loads, stores and loop control are not counted), and of one
# 32-bit word of payload written (K8) or read (K9). K8 is one encode of the
# symbol: its parameters, its code and its placement, each value once; the
# chain pass's length sum, its branch-free stage-1 update of stage-0
# symbols and the emit pass's second zigzag and record unpacking are this
# design's cost of splitting the chain from the bits, not the function's.
#   K8, every symbol: zigzag 3; stage 0's rice_bits 7 (shr, add, shr, sub,
#     clz, sub, and); k0 1; param_update 7 (shl, mul, add, the widening
#     multiply-add 2, 64-bit shr 2); the u < k0 test 1; the placement 15
#     (the length's share of the scan 3, the position 2, or_code's word,
#     offset, end and test 4, its 64-bit shift 2, two ORs 2, the tail's
#     start 2). Stage 0: + the tail and length 2 = 36. Stage 1: + its
#     rice_bits 7, u - k0 and param_update 8, q, the remainder's mask and
#     the q test 5, the length and tail 5 = 59. Escape: stage 1 less its
#     length and tail, + gamma and ndigit 3, the length 5, the 64-bit tail
#     10, a third ORed word 3 = 75. A word written: 2 (bswap, index).
#   K9, every symbol: both rice_bits 14; the window 8 (word index 2, offset,
#     two funnel shifts 2, top's clz and sub 2, the run's test); the
#     remainder 7 (kb's select, the end 2, the shift count, a funnel shift,
#     top_bits 2); the path's tests 2 (a run under 16, the limit); the
#     value's unzigzag 4. Stage 0: + the value's select 1, param_update 7 =
#     43. Stage 1: + k0 and the value 5, the stage-1 update with its sub and
#     select 9 = 57. Escape: stage 1 less the remainder's 7, + three ring
#     windows 15, clz and the gz test 2, the positions 4, the quotient 3, two
#     top_bits 4, the end and the limit test 2 = 80. A word read: 8 (the
#     staged word's 64-bit index 2 and clamp 4, its bswap, the ring slot).
ENTROPY_OPS = {
    "rice_encode_blocks": {"stage0": 36, "stage1": 59, "escape": 75, "word": 2},
    "rice_decode_blocks": {"stage0": 43, "stage1": 57, "escape": 80, "word": 8},
}


def symbol_paths(rows: torch.Tensor, counts: torch.Tensor, inits: torch.Tensor, C: int):
    """(stage 0 only, stage 1, escape) symbol counts of the blocks whose
    channels are consecutive rows of `rows`, from the plain parts scan: a
    unary part of one bit is stage 0, a gamma part an escape."""
    from sla_tpu_torch import rice_device

    lengths = rice_device.encode_parts64(rows, inits.reshape(-1))[1]
    idx = torch.arange(rows.shape[1], device=rows.device)[:, None]
    valid = idx < counts.repeat_interleave(C)[None, :]
    n = int(valid.sum())
    n0 = int((valid & (lengths[..., 0] == 1)).sum())
    ne = int((valid & (lengths[..., 2] > 0)).sum())
    return n0, n - n0 - ne, ne


def entropy_bound(name: str, paths, words: int, moved_bytes: int, int32_per_s: float):
    """(bound ms, 'bytes' or 'operations', operations): `paths` the symbols
    on stage 0, stage 1 and the escape, `words` the payload's 32-bit words,
    `moved_bytes` each residual (4 B a symbol) and payload byte once."""
    c = ENTROPY_OPS[name]
    ops = sum(n * c[k] for k, n in zip(("stage0", "stage1", "escape"), paths)) + c["word"] * words
    t_ops = ops / int32_per_s * 1e3
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations", ops) if t_ops >= t_bytes else (t_bytes, "bytes", ops)


def sm_clock_under(launch, n: int) -> float:
    """The SM clock (MHz) nvidia-smi reads while `n` queued calls of
    `launch` (which must not sync) run."""
    torch.cuda.synchronize()
    for _ in range(n):
        launch()
    clock = clocks()[0]
    torch.cuda.synchronize()
    return clock


def parent_entropy(parent):
    """The previous commit's kernels.cuda_entropy beside its cuda_filters
    (`parent`), or None when that commit has no entropy kernels."""
    if parent is None or not (PARENT / "sla_tpu_torch" / "kernels" / "cuda_entropy.py").exists():
        return None
    return importlib.import_module(f"{parent.__package__}.cuda_entropy")


def previous_vs_new(name: str, prev, new, same, reps: int = 3) -> None:
    """The previous and the new kernel on the same inputs: the same result,
    then times in the order previous, new, new, previous (four_times)."""
    if not same(prev(), new()):
        raise AssertionError(f"{name}: the previous and the new kernel differ")
    t = four_times(prev, new, reps)
    log("kernels", f"{name} previous / new / new / previous: "
        + " / ".join(f"{v:.3f}" for v in t) + f" ms (x{(t[0] + t[3]) / (t[1] + t[2]):.2f})")


def phase_entropy(env: dict) -> dict:
    """K8 and K9 against their plain versions at the main path's shape,
    exact, and timed."""
    from sla_tpu_torch import rice_device
    from sla_tpu_torch.kernels import cuda_entropy as ce
    from sla_tpu_torch.tools import verify_device as vd

    B, C, L = 1024, 2, 12288  # 2,048 rows x 12,288
    t0 = time.perf_counter()
    rows, counts, inits = vd.entropy_blocks(2026, B, C, L, 3000.0, spread=6.0)
    stream, offs, bits = vd.entropy_stream(2027, rows, counts, inits, C)
    dev = torch.device("cuda")
    x = torch.from_numpy(rows).to(dev)
    row0 = torch.arange(0, B * C, C, dtype=torch.int32, device=dev)
    cnt = torch.from_numpy(counts).to(dev)
    ini = torch.from_numpy(inits.astype(np.int64)).to(dev)
    symbols = int(counts.sum()) * C
    log("kernels", f"entropy inputs: {B} stereo blocks x {L} ({symbols} symbols; block scales "
        f"3000 x 2^[-6, 6], INT32 extremes), the host coder's {len(stream)}-byte stream at "
        f"every bit alignment, made in {time.perf_counter() - t0:.1f} s")
    results = {}

    k8 = lambda: ce.rice_encode_blocks(x, row0, cnt, ini, C)  # noqa: E731
    got = k8()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ce.rice_encode_blocks_plain(x, row0, cnt, ini, C)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("rice_encode_blocks: K8 differs from its plain version")
    payload_bytes = int(got[2].sum())
    paths = symbol_paths(x, cnt, ini, C)
    if sum(paths) != symbols:
        raise AssertionError(f"entropy paths {paths} do not add up to {symbols} symbols")
    log("kernels", f"entropy symbol paths: stage 0 {paths[0]}, stage 1 {paths[1]}, gamma escape "
        f"{paths[2]}")
    ms = cuda_ms(k8, 5, warmup=2)  # the clocks ramp back up after the plain version
    bound_ms, bound_by, ops = entropy_bound("rice_encode_blocks", paths, payload_bytes // 4,
                                            4 * symbols + payload_bytes, env["int32_per_s"])
    results["rice_encode_blocks"] = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": bound_ms, "bound_by": bound_by,
                                     "library_ms": None}
    log("kernels", f"rice_encode_blocks B {B} C {C} L {L}: exact ({payload_bytes} payload bytes), "
        f"kernel {ms:.3f} ms (count + emit + the sizes' copy), plain {plain_ms:.1f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}; {ops / 1e9:.2f} G ops, {ops / symbols:.1f} a symbol, "
        f"one pass; {(4 * symbols + payload_bytes) / 1e6:.1f} MB; "
        f"{100 * bound_ms / ms:.1f} % of it reached)")

    words = rice_device.upload_stream(stream, dev)
    W = rice_device.window_width(offs, bits)
    o = torch.from_numpy(offs).to(dev)
    k9 = lambda: ce.rice_decode_blocks(words, o, W, cnt, ini, C, L)  # noqa: E731
    k_rows, k_bad = k9()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_rows, p_bad = ce.rice_decode_blocks_plain(words, o, W, cnt, ini, C, L)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ok, err = ce.decode_agrees(k_rows, k_bad, p_rows, p_bad, C)
    if not ok or bool(k_bad.any()) or not torch.equal(k_rows, x):
        raise AssertionError(f"rice_decode_blocks: K9 differs from its plain version or the host "
                             f"coder (max |err| {err}, {int(k_bad.sum())} blocks flagged)")
    ms = cuda_ms(k9, 5, warmup=2)
    bound_ms, bound_by, ops = entropy_bound("rice_decode_blocks", paths, len(stream) // 4,
                                            4 * symbols + len(stream), env["int32_per_s"])
    results["rice_decode_blocks"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": bound_ms, "bound_by": bound_by,
                                     "library_ms": None}
    log("kernels", f"rice_decode_blocks B {B} C {C} L {L}: exact, no block flagged, rows equal "
        f"the host coder's input, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
        f"{bound_ms:.3f} ms ({bound_by}; {ops / 1e9:.2f} G ops, {ops / symbols:.1f} a symbol; "
        f"{(4 * symbols + len(stream)) / 1e6:.1f} MB; {100 * bound_ms / ms:.1f} % of it reached)")
    entropy_lanes(ce, x, row0, cnt, ini, C, L, words, o, W)
    prev = parent_entropy(env["parent"])
    if prev is not None:
        previous_vs_new("rice_encode_blocks",
                        lambda: prev.rice_encode_blocks(x, row0, cnt, ini, C), k8,
                        lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b)))
        previous_vs_new("rice_decode_blocks",
                        lambda: prev.rice_decode_blocks(words, o, W, cnt, ini, C, L), k9,
                        lambda a, b: ce.decode_agrees(*a, *b, C)[0])
    entropy_preset4_shape(ce, prev)
    return results


def entropy_lanes(ce, x, row0, cnt, ini, C: int, L: int, words, o, W: int) -> None:
    """The new schedules' chains alone, raw (ctypes, no wrapper checks): K9
    at 1 block (one warp on the card), 32 and all, in cycles a symbol of a
    block; K8's chain pass (emit 0) at one chain warp's blocks and at all,
    in cycles a step of a row, and its emit pass alone; all at the SM clock
    nvidia-smi reads while K9 runs on every block."""
    lib = ce.cuda_library()
    B, dev = cnt.shape[0], x.device
    sizes = torch.empty((B,), dtype=torch.int64, device=dev)
    recs = torch.empty((B * L * C,), dtype=torch.int16, device=dev)
    rows = torch.empty((B * C, L), dtype=torch.int32, device=dev)
    bad = torch.empty((B,), dtype=torch.uint8, device=dev)

    def check(err, fn):
        if err:
            raise RuntimeError(f"{fn}: cudaError {err}")

    def encode(k, emit, offsets=None, payload=None):
        check(lib.sla_rice_encode_blocks(
            x.data_ptr(), L, row0.data_ptr(), cnt.data_ptr(), ini.data_ptr(), k, C,
            offsets.data_ptr() if emit else None, payload.data_ptr() if emit else None,
            sizes.data_ptr(), recs.data_ptr(), emit, torch.cuda.current_stream().cuda_stream),
            "sla_rice_encode_blocks")

    def decode(k):
        check(lib.sla_rice_decode_blocks(
            words.data_ptr(), words.numel() // 4, o.data_ptr(), W, cnt.data_ptr(), ini.data_ptr(),
            k, C, L, rows.data_ptr(), bad.data_ptr(), torch.cuda.current_stream().cuda_stream),
            "sla_rice_decode_blocks")

    decode_ms = cuda_ms(lambda: decode(B), 5, warmup=1)
    mhz = sm_clock_under(lambda: decode(B), max(1, int(1500 / max(decode_ms, 0.1))))
    cells = []
    for k in (1, 32, B):
        ms = cuda_ms(lambda: decode(k), 5, warmup=1)
        per = ms * 1e-3 * mhz * 1e6 / (int(cnt[:k].max()) * C)
        cells.append(f"K9 {k} blocks {ms:.3f} ms ({per:.1f} cycles a symbol)")
    for k in (32 // C, B):
        ms = cuda_ms(lambda: encode(k, 0), 5, warmup=1)
        per = ms * 1e-3 * mhz * 1e6 / int(cnt[:k].max())
        cells.append(f"K8 chain pass {k} blocks {ms:.3f} ms ({per:.1f} cycles a step)")
    encode(B, 0)
    padded = (sizes + 3) & ~3
    offsets = torch.cumsum(padded, 0) - padded
    payload = torch.empty((max(int(padded.sum()), 4),), dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: encode(B, 1, offsets, payload), 5, warmup=1)
    cells.append(f"K8 emit pass {B} blocks {ms:.3f} ms")
    log("kernels", f"entropy chains at clocks.sm {mhz:.0f} MHz under K9 on {B} blocks: "
        + "; ".join(cells))


def entropy_preset4_shape(ce, prev) -> None:
    """K8 and K9 at the preset-4 clip's block shape, 384 stereo blocks x
    16,384: K8's payloads decoded back by K9 and K9 on the host coder's
    stream both give the residuals, unflagged; timed, and beside the
    previous commit's kernels when it has them."""
    from sla_tpu_torch import rice_device
    from sla_tpu_torch.tools import verify_device as vd

    B, C, L = 384, 2, 16384
    rows, counts, inits = vd.entropy_blocks(2028, B, C, L, 3000.0, spread=6.0)
    stream, offs, bits = vd.entropy_stream(2029, rows, counts, inits, C)
    dev = torch.device("cuda")
    x = torch.from_numpy(rows).to(dev)
    row0 = torch.arange(0, B * C, C, dtype=torch.int32, device=dev)
    cnt = torch.from_numpy(counts).to(dev)
    ini = torch.from_numpy(inits.astype(np.int64)).to(dev)
    k8 = lambda: ce.rice_encode_blocks(x, row0, cnt, ini, C)  # noqa: E731
    payload, offsets, sizes = k8()
    padded = ((sizes + 3) & ~3).cpu().numpy()
    back = torch.cat([payload, torch.zeros((16,), dtype=torch.uint8, device=dev)])
    starts = offsets * 8
    r8, bad8 = ce.rice_decode_blocks(back, starts, rice_device.window_width(
        starts.cpu().numpy(), 8 * padded), cnt, ini, C, L)
    words = rice_device.upload_stream(stream, dev)
    o = torch.from_numpy(offs).to(dev)
    W = rice_device.window_width(offs, bits)
    k9 = lambda: ce.rice_decode_blocks(words, o, W, cnt, ini, C, L)  # noqa: E731
    r9, bad9 = k9()
    torch.cuda.synchronize()
    if bool(bad8.any()) or bool(bad9.any()) or not torch.equal(r8, x) or not torch.equal(r9, x):
        raise AssertionError("K8 or K9 at 384 x 16,384: the rows decoded differ from the residuals")
    ms8, ms9 = cuda_ms(k8, 5, warmup=1), cuda_ms(k9, 5, warmup=1)
    log("kernels", f"rice_encode_blocks / rice_decode_blocks B {B} C {C} L {L} "
        f"({int(counts.sum()) * C} symbols, {int(sizes.sum())} payload bytes): K8's payloads "
        f"decode back to the residuals, K9 on the host coder's stream too; K8 {ms8:.3f} ms, "
        f"K9 {ms9:.3f} ms")
    if prev is not None:
        previous_vs_new(f"rice_encode_blocks B {B} L {L}",
                        lambda: prev.rice_encode_blocks(x, row0, cnt, ini, C), k8,
                        lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b)))
        previous_vs_new(f"rice_decode_blocks B {B} L {L}",
                        lambda: prev.rice_decode_blocks(words, o, W, cnt, ini, C, L), k9,
                        lambda a, b: ce.decode_agrees(*a, *b, C)[0])


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


class Spans:
    """Host-clock time spent in functions of the port's modules, each call
    ended by a device sync; installed for one instrumented run only (the
    syncs cost time of their own)."""

    def __init__(self, targets):
        self.ms: dict[str, float] = {label: 0.0 for _, _, label in targets}
        self._saved = []
        for mod, name, label in targets:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._timed(fn, label))

    def _timed(self, fn, label):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.ms[label] += (time.perf_counter() - t0) * 1e3
            return out
        return timed

    def close(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def device_profile(fn) -> tuple[list[tuple[str, float]], float, float, float]:
    """One torch.profiler trace of fn(): (the five device operations that
    take the most device time, with their ms; the device's busy ms; the
    window's wall ms; the device-to-host copies' ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    # the device's own records (kernels, copies, memsets): the CPU ops that
    # launched them carry the same time again, and CUPTI's buffer requests
    # are the profiler's
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0
              and not e.key.startswith("Activity Buffer")]
    top = sorted(events, key=dev_us, reverse=True)[:5]
    d2h_ms = sum(dev_us(e) for e in events if e.key.startswith("Memcpy DtoH")) / 1e3
    return ([(e.key, dev_us(e) / 1e3) for e in top], sum(dev_us(e) for e in events) / 1e3,
            wall_ms, d2h_ms)


def golomb_blocks(st, blob: bytes) -> tuple[int, int]:
    """(static-Golomb, recursive-Rice) COMPRESSDATA blocks of a stream."""
    from sla_tpu_torch import rice_device
    from sla_tpu_torch.constants import BlockDataType

    dec = st.Decoder(st.DecoderConfig(backend="host"), device="cpu")
    header = dec._open_stream(blob)
    comp = [b for b in dec.scan_blocks(blob, header.num_samples)
            if b.block_type == BlockDataType.COMPRESSDATA]
    golomb = sum(rice_device.is_golomb_block(b.init_rice) for b in comp)
    return golomb, len(comp) - golomb


def round_trip(st, label: str, pcm, bits: int, rate: int, preset: int, detail: bool) -> dict:
    """Encode and decode on the device backend, entropy on the card (the
    default), then with device_entropy='off', each against the host
    backend. `detail` (the main path's clip): count the launches, split the
    entropy stage, and take the trace."""
    from sla_tpu_torch import pipeline, rice_device
    from sla_tpu_torch.kernels import cuda_entropy as ce
    from sla_tpu_torch.kernels import cuda_filters as cf

    ep = st.preset_parameter(preset, 2)

    def encoder(backend, device, **kw):
        enc = st.Encoder(st.EncoderConfig(backend=backend, **kw), device=device)
        enc.set_wave_format(st.WaveFormat(2, bits, rate))
        enc.set_encode_parameter(ep)
        return enc

    def run(**kw):
        enc = encoder("device", "cuda", **kw)
        t0 = time.perf_counter()
        blob = enc.encode_whole(pcm)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        dec = st.Decoder(st.DecoderConfig(backend="device", **kw), device="cuda")
        t0 = time.perf_counter()
        _, out = dec.decode_whole(blob)
        torch.cuda.synchronize()
        return enc, blob, enc_s, dec, out, time.perf_counter() - t0

    if detail:
        cf.reset_launch_counts()
        ce.reset_launch_counts()
    enc, blob, enc_s, dec, out, dec_s = run()
    launches = {**cf.launches, **ce.launches}
    host = encoder("host", "cpu")
    t0 = time.perf_counter()
    host_blob = host.encode_whole(pcm)
    host_s = time.perf_counter() - t0
    if blob != host_blob:
        raise AssertionError(f"{label}: device stream differs from the host backend's")
    if out.shape != pcm.shape or not np.array_equal(out, pcm):
        raise AssertionError(f"{label}: decoded PCM differs from the input")
    if not enc._device_entropy_active:
        raise AssertionError(f"{label}: the device backend did not code entropy on the card")
    if detail and not all(launches[k] > 0 for k in SLICE_KERNELS + ENTROPY_KERNELS):
        raise AssertionError(f"{label}: a kernel of the path never launched: {launches}")
    enc_off, blob_off, enc_off_s, dec_off, out_off, dec_off_s = run(device_entropy="off")
    if blob_off != host_blob or enc_off._device_entropy_active:
        raise AssertionError(f"{label}: device_entropy='off' stream differs from the host's")
    if not np.array_equal(out_off, pcm):
        raise AssertionError(f"{label}: device_entropy='off' decode differs from the input")
    raw = pcm.shape[0] * pcm.shape[1] * bits // 8
    golomb, rice_blocks = golomb_blocks(st, blob)
    log("slice", f"{label} preset {preset}: byte-identical to host, PCM exact, entropy on the "
        f"card (default) and off; encode {enc_s:.3f} s (entropy off {enc_off_s:.3f} s, host "
        f"backend {host_s:.3f} s), decode {dec_s:.3f} s (entropy off {dec_off_s:.3f} s), ratio "
        f"{raw / len(blob):.4f}, {rice_blocks} recursive-Rice blocks on the card, {golomb} "
        f"static-Golomb blocks on the host coder, launches {launches}")

    def stages(times):
        return ", ".join(f"{k} {v * 1e3:.1f}" for k, v in times.items())

    log("slice", f"{label} stage ms: device encode [{stages(enc.stage_times)}]; entropy off "
        f"[{stages(enc_off.stage_times)}]; host encode [{stages(host.stage_times)}]; device "
        f"decode [{stages(dec.stage_times)}]; entropy off [{stages(dec_off.stage_times)}]")
    if detail:
        spans = Spans([
            (ce, "rice_encode_blocks", "K8"),
            (rice_device, "encode_blocks_device", "K8 + copy"),
            (rice_device, "upload_stream", "stream upload"),
            (ce, "rice_decode_blocks", "K9"),
            (rice_device, "decode_blocks_payload_device", "K9 + flags copy"),
        ])
        try:
            enc_i, _, enc_i_s, dec_i, _, dec_i_s = run()
        finally:
            spans.close()
        ms = spans.ms
        log("slice", f"{label} entropy split (a run with a sync after each span): encode "
            f"{enc_i_s:.3f} s: K8 {ms['K8']:.1f} ms (count, sizes, emit; inside stage 'filters'), "
            f"payload copy {ms['K8 + copy'] - ms['K8']:.1f} ms, framing (stage 'entropy') "
            f"{enc_i.stage_times['entropy'] * 1e3:.1f} ms; decode {dec_i_s:.3f} s: stream upload "
            f"{ms['stream upload']:.1f} ms, K9 {ms['K9']:.1f} ms, flags copy "
            f"{ms['K9 + flags copy'] - ms['K9']:.1f} ms, rest of stage 'entropy' "
            f"{dec_i.stage_times['entropy'] * 1e3 - ms['K9 + flags copy'] - ms['stream upload']:.1f} ms")

        def one_each():
            blob_t = encoder("device", "cuda").encode_whole(pcm)
            st.Decoder(st.DecoderConfig(backend="device"), device="cuda").decode_whole(blob_t)

        top, busy_ms, wall_ms, d2h_ms = device_profile(one_each)
        # the same trace with the previous commit's residual fetch (the full
        # int32 copy) in place of fetch_int32's int16 narrowing
        narrowing = pipeline.fetch_int32
        pipeline.fetch_int32 = lambda x: x.cpu().numpy()
        try:
            _, busy_prev, wall_prev, d2h_prev = device_profile(one_each)
        finally:
            pipeline.fetch_int32 = narrowing
        log("trace", f"{label}: one encode + one decode under torch.profiler, {wall_ms:.1f} ms "
            f"wall, device busy {busy_ms:.1f} ms, idle share {100 * (1 - busy_ms / wall_ms):.1f} %; "
            "top five device operations: "
            + "; ".join(f"{name} {t:.2f} ms" for name, t in top))
        log("trace", f"{label}: device-to-host copies {d2h_ms:.2f} ms with fetch_int32 (residuals "
            f"as int16 when they fit) against {d2h_prev:.2f} ms with the previous commit's int32 "
            f"fetch (busy {busy_prev:.1f} ms, wall {wall_prev:.1f} ms), same call")
    return launches, blob


CD_CLIP = dict(seconds=300, rate=44100, bits=16, seed=2026, f_lo=180, f_hi=900)


def cd_clip():
    c = CD_CLIP
    return music(c["seconds"], c["rate"], c["bits"], c["seed"], c["f_lo"], c["f_hi"])


def phase_slice() -> tuple[dict, bytes]:
    """Returns the main path's launches and its device stream of the CD
    clip (phase 5's CLI must write the same bytes)."""
    import sla_tpu_torch as st

    launches, blob = round_trip(st, "5 min CD stereo 44.1 kHz/16", cd_clip(), 16, 44100, 2,
                                detail=True)
    hi = music(60, 96000, 24, seed=2027, f_lo=400, f_hi=1800)
    round_trip(st, "1 min stereo 96 kHz/24", hi, 24, 96000, 4, detail=False)
    return launches, blob


# -- phase 4 -----------------------------------------------------------------


def phase_known_parameters() -> dict:
    from sla_tpu_torch import entry, pipeline
    from sla_tpu_torch.kernels import cuda_entropy as ce
    from sla_tpu_torch.kernels import cuda_filters as cf
    from sla_tpu_torch.tools import bench_device, verify_device

    cf.reset_launch_counts()
    ce.reset_launch_counts()
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
    return {**launches, **ce.launches}


# -- phase 5 -----------------------------------------------------------------

# the corpus of phase 5 (b): (channels, seconds) at 44.1 kHz / 16 bit
CORPUS = ((2, 60), (2, 45), (2, 40), (2, 35), (2, 30), (2, 25), (1, 30), (1, 20))
ENCODE_KERNELS = ("lattice_predict", "stage2_predict", "rice_encode_blocks")
DECODE_KERNELS = ("synth_cascade", "rice_decode_blocks")


class Launches:
    """Each part of phase 5 runs with the wrappers' counts set to 0 and
    must launch the kernels it names; the parts' counts add up here."""

    def __init__(self):
        from sla_tpu_torch.kernels import cuda_entropy as ce
        from sla_tpu_torch.kernels import cuda_filters as cf

        self._mods = (cf, ce)
        self.total = {name: 0 for name in KERNELS}

    def part(self, label: str, fn, need=()):
        for mod in self._mods:
            mod.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {k: v for mod in self._mods for k, v in mod.launches.items()}
        missing = [k for k in need if got[k] == 0]
        if missing:
            raise AssertionError(f"{label}: kernels of the path never launched: {missing}; {got}")
        for k, v in got.items():
            self.total[k] += v
        return out, dt, {k: v for k, v in got.items() if v}


class FilterChunks:
    """The encoders' filter chunks while installed: (row-samples, backend)
    each, as `Encoder._select_backend` decides them."""

    def __init__(self):
        from sla_tpu_torch.encoder import Encoder

        self.seen: list[tuple[int, str]] = []
        self._cls, self._real = Encoder, Encoder._select_backend
        real, seen = self._real, self.seen

        def spy(enc, row_samples):
            backend = real(enc, row_samples)
            seen.append((row_samples, backend))
            return backend

        Encoder._select_backend = spy

    def close(self) -> str:
        self._cls._select_backend = self._real
        return ", ".join(f"{n} on {b}" for n, b in self.seen)


def same_pcm(label: str, path, want) -> None:
    from sla_tpu_torch import wavio

    got = wavio.read_wav(str(path)).data
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{label}: the decoded PCM differs from the input")


def phase_entry_points(env: dict, device_blob: bytes) -> dict:
    """The port's entry points on the card at preset 2, CD stereo: the CLI
    (encode with -V, decode, streaming decode, window decode, and one
    `python -m sla_tpu_torch`), corpus mode with an 8-file `-f 8` batch,
    optimize_encode against the same call on the CPU, and the assert mode
    (SLA_TPU_DEBUG_ASSERTS) round trip and trap."""
    import tempfile

    import sla_tpu_torch as st
    from sla_tpu_torch import cli, debug, wavio
    from sla_tpu_torch.kernels import lms

    runs = Launches()
    times: dict[str, float] = {}
    notes: list[str] = []
    with tempfile.TemporaryDirectory(prefix="sla_smoke_") as tmp:
        d = pathlib.Path(tmp)
        # (a) the CLI on phase 3's clip
        cd = cd_clip()
        wav, sla = d / "clip.wav", d / "clip.sla"
        wavio.write_wav(str(wav), wavio.WavFile(2, 44100, 16, cd))
        argv = ["sla_tpu_torch", "-e", "-q", "-m", "2"]
        spy = FilterChunks()
        try:
            rc, times["cli encode"], got = runs.part(
                "cli -e -V", lambda: cli.main(argv + ["-V", str(wav), str(sla)]),
                ENCODE_KERNELS + DECODE_KERNELS)
        finally:
            chunks = spy.close()
        if rc != 0 or sla.read_bytes() != device_blob:
            raise AssertionError("cli -e: the stream differs from phase 3's device stream")
        notes.append(f"cli -e -V {got}, filter chunks (row-samples) {chunks}")
        rc, times["cli decode"], got = runs.part(
            "cli -d", lambda: cli.main(["sla_tpu_torch", "-d", "-q", str(sla), str(d / "d.wav")]),
            DECODE_KERNELS)
        if rc != 0:
            raise AssertionError("cli -d failed")
        same_pcm("cli -d", d / "d.wav", cd)
        notes.append(f"cli -d {got}")
        rc, times["cli -d -s"], _ = runs.part(
            "cli -d -s",
            lambda: cli.main(["sla_tpu_torch", "-d", "-s", "-q", str(sla), str(d / "s.wav")]))
        if rc != 0:
            raise AssertionError("cli -d -s failed")
        same_pcm("cli -d -s", d / "s.wav", cd)
        start, count = 5_000_000, 441_000
        rc, times["cli -d -w"], _ = runs.part(
            "cli -d -w", lambda: cli.main(["sla_tpu_torch", "-d", "-w", f"{start}:{count}", "-q",
                                           str(sla), str(d / "w.wav")]))
        if rc != 0:
            raise AssertionError("cli -d -w failed")
        same_pcm("cli -d -w", d / "w.wav", cd[:, start : start + count])
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "sla_tpu_torch", "-e", "-q", "-m", "2",
                               str(wav), str(d / "m.sla")], cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        times["python -m encode"] = time.perf_counter() - t0
        if proc.returncode != 0 or (d / "m.sla").read_bytes() != device_blob:
            raise AssertionError(f"python -m sla_tpu_torch -e: {proc.returncode} "
                                 f"{proc.stderr[-2000:]}")
        del cd
        # (b) corpus mode: eight files, one -f 8 batch over the 'auto' threshold
        in_dir, out_dir, dec_dir = d / "wavs", d / "slas", d / "dec"
        in_dir.mkdir()
        pcms = {}
        for i, (ch, seconds) in enumerate(CORPUS):
            pcm = music(seconds, 44100, 16, seed=3000 + i, f_lo=150, f_hi=1000)[:ch]
            pcm = np.ascontiguousarray(pcm)
            pcms[f"c{i}"] = pcm
            wavio.write_wav(str(in_dir / f"c{i}.wav"), wavio.WavFile(ch, 44100, 16, pcm))
        row_samples = sum(p.size for p in pcms.values())
        spy = FilterChunks()
        try:
            rc, times["corpus encode"], got = runs.part(
                "cli -e -b -f 8",
                lambda: cli.main(argv + ["-b", "-f", "8", str(in_dir), str(out_dir)]),
                ENCODE_KERNELS)
        finally:
            batch_chunks = spy.close()
        if rc != 0:
            raise AssertionError("cli -e -b -f 8 failed")
        batch_launches = got
        for name, pcm in pcms.items():
            host = st.Encoder(st.EncoderConfig(backend="host"), device="cpu")
            host.set_wave_format(st.WaveFormat(pcm.shape[0], 16, 44100))
            host.set_encode_parameter(st.preset_parameter(2, pcm.shape[0]))
            if (out_dir / f"{name}.sla").read_bytes() != host.encode_whole(pcm):
                raise AssertionError(f"corpus: {name}.sla differs from the host backend's")
        # decode_corpus decodes file by file, each under the 16M 'auto'
        # threshold: the threshold knob sends them to the card
        os.environ["SLA_TPU_DEVICE_THRESHOLD"] = "500000"
        try:
            rc, times["corpus decode"], got = runs.part(
                "cli -d -b", lambda: cli.main(["sla_tpu_torch", "-d", "-b", "-q", str(out_dir),
                                               str(dec_dir)]), DECODE_KERNELS)
        finally:
            del os.environ["SLA_TPU_DEVICE_THRESHOLD"]
        if rc != 0:
            raise AssertionError("cli -d -b failed")
        for name, pcm in pcms.items():
            same_pcm(f"corpus {name}", dec_dir / f"{name}.wav", pcm)
        notes.append(f"corpus -d -b {got}")
        del pcms
    # (c) optimize_encode on the card and on the CPU
    clip30 = music(30, 44100, 16, seed=4000, f_lo=180, f_hi=900)
    (card_out, times["optimize card"], _) = runs.part(
        "optimize", lambda: st.optimize_encode(clip30, st.WaveFormat(2, 16, 44100), effort=1))
    t0 = time.perf_counter()
    cpu_out = st.optimize_encode(clip30, st.WaveFormat(2, 16, 44100), effort=1, device="cpu")
    times["optimize cpu"] = time.perf_counter() - t0
    if card_out[0] != cpu_out[0] or str(card_out[1]) != str(cpu_out[1]):
        raise AssertionError("optimize_encode: the card's result differs from the CPU's")
    # (d) assert mode: the checked plain versions on CUDA tensors

    def device_round_trip():
        enc = st.Encoder(st.EncoderConfig(backend="device"))
        enc.set_wave_format(st.WaveFormat(2, 16, 44100))
        enc.set_encode_parameter(st.preset_parameter(2, 2))
        blob = enc.encode_whole(clip30)
        _, out = st.Decoder(st.DecoderConfig(backend="device")).decode_whole(blob)
        return blob, out

    (want, _), _, _ = runs.part("unchecked", device_round_trip, ENCODE_KERNELS + DECODE_KERNELS)
    os.environ["SLA_TPU_DEBUG_ASSERTS"] = "1"
    try:
        (blob, out), times["assert round trip"], got = runs.part(
            "assert mode", device_round_trip, ENTROPY_KERNELS)
        if any(got.get(k) for k in SLICE_KERNELS):
            raise AssertionError(f"assert mode launched a filter kernel: {got}")
        if blob != want or not np.array_equal(out, clip30):
            raise AssertionError("assert mode: the stream or the PCM differs")
        dev = torch.device("cuda")
        big = torch.full((1, 4), 2**30, dtype=torch.int32, device=dev)
        zero = torch.zeros((1, 4), dtype=torch.int32, device=dev)
        state = lms.LmsState(big, zero, big, zero, torch.full((1,), 4, dtype=torch.int32,
                                                              device=dev))
        try:
            lms.lms_predict(torch.full((1, 4), 2**20, dtype=torch.int32, device=dev), state, 4)
        except debug.DebugAssertError as e:
            if "LMS tap product overflows int32" not in str(e):
                raise
        else:
            raise AssertionError("assert mode: the seeded LMS overflow did not raise")
    finally:
        del os.environ["SLA_TPU_DEBUG_ASSERTS"]
    log("entry", f"{env['card']} | cli -e -V (K1, K2, K8, and K3, K9 for -V) equals phase 3's "
        f"stream; -d, -d -s and -d -w {start}:{count} exact; python -m equal | corpus {len(CORPUS)} "
        f"files, {row_samples} row-samples (auto threshold 16,000,000) in one -f 8 batch, "
        f"each .sla equal to the host backend's, -d -b exact; the batch's filter chunks "
        f"(row-samples) {batch_chunks}, launches {batch_launches} | optimize effort 1 on the card equals the CPU's | assert mode "
        f"stream equal, PCM exact, LMS trap raised on CUDA tensors; " + "; ".join(notes))
    log("entry", f"{env['card']} | wall s: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return runs.total


# -- phase 6 -----------------------------------------------------------------

MESH_ENCODE_KERNELS = ("lattice_predict", "stage2_predict", "rice_encode_blocks")


def phase_mesh(env: dict, device_blob: bytes) -> dict:
    """backend='mesh' on the card: the 'auto' rule for this card count,
    phase 3's clip through Encoder/Decoder(backend='mesh') on the mesh of
    every card and on four shards (parallel.sharding.SHARDS = 4: all on the
    card of a one-card machine) with SLA_TPU_MESH_CHANNELS=2 (blocks 2 x
    channels 2), each stream equal to phase 3's (the host backend's) and
    decoded exactly, with K1, K2, K8 on encode and K3, K9 on decode, and K1
    launched once a shard and filter chunk; then
    entry.dryrun_multichip(4) on the card, K4 required."""
    import sla_tpu_torch as st
    from sla_tpu_torch import entry, pipeline
    from sla_tpu_torch.parallel import sharding

    cards = torch.cuda.device_count()
    auto = pipeline.select_backend("auto", pipeline.DEFAULT_DEVICE_THRESHOLD,
                                   torch.device("cuda"))
    if auto != ("mesh" if cards > 1 else "device"):
        raise AssertionError(f"'auto' picked {auto!r} with {cards} card(s)")
    log("mesh", f"{cards} card(s): 'auto' over the threshold picks {auto!r}")
    runs = Launches()
    times: dict[str, float] = {}
    cd = cd_clip()
    ep = st.preset_parameter(2, 2)
    notes = []
    k1_a_shard = []
    for label, shards, channels in (("every card", None, None), ("4 shards", 4, "2")):
        sharding.SHARDS = shards
        if channels:
            os.environ["SLA_TPU_MESH_CHANNELS"] = channels
        try:
            n_shards = len(sharding.mesh_devices("cuda"))
            enc = st.Encoder(st.EncoderConfig(backend="mesh"), device="cuda")
            enc.set_wave_format(st.WaveFormat(2, 16, 44100))
            enc.set_encode_parameter(ep)
            blob, times[f"{label} encode"], got_e = runs.part(
                f"mesh encode, {label}", lambda: enc.encode_whole(cd), MESH_ENCODE_KERNELS)
            if blob != device_blob:
                raise AssertionError(f"mesh ({label}): the stream differs from the host backend's")
            dec = st.Decoder(st.DecoderConfig(backend="mesh"), device="cuda")
            (_, out), times[f"{label} decode"], got_d = runs.part(
                f"mesh decode, {label}", lambda: dec.decode_whole(blob), DECODE_KERNELS)
            if out.shape != cd.shape or not np.array_equal(out, cd):
                raise AssertionError(f"mesh ({label}): the decoded PCM differs from the input")
        finally:
            sharding.SHARDS = None
            os.environ.pop("SLA_TPU_MESH_CHANNELS", None)
        # every shard is its own tensor and launch, on a repeated card too
        if got_e["lattice_predict"] % n_shards:
            raise AssertionError(f"mesh ({label}): K1 launched {got_e['lattice_predict']} "
                                 f"times over {n_shards} shards")
        k1_a_shard.append(got_e["lattice_predict"] // n_shards)
        notes.append(f"{label} ({n_shards} shards, SLA_TPU_MESH_CHANNELS "
                     f"{channels or 'unset'}): encode {got_e}, decode {got_d}")
    if k1_a_shard[0] != k1_a_shard[1]:
        raise AssertionError(f"mesh: K1 launches a shard differ between the meshes: {k1_a_shard}")
    _, times["dryrun_multichip(4)"], got = runs.part(
        "dryrun_multichip(4)", lambda: entry.dryrun_multichip(4, device="cuda"),
        ("fused_encode",) + MESH_ENCODE_KERNELS)
    notes.append(f"dryrun_multichip(4) {got}")
    log("mesh", "5 min CD stereo preset 2 on backend='mesh': byte-identical to the host backend, "
        "PCM exact; " + "; ".join(notes))
    log("mesh", f"{env['card']} | wall s: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return runs.total


# -- phase 7 -----------------------------------------------------------------

K1, K2, K3 = "lattice_predict", "stage2_predict", "synth_cascade"
K8, K9 = "rice_encode_blocks", "rice_decode_blocks"
CODEC = (K1, K2, K8, K3, K9)
# (label, the tool's arguments, the kernels it must launch): the fuzzers
# run side by side, one process each, so that a CUDA fault, which poisons
# its context, stops one tool at its first failing case
FUZZERS = (
    ("fuzz_device_entropy", ["fuzz_device_entropy", "100", "0"], CODEC),
    ("fuzz_corruption", ["fuzz_corruption", "200", "0", "--backend", "device"], CODEC),
    ("fuzz_salvage", ["fuzz_salvage", "50", "0"], (K3, K9)),
    ("fuzz_streaming", ["fuzz_streaming", "50", "0"], (K3, K9)),
    ("fuzz_streaming --seek", ["fuzz_streaming", "20", "0", "--seek"], (K3, K9)),
)
# the sanitized run: fuzz_corruption on the card under ASan + UBSan. Its
# form was found on the H100 (gcc 13's libasan.so.8): CUDA starts under
# ASan only with protect_shadow_gap=0, which run_sanitized adds for
# --device cuda
SANITIZED = ("run_sanitized fuzz_corruption",
             ["run_sanitized", "fuzz_corruption", "50", "1", "--backend", "device",
              "--device", "cuda"], CODEC)
# the measurements, one at a time after the fuzzers
MEASUREMENTS = (
    ("profile_decode", ["profile_decode"], (K3, K9)),
    ("measure_streaming", ["measure_streaming"], CODEC),
    ("measure_multiproc 8 2", ["measure_multiproc", "8", "2"], (K1, K2, K8)),
    ("bench_synth_micro", ["bench_synth_micro"], ()),
)
TOOLS_OUT = ROOT / "chiprun_out" / "tools"  # each tool's whole output


def start_sanitized_build() -> subprocess.Popen | None:
    """The instrumented native library (SLA_TPU_SANITIZE=1: sla_native_san,
    g++ with ASan + UBSan) takes minutes, so phase 1 starts it beside the
    other builds and phase 7 waits for it; None when g++ has no libasan."""
    from sla_tpu_torch.tools import run_sanitized

    if run_sanitized.find_runtime("libasan.so") is None:
        return None
    code = ("from sla_tpu_torch import native; from sla_tpu_torch.kernels import build; "
            "native._build(); print(build.build_seconds.get('sla_native_san', 0.0))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                            env={**os.environ, "SLA_TPU_SANITIZE": "1"},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)


def stop(proc: subprocess.Popen) -> None:
    """End a process started in a session of its own, and its children
    (g++ under the build, the workers and the sanitized tool under a tool)."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def run_tool(label: str, args: list[str], need, timeout: float) -> dict:
    """`python -m sla_tpu_torch.tools.<args>` in a process of its own; its
    last line's JSON, once its exit code is 0, it reports no failure and it
    launched every kernel in `need` (for run_sanitized, the tool it ran)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", f"sla_tpu_torch.tools.{args[0]}", *args[1:]],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        stop(proc)
    dt = time.perf_counter() - t0
    TOOLS_OUT.mkdir(parents=True, exist_ok=True)
    (TOOLS_OUT / f"{label.replace(' ', '_')}.log").write_text(stdout + stderr)
    if proc.returncode != 0:
        tail = "\n".join((stdout + stderr).strip().splitlines()[-25:])
        raise AssertionError(f"tools: {label} exited {proc.returncode}:\n{tail}")
    lines = stdout.strip().splitlines()
    res = json.loads(lines[-1])
    if res.get("failures"):
        raise AssertionError(f"tools: {label} reports failures: {lines[-6:]}")
    got = dict(res["launches"])
    for k, v in res.get("worker_launches", {}).items():
        got[k] += v
    missing = [k for k in need if got[k] == 0]
    if missing:
        raise AssertionError(f"tools: {label}: kernels of its path never launched: "
                             f"{missing}; {got}")
    res.update(run_s=dt, total_launches=got, summary=lines[-2] if len(lines) > 1 else "")
    return res


def phase_tools(env: dict) -> dict:
    """The robustness and measurement tools (sla_tpu_torch/tools/) on the
    card, each in a process of its own, with each one's kernels required;
    their launches add up here."""
    total = {name: 0 for name in KERNELS}
    results = {}
    san = env["sanitized_build"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(FUZZERS) + 1) as pool:
        futs = {label: pool.submit(run_tool, label, args, need, 900)
                for label, args, need in FUZZERS}
        if san is None:
            log("tools", "g++ finds no libasan.so on this machine: no sanitized run")
        else:
            out, _ = san.communicate(timeout=900)
            if san.returncode != 0:
                raise RuntimeError(f"the sanitized native build failed:\n{out[-3000:]}")
            log("tools", f"sanitized native build (SLA_TPU_SANITIZE=1, sla_native_san, g++ "
                f"-fsanitize=address,undefined) {float(out.strip().splitlines()[-1]):.1f} s, "
                f"started in phase 1 beside the other builds, done "
                f"{time.perf_counter() - env['t_start']:.1f} s into the run")
            label, args, need = SANITIZED
            futs[label] = pool.submit(run_tool, label, args, need, 900)
        for label, fut in futs.items():
            results[label] = fut.result()
    fuzz_s = time.perf_counter() - t0
    for label, args, need in MEASUREMENTS:
        results[label] = run_tool(label, args, need, 600)
    for label, res in results.items():
        for k, v in res["total_launches"].items():
            total[k] += v
        nonzero = {k: v for k, v in res["total_launches"].items() if v}
        log("tools", f"{label}: {res['run_s']:.1f} s, {res.get('cases', '-')} cases, "
            f"launches {nonzero} | {res['summary']}")
    log("tools", f"fuzzers side by side {fuzz_s:.1f} s: zero divergences between "
        "backend='device' and backend='host' (decode outcomes and encode bytes)")
    for row in results["profile_decode"]["rows"]:
        stages = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in row["stages_s"].items())
        log("tools", f"{env['card']} | profile_decode {row['name']} (backend 'device'): "
            f"wall {row['wall_s'] * 1e3:.1f} ms, {row['msps']:.1f} M row-samples/s; "
            f"stages ms: {stages}")
    ms, mp = results["measure_streaming"], results["measure_multiproc 8 2"]
    synth = results["bench_synth_micro"]["ns_per_row_sample"]
    log("tools", f"{env['card']} | measure_streaming {ms['seconds']} s x {ms['channels']} ch "
        f"(stream encoded on the card): {ms['msps']:.2f} M samples/s, best {ms['best_s']:.3f} s; "
        f"measure_multiproc {mp['n_files']} files: serial {mp['serial_s']:.3f} s, "
        f"{mp['n_procs']} processes on the one card {mp['multi_s']:.3f} s")
    log("tools", f"{env['card']} | bench_synth_micro (host) ns a row-sample: "
        + ", ".join(f"{k} {v:.2f}" for k, v in synth.items()))
    log("tools", f"phase 7 {time.perf_counter() - t0:.1f} s")
    return total


# -- phase 8 -----------------------------------------------------------------

# the sweep's lengths of bench.make_signal, s: 0.44M to 26.5M row-samples,
# across both of phase 5's host tails (2.4M and 5.5M)
SWEEP_SECONDS = (5, 15, 30, 60, 120, 180, 300)
SWEEP_REPS = 3
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]  # bench.py's last line


def best_of(fn, reps: int):
    """fn()'s result and its best wall time over `reps` calls after a warm
    call (fn's result is on the host, so each call has ended on the card)."""
    out = fn()
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        t = time.perf_counter() - t0
        best = t if best is None else min(best, t)
    return out, best


def sweep_row(runs: "Launches", seconds: int) -> dict:
    """bench.make_signal(seconds) encoded and decoded on backend='host' and
    on backend='device', best of SWEEP_REPS each: the device stream equal
    to the host's, both decodes exact, the host rows launching no kernel
    and the device rows K1, K2, K8 and K3, K9."""
    import sla_tpu_torch as st
    from sla_tpu_torch import bench

    pcm = bench.make_signal(seconds)
    row = {"seconds": seconds, "row_samples": pcm.size}
    blobs = {}
    for backend in ("host", "device"):
        enc = bench.encoder("cuda", backend)
        dec = st.Decoder(st.DecoderConfig(backend=backend), device="cuda")
        label = f"sweep {seconds} s {backend}"
        (blob, row[f"{backend} encode"]), _, got = runs.part(
            f"{label} encode", lambda: best_of(lambda: enc.encode_whole(pcm), SWEEP_REPS),
            ENCODE_KERNELS if backend == "device" else ())
        row[f"{backend} chunks"] = list(enc.filter_chunks)
        row[f"{backend} encode stages"] = dict(enc.stage_times)
        ((_, out), row[f"{backend} decode"]), _, got_d = runs.part(
            f"{label} decode", lambda: best_of(lambda: dec.decode_whole(blob), SWEEP_REPS),
            DECODE_KERNELS if backend == "device" else ())
        row[f"{backend} decode stages"] = dict(dec.stage_times)
        if backend == "host" and (got or got_d):
            raise AssertionError(f"{label}: the host backend launched kernels {got} {got_d}")
        if out.shape != pcm.shape or not np.array_equal(out, pcm):
            raise AssertionError(f"{label}: the decoded PCM differs from the input")
        row[f"{backend} launches"] = {k: got.get(k, 0) + got_d.get(k, 0)
                                      for k in set(got) | set(got_d)}
        blobs[backend] = blob
    if blobs["device"] != blobs["host"]:
        raise AssertionError(f"sweep {seconds} s: the device stream differs from the host's")
    return row


def crossover(rows: list[dict], what: str) -> tuple[int | None, int | None]:
    """The 'auto' threshold the sweep gives for `what` ('encode' or
    'decode'): the smallest swept row-sample count from which every larger
    swept size runs no slower on the card, and the midpoint between it and
    the next smaller size (0 below the first), rounded to 100,000; (None,
    None) when the largest size is slower on the card."""
    rows = sorted(rows, key=lambda r: r["row_samples"])
    first = None
    for i in reversed(range(len(rows))):
        if rows[i][f"device {what}"] > rows[i][f"host {what}"]:
            break
        first = i
    if first is None:
        return None, None
    below = rows[first - 1]["row_samples"] if first else 0
    size = rows[first]["row_samples"]
    return size, int(round((below + size) / 2, -5))


def run_bench(runs: "Launches", label: str, need) -> tuple[dict, str, dict]:
    """bench.main() in this process on the card: its last stdout line,
    parsed, its stderr line and its launches."""
    import contextlib
    import io

    from sla_tpu_torch import bench

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        _, _, got = runs.part(label, bench.main, need)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    if list(res) != BENCH_KEYS or res["metric"] != bench.METRIC:
        raise AssertionError(f"{label}: the last line is not bench.py's: {res}")
    return res, err.getvalue().strip().splitlines()[-1], got


def phase_threshold(env: dict) -> dict:
    """The 'auto' device threshold measured on the card, then the
    benchmark twin (sla_tpu_torch.bench): under 'auto' as it stands, forced
    onto the card with SLA_TPU_DEVICE_THRESHOLD=0, and as
    `python -m sla_tpu_torch.bench`."""
    from sla_tpu_torch import pipeline

    runs = Launches()
    t0 = time.perf_counter()
    rows = []
    for seconds in SWEEP_SECONDS:
        r = sweep_row(runs, seconds)
        rows.append(r)
        log("threshold", f"{env['card']} | {seconds} s, {r['row_samples']} row-samples (chunks "
            + ", ".join(str(n) for n, _ in r["device chunks"])
            + f"): encode host {r['host encode']:.4f} s, card {r['device encode']:.4f} s "
            f"(host / card {r['host encode'] / r['device encode']:.3f}); decode host "
            f"{r['host decode']:.4f} s, card {r['device decode']:.4f} s (host / card "
            f"{r['host decode'] / r['device decode']:.3f}); device stream equal to the "
            f"host's, both decodes exact; card launches {r['device launches']}")
    last = rows[-1]

    def stages(key):
        return ", ".join(f"{k} {v * 1e3:.1f}" for k, v in last[key].items())

    log("threshold", f"{last['seconds']} s, the last call's stage ms: encode host "
        f"[{stages('host encode stages')}], card [{stages('device encode stages')}]; decode "
        f"host [{stages('host decode stages')}], card [{stages('device decode stages')}]")
    enc_size, enc_at = crossover(rows, "encode")
    dec_size, dec_at = crossover(rows, "decode")

    def rule(what, size, at):
        if size is None:
            return (f"no swept size from which every larger one {what}s no slower on the card "
                    "(the rule gives no threshold)")
        return f"the card {what}s no slower from {size} row-samples on (the rule gives {at})"

    log("threshold", f"best of {SWEEP_REPS} after a warm call: "
        f"{rule('encode', enc_size, enc_at)}; {rule('decode', dec_size, dec_at)}; "
        f"pipeline.DEFAULT_DEVICE_THRESHOLD "
        f"{pipeline.DEFAULT_DEVICE_THRESHOLD}; sweep {time.perf_counter() - t0:.1f} s")
    # the twin under 'auto' as it stands, then forced onto the card
    auto, auto_err, auto_got = run_bench(runs, "bench auto", ())
    os.environ["SLA_TPU_DEVICE_THRESHOLD"] = "0"
    try:
        forced, forced_err, forced_got = run_bench(runs, "bench forced", CODEC)
    finally:
        del os.environ["SLA_TPU_DEVICE_THRESHOLD"]
    log("threshold", f"bench auto (launches {auto_got}): {json.dumps(auto)} | {auto_err}")
    log("threshold", f"bench SLA_TPU_DEVICE_THRESHOLD=0 (launches {forced_got}): "
        f"{json.dumps(forced)} | {forced_err}")
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sla_tpu_torch.bench"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"python -m sla_tpu_torch.bench exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if list(res) != BENCH_KEYS or res["metric"] != auto["metric"]:
        raise AssertionError(f"python -m sla_tpu_torch.bench: not bench.py's last line: {res}")
    log("threshold", f"python -m sla_tpu_torch.bench {time.perf_counter() - t1:.1f} s: "
        f"{json.dumps(res)} | {proc.stderr.strip().splitlines()[-1]}")
    log("threshold", f"phase 8 {time.perf_counter() - t0:.1f} s")
    return runs.total


def main() -> int:
    env = phase_environment()
    try:
        timing = phase_kernels(env)
        timing.update(phase_entropy(env))
        slice_launches, device_blob = phase_slice()
        known_launches = phase_known_parameters()
        entry_launches = phase_entry_points(env, device_blob)
        mesh_launches = phase_mesh(env, device_blob)
        tools_launches = phase_tools(env)
        threshold_launches = phase_threshold(env)
    finally:
        if env["sanitized_build"] is not None:
            stop(env["sanitized_build"])
    record = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": KERNELS[name],
         "launches": slice_launches[name] + known_launches[name] + entry_launches[name]
         + mesh_launches[name] + tools_launches[name] + threshold_launches[name],
         **timing[name]}
        for name in KERNELS
    ]
    print(json.dumps({"kernels": record}))
    print(env["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
