"""The flagship forward step on the card and the mesh dry run: the twins
of `__graft_entry__.entry()` and `__graft_entry__.dryrun_multichip()`.

`entry()` returns `(forward, args)`: the whole encode-side filter cascade
for known parameters (pre-emphasis -> PARCOR lattice -> long-term -> LMS,
`pipeline.encode_filters_fused`, one CUDA kernel) over a (blocks x
channels, L) batch, with the same shapes and the same `default_rng(0)`
draws as the JAX entry, so both forwards see the same arrays.

`dryrun_multichip(n)` runs the mesh backend over n shards, leg by leg as
the JAX dry run does. A torch mesh is a list of devices, so it needs no
subprocess: it sets `parallel.sharding.SHARDS` to n for its run, and the n
shards take the cards of `device` in turn (the CPU n times).
"""

from __future__ import annotations

import pathlib
import tempfile

import numpy as np
import torch

from .pipeline import encode_filters, encode_filters_fused

B, L, PARCOR_ORDER, NUM_TAPS, LMS_ORDER = 16, 4096, 16, 1, 8


def entry(device="cuda"):
    """(forward, (data, coef, pitch, ltm)): data and coef int32 tensors on
    `device`, pitch (B,) and Q31 ltm (B, T) int32 numpy, as
    encode_filters_fused takes them."""
    rng = np.random.default_rng(0)
    data = rng.integers(-(1 << 14), 1 << 14, (B, L), dtype=np.int32)
    coef = rng.integers(-(1 << 14), 1 << 14, (B, PARCOR_ORDER), dtype=np.int32)
    pitch = rng.integers(0, 256, (B,), dtype=np.int32)
    ltm = (rng.integers(-(1 << 14), 1 << 14, (B, NUM_TAPS), dtype=np.int64) << 16).astype(np.int32)

    def forward(data, coef, pitch, ltm):
        return encode_filters_fused(data, coef, pitch, ltm, PARCOR_ORDER, NUM_TAPS, LMS_ORDER)

    dev = torch.device(device)
    return forward, (torch.from_numpy(data).to(dev), torch.from_numpy(coef).to(dev), pitch, ltm)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Check the mesh backend over an n-shard mesh; raises on any failure.

    1. sharded_encode_step (K4 on every shard) on a mesh with 2 channel
       shards when n is even and above 2, else blocks only, equals the
       unsharded plain chain, with a finite gmax;
    2. an Encoder(backend='mesh') stream equals backend='host' byte for
       byte and decodes exactly, through a host decoder and a mesh one;
    3. the corpus legs: three files through encode_corpus on the mesh (two
       files' blocks a filter batch), then decode_corpus ('auto'), each
       exact."""
    from .encoder import resolve_device
    from .parallel import make_mesh, mesh_devices, sharding

    device = resolve_device(device)
    saved, sharding.SHARDS = sharding.SHARDS, int(n_devices)
    try:
        _dryrun_legs(make_mesh(
            mesh_devices(device),
            channel_parallel=2 if n_devices % 2 == 0 and n_devices > 2 else 1,
        ), device)
    finally:
        sharding.SHARDS = saved


def _dryrun_legs(mesh, device) -> None:
    from . import Decoder, DecoderConfig, Encoder, EncoderConfig, PRESETS, WaveFormat, wavio
    from .corpus import decode_corpus, encode_corpus
    from .parallel import gather, shard_batch, sharded_encode_step

    # (NB, NC, L) inputs as sla_tpu's dry run draws them, as (NB * NC, L) rows
    p, T, lms = 8, 1, 4
    NB, NC, L = 2 * mesh.shape["blocks"], mesh.shape["channels"], 256
    B = NB * NC
    rng = np.random.default_rng(1)
    data = rng.integers(-(1 << 10), 1 << 10, (NB, NC, L), dtype=np.int32).reshape(B, L)
    coef = rng.integers(-(1 << 14), 1 << 14, (NB, NC, p), dtype=np.int32).reshape(B, p)
    pitch = rng.integers(0, 64, (NB, NC), dtype=np.int32).reshape(B)
    ltm = (rng.integers(-(1 << 14), 1 << 14, (NB, NC, T), dtype=np.int64) << 16).astype(
        np.int32).reshape(B, T)
    d_data, d_coef = shard_batch(mesh, data, coef)
    residual, _, _, gmax = sharded_encode_step(d_data, d_coef, pitch, ltm, p, T, lms)
    out = gather(residual)
    if out.shape != (B, L) or not np.isfinite(gmax):
        raise AssertionError(f"sharded step: shape {out.shape}, gmax {gmax}")
    ref = encode_filters(torch.from_numpy(data), torch.from_numpy(coef), pitch, ltm,
                         p, T, lms).numpy()
    if not np.array_equal(out, ref):
        raise AssertionError("sharded step differs from the unsharded chain")

    # short signals at preset 0 (4,096-sample blocks, the decoder's row
    # length): on CPU shards every stage is a plain per-sample loop a shard
    rng2 = np.random.default_rng(2)
    n = 4000
    tone = 0.2 * np.sin(2 * np.pi * 440 * np.arange(n) / 44100.0)
    sig = np.stack([tone, 0.9 * tone]) + rng2.normal(0, 0.01, (2, n))
    pcm = np.clip(sig * 32767, -32768, 32767).astype(np.int32) << 16
    on_mesh = dict(backend="mesh")

    def encode(**cfg) -> bytes:
        enc = Encoder(EncoderConfig(**cfg), device=device)
        enc.set_wave_format(WaveFormat(2, 16, 44100))
        enc.set_encode_parameter(PRESETS[0])
        return enc.encode_whole(pcm)

    mesh_blob = encode(**on_mesh)
    if mesh_blob != encode(backend="host"):
        raise AssertionError("mesh encode differs from the host encode")
    for cfg in (dict(backend="host"), on_mesh):
        _, decoded = Decoder(DecoderConfig(**cfg), device=device).decode_whole(mesh_blob)
        if not np.array_equal(decoded, pcm):
            raise AssertionError(f"{cfg['backend']} decode of the mesh stream differs")

    with tempfile.TemporaryDirectory() as td:
        base = pathlib.Path(td)
        files = []
        for i in range(3):
            tone = 0.1 * (i + 1) * np.sin(2 * np.pi * (220 + 110 * i) * np.arange(2500) / 44100.0)
            pcm_i = np.clip(np.stack([tone, 0.8 * tone]) * 32767, -32768, 32767)
            fp = base / f"f{i}.wav"
            wavio.write_wav(str(fp), wavio.WavFile(2, 44100, 16, pcm_i.astype(np.int32) << 16))
            files.append(fp)
        eres = encode_corpus(files, base / "enc", preset=0, resume=False, filter_batch=2,
                             encoder_config=EncoderConfig(**on_mesh), device=device)
        if eres.encoded != 3 or eres.failed:
            raise AssertionError(f"corpus encode: {eres}")
        dres = decode_corpus([base / "enc" / f"f{i}.sla" for i in range(3)], base / "dec",
                             device=device)
        if dres.encoded != 3 or dres.failed:
            raise AssertionError(f"corpus decode: {dres}")
        for fp in files:
            back = wavio.read_wav(str(base / "dec" / f"{fp.stem}.wav"))
            if not np.array_equal(wavio.read_wav(str(fp)).data, back.data):
                raise AssertionError(f"corpus round trip of {fp.name}")
