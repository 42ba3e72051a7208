"""SLA encoder with the filter cascade on PyTorch (counterpart of
sla_tpu/encoder.py).

`Encoder` subclasses sla_tpu's host encoder (loaded through
`sla_tpu_torch.host`, without jax) and replaces the methods that reach jax:
backend selection, the device-entropy policy, the encode self-check, and
the filter chunk, whose device branch runs the port's stages — K1 for
pre-emphasis + lattice, host pitch analysis on the fetched residual, K2 for
long-term + LMS — on the encoder's torch device. Planning, analysis,
entropy coding and framing are sla_tpu's host code, so streams are
byte-identical to sla_tpu's on every backend.

Backends: 'host' (native C++ cascade), 'device' (the torch stages on
`device`: the CUDA kernels on a card, their plain versions on the CPU),
'auto' (device for big batches when `device` is a CUDA card, host
otherwise). 'mesh' is not ported yet and raises. On-chip entropy coding is
not ported either: EncoderConfig.device_entropy='auto' means host entropy.
"""

from __future__ import annotations

import numpy as np
import torch

from .host import native, rice
from .host.analysis.pitch import longterm_coef_rows
from .host.constants import LONGTERM_MIN_PITCH_THRESHOLD
from .host.dsp.quantize import quantize_longterm
from .host.encoder import Encoder as _HostEncoder
from .host.encoder import EncoderConfig
from .host.errors import ApiResult, SLAError
from . import pipeline


def resolve_device(device) -> torch.device:
    """The torch device the filter stages use: `device`, or the first CUDA
    card when there is one and the CPU otherwise. A CUDA device on a machine
    without one raises here, before any work."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch finds no CUDA device")
    return device


class Encoder(_HostEncoder):
    def __init__(self, config: EncoderConfig | None = None, device=None):
        super().__init__(config)
        self.device = resolve_device(device)

    def _select_backend(self, row_samples: int) -> str:
        return pipeline.select_backend(self.config.backend, row_samples, self.device)

    def _device_entropy_on(self, backend: str) -> bool:
        return pipeline.device_entropy_on(self.config, backend)

    def _run_filters(self, plans) -> None:
        # refuse the device-entropy knob before any work (see
        # pipeline.device_entropy_on), on every encode entry point
        self._device_entropy_on("device")
        super()._run_filters(plans)

    def _maybe_verify(self, blob: bytes, data: np.ndarray) -> None:
        """config.verify: decode the finished stream back with the port's
        Decoder, on the same backend and device, and require the exact
        input PCM (sla_tpu's check, encoder.py:292-335)."""
        if not self.config.verify:
            return
        from .decoder import Decoder
        from .host.decoder import DecoderConfig
        from .host.format import decode_header

        c = self.config
        dec = Decoder(DecoderConfig(max_num_channels=c.max_num_channels,
                                    max_num_block_samples=c.max_num_block_samples,
                                    max_parcor_order=c.max_parcor_order,
                                    max_longterm_order=c.max_longterm_order,
                                    max_lms_order_per_filter=c.max_lms_order_per_filter,
                                    backend=c.backend),
                      device=self.device)
        err = SLAError(
            ApiResult.DETECT_DATA_CORRUPTION,
            "encode verification failed: decoded stream differs from the input",
        )
        data = np.asarray(data, dtype=np.int32)
        seg = self._segment_samples()
        if data.shape[1] <= seg:
            _, out = dec.decode_whole(blob)
            if out.shape != data.shape or not np.array_equal(out, data):
                raise err
            return
        # long streams verify in segment-sized windows (O(segment) memory)
        header, _ = decode_header(blob)
        if (header.num_samples != data.shape[1]
                or header.wave_format.num_channels != data.shape[0]):
            raise err
        idx = dec.build_index(blob)
        pos = 0
        while pos < data.shape[1]:
            take = min(seg, data.shape[1] - pos)
            _, win = dec.decode_range(blob, pos, take, index=idx)
            if (win.shape != (data.shape[0], take)
                    or not np.array_equal(win, data[:, pos : pos + take])):
                raise err
            pos += take

    def _run_filter_chunk(self, plan_rows) -> None:
        """One bounded (rows, L) batch through stage1 -> pitch -> stage2.
        The host backend is sla_tpu's own chunk; the device backend runs the
        port's stages on exact rows (no padding) with L the chunk's longest
        block, keeps the stage-1 residual on the device for stage 2, and
        fetches int32 rows for the host pitch analysis and entropy coder."""
        rows_meta = []  # (plan, C, row0)
        rows = 0
        for pl, C in plan_rows:
            rows_meta.append((pl, C, rows))
            rows += C
        row_samples = sum(pl.num_samples * C for pl, C, _ in rows_meta)
        if self._select_backend(row_samples) == "host":
            return super()._run_filter_chunk(plan_rows)

        ep = self._encode_param
        p, T, M = ep.parcor_order, ep.longterm_order, ep.lms_order_per_filter
        B = rows
        L = max(pl.num_samples for pl, _, _ in rows_meta)
        coefs = np.zeros((B, p), dtype=np.int32)
        lengths = np.zeros((B,), dtype=np.int64)
        batch = np.zeros((B, L), dtype=np.int32)
        for pl, C, r0 in rows_meta:
            coefs[r0 : r0 + C] = pl.parcor_coef[:, 1:]
            lengths[r0 : r0 + C] = pl.num_samples
            batch[r0 : r0 + C, : pl.num_samples] = pl.raw_int32

        res1_dev = pipeline.encode_stage1(
            pipeline.to_rows(batch, self.device), pipeline.to_rows(coefs, self.device), p
        )
        residual1 = res1_dev.cpu().numpy()
        pitches, ltm = self._pitch_analysis(rows_meta, residual1, B, T)
        res2_dev = pipeline.encode_stage2(res1_dev, pitches, ltm, T, M)
        residual2 = res2_dev.cpu().numpy()

        init_all = (
            native.initial_params_rows(residual2, lengths)
            if native.available()
            else None
        )
        for pl, C, r0 in rows_meta:
            pl.pitch = pitches[r0 : r0 + C]
            pl.ltm_coef = ltm[r0 : r0 + C]
            pl.residual = residual2[r0 : r0 + C, : pl.num_samples]
            pl.init_rice = (
                [int(v) for v in init_all[r0 : r0 + C]]
                if init_all is not None
                else rice.calculate_initial_params(list(pl.residual))
            )

    def _pitch_analysis(self, rows_meta, residual1: np.ndarray, B: int, T: int):
        """Host long-term analysis of the PARCOR residual per (block,
        channel) row, grouped by block length for the FFT batch — sla_tpu's
        encoder.py:1002-1033. Returns (pitches (B,), ltm (B, max(T, 1)))."""
        pitches = np.zeros((B,), dtype=np.int32)
        ltm = np.zeros((B, max(T, 1)), dtype=np.int32)
        if T <= 0:
            return pitches, ltm
        fft_size = 1 << (2 * self.config.max_num_block_samples - 1).bit_length()
        rows_by_len: dict[int, list[int]] = {}
        for pl, C, r0 in rows_meta:
            for ch in range(C):
                rows_by_len.setdefault(pl.num_samples, []).append(r0 + ch)
        for n, row_ids in rows_by_len.items():
            i0 = row_ids[0]
            if row_ids == list(range(i0, i0 + len(row_ids))):
                rows_in = residual1[i0 : i0 + len(row_ids), :n]  # a view
            else:
                rows_in = residual1[row_ids, :n]
            res = longterm_coef_rows(rows_in, n, T, fft_size)
            keep = [
                (r, lt)
                for r, lt in zip(row_ids, res)
                if lt.pitch_period >= LONGTERM_MIN_PITCH_THRESHOLD
            ]
            if keep:
                rs = [r for r, _ in keep]
                pitches[rs] = [lt.pitch_period for _, lt in keep]
                ltm[rs] = quantize_longterm(np.stack([lt.coef for _, lt in keep]))
        return pitches, ltm
