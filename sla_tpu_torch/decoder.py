"""SLA decoder with the synthesis cascade on PyTorch (counterpart of
sla_tpu/decoder.py).

`Decoder` subclasses sla_tpu's host decoder (loaded through
`sla_tpu_torch.host`, without jax) and replaces the methods that reach jax:
backend selection, the device-entropy policy, and `_synth_outputs`, the
synthesis of every COMPRESSDATA block that `decode_whole`, `decode_block`,
`decode_range` and `decode_salvage` all reach. Its host branch is the
native C++ cascade; its device branch is the port's decode stage (K3) on
the decoder's torch device. Backends as in sla_tpu_torch.encoder; 'mesh'
and on-chip entropy decoding are not ported yet.
"""

from __future__ import annotations

import numpy as np

from .host import native
from .host.constants import BlockDataType
from .host.decoder import Decoder as _HostDecoder
from .host.decoder import DecoderConfig, _fill_block_filter_rows, _synth_group_rows
from . import pipeline
from .encoder import resolve_device


class Decoder(_HostDecoder):
    def __init__(self, config: DecoderConfig | None = None, device=None):
        super().__init__(config)
        self.device = resolve_device(device)

    def _select_backend(self, row_samples: int) -> str:
        return pipeline.select_backend(self.config.backend, row_samples, self.device)

    def _device_entropy_on(self, backend: str) -> bool:
        return pipeline.device_entropy_on(self.config, backend)

    def _synth_outputs(self, blocks, payloads, premade=None) -> dict[int, np.ndarray]:
        """Run the synthesis chain for every COMPRESSDATA block; returns
        block index -> (C, n) rows (before the MS inverse / left shift).

        premade: optional (n_comp*C, L) residual batch already laid out in
        block order (native.get_data_arrays_strided); either backend then
        skips assembling the batch."""
        wf, ep = self._wave_format, self._encode_param
        C = wf.num_channels
        p, T, M = ep.parcor_order, ep.longterm_order, ep.lms_order_per_filter
        comp_all = [
            i for i, b in enumerate(blocks) if b.block_type == BlockDataType.COMPRESSDATA
        ]
        outputs: dict[int, np.ndarray] = {}
        L = ep.max_num_block_samples
        backend = self._select_backend(sum(blocks[i].num_samples for i in comp_all) * C)
        # bound the synthesis batch buffer (~100 MB) for very long streams
        max_group = _synth_group_rows(C, L)
        use_premade = (
            isinstance(premade, np.ndarray)
            and len(comp_all) <= max_group
            and premade.shape == (len(comp_all) * C, L)
        )
        for g in range(0, len(comp_all), max_group):
            comp_idx = comp_all[g : g + max_group]
            B = len(comp_idx) * C
            coef = np.zeros((B, p), dtype=np.int32)
            pitch = np.zeros((B,), dtype=np.int32)
            ltm = np.zeros((B, max(T, 1)), dtype=np.int32)
            lengths = np.zeros((B,), dtype=np.int64)
            residual = premade if use_premade else np.zeros((B, L), dtype=np.int32)
            for bi, i in enumerate(comp_idx):
                blk = blocks[i]
                if not use_premade:
                    residual[bi * C : (bi + 1) * C, : blk.num_samples] = payloads[i]
                _fill_block_filter_rows(blk, bi, C, coef, pitch, ltm, lengths)
            if backend == "host":
                synth = native.synth_rows(residual, coef, pitch, ltm, T, M, lengths)
            else:
                dev = self.device
                synth = pipeline.decode_stage(
                    pipeline.to_rows(residual, dev), pipeline.to_rows(coef, dev),
                    pitch, ltm, p, T, M,
                ).cpu().numpy()
            for bi, i in enumerate(comp_idx):
                outputs[i] = synth[bi * C : (bi + 1) * C, : blocks[i].num_samples]
        return outputs
