"""Ratio-optimizing encode: search the encode-parameter space for the
smallest stream.

The reference CLI can only express five preset points (src/main.c:63-76),
but its library API accepts the full parameter space — any PARCOR order,
odd long-term orders, LMS orders, window functions, block sizes
(SLA.h:69-76 via SLAEncoder_SetEncodeParameter, src/SLAEncoder.c:176-224).
None of these choices change the *format*: the window function is
analysis-side only (not stored in the container — format.py), and every
searched field stays within the format/decoder capacity limits
(SLAInternal.h:14), so each candidate — and the winner — is an ordinary
SLA stream the reference binary decodes losslessly. The grid also stays
clear of the one in-capacity value the reference decoder cannot survive:
lms_order_per_filter=0 (see the _KNOBS comment). A caller-supplied
`start` is searched as given — seeding with lms=0 produces streams only
this framework decodes.

Search = coordinate descent over one knob at a time, seeded from a preset.
With `effort=1` the knob trials run on a sampled slice of the file (eight
evenly spaced chunks) and only the finalists are full encodes; `effort=2`
trial-encodes the whole file for every candidate. Either way the result is
guaranteed no larger than the seed preset's stream: the seed is always a
finalist. Every trial encodes on the caller's `device` (None: the CUDA
card), as `Encoder` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import ChannelProcessMethod, WindowFunctionType
from .encoder import Encoder, EncoderConfig, resolve_device
from .errors import ApiResult, SLAError
from .format import EncodeParameter, WaveFormat

# effort-1 trial slice: eight chunks of 3*16384 samples — every candidate
# block size (4096..16384) tiles a chunk, so no candidate is penalized by
# chunk-boundary partials more than another
_SAMPLE_CHUNKS = 8
_SAMPLE_CHUNK_LEN = 3 * 16384

# coordinate-descent grid; the seed's own value is always tried implicitly
# (it is the incumbent). Orders beyond the preset maxima are API-only
# points the reference CLI cannot reach (main.c:94-98 caps them at the
# library limits, but the presets stop at 32/3/8).
_KNOBS: tuple[tuple[str, tuple], ...] = (
    ("parcor_order", (4, 8, 16, 24, 32, 48)),
    (
        "window_function_type",
        (
            WindowFunctionType.SIN,
            WindowFunctionType.HANN,
            WindowFunctionType.BLACKMAN,
            WindowFunctionType.VORBIS,
            WindowFunctionType.RECTANGULAR,
        ),
    ),
    ("longterm_order", (0, 1, 3, 5)),
    # LMS order stays in {4,8,16,32}: the reference decoder masks its ring
    # buffers with (num_coef - 1) and its >=4 / power-of-2 asserts are
    # compiled out under NDEBUG (SLAPredictor.c:1210,1223-1224), so an
    # lms=0 stream SEGFAULTS the reference binary (found by
    # tools/fuzz_identity.py's optimize-contract cases). longterm 0 is
    # fine: the reference decoder synthesizes it correctly even though its
    # own encoder cannot produce it (SLAEncoder.c pitch analysis fails).
    ("lms_order_per_filter", (4, 8, 16, 32)),
    ("max_num_block_samples", (4096, 8192, 12288, 16384)),
    # ch_process_method appended per channel count in _knobs_for
)
_MAX_SWEEPS = 2


def _knobs_for(num_channels: int):
    knobs = list(_KNOBS)
    if num_channels == 2:
        knobs.append(
            (
                "ch_process_method",
                (ChannelProcessMethod.STEREO_MS, ChannelProcessMethod.NONE),
            )
        )
    return knobs


def _sample_slice(data: np.ndarray) -> np.ndarray:
    """Eight evenly spaced chunks of the signal, concatenated (C-order so
    the encoder reads it like any other signal). Returns `data` itself when
    the file fits the trial budget."""
    n = data.shape[1]
    budget = _SAMPLE_CHUNKS * _SAMPLE_CHUNK_LEN
    if n <= budget:
        return data
    starts = np.linspace(0, n - _SAMPLE_CHUNK_LEN, _SAMPLE_CHUNKS).astype(np.int64)
    return np.ascontiguousarray(
        np.concatenate([data[:, s : s + _SAMPLE_CHUNK_LEN] for s in starts], axis=1)
    )


def _trial(
    data: np.ndarray,
    wf: WaveFormat,
    param: EncodeParameter,
    config: EncoderConfig,
    device=None,
) -> bytes | None:
    """Encode one candidate; None when the candidate is invalid for this
    handle/content (capacity-rejected, or content the format cannot carry
    at these parameters — e.g. an initial-Rice overflow)."""
    enc = Encoder(config, device=device)
    enc.set_wave_format(wf)
    try:
        enc.set_encode_parameter(param)
        return enc.encode_whole(data)
    except SLAError:
        return None


def optimize_encode(
    data: np.ndarray,
    wave_format: WaveFormat,
    *,
    start: EncodeParameter | None = None,
    effort: int = 1,
    encoder_config: EncoderConfig | None = None,
    verbose: bool | None = None,
    device=None,
) -> tuple[bytes, EncodeParameter]:
    """Encode `data` with the smallest-stream parameters found.

    `start` seeds the search (default: preset 2 adapted to the channel
    count, like the CLI default). `effort=1` searches on a sampled slice,
    `effort=2` on the whole file. The returned stream is never larger than
    the seed's. When `encoder_config.verify` is set, the chosen stream is
    decoded back and compared with the input before returning (one check
    on the winner — the trial encodes skip it).

    Returns `(stream_bytes, chosen_parameter)`.
    """
    if effort not in (1, 2):
        raise SLAError(ApiResult.INVALID_ARGUMENT, f"optimize effort {effort}")
    device = resolve_device(device)
    final_config = encoder_config or EncoderConfig()
    if verbose is None:
        verbose = final_config.verbose
    # trials: same capacity/backend, but quiet and unverified — the single
    # verify pass runs on the winner below
    trial_config = dataclasses.replace(final_config, verbose=False, verify=False)

    from . import preset_parameter  # local import: package init imports us

    if start is None:
        start = preset_parameter(2, wave_format.num_channels)
    sample = data if effort >= 2 else _sample_slice(data)
    sampled = sample is not data

    best = dataclasses.replace(start)
    best_blob = _trial(sample, wave_format, best, trial_config, device)
    if best_blob is None:
        raise SLAError(
            ApiResult.INVALID_ARGUMENT,
            "seed parameter cannot encode this signal",
        )
    best_size = len(best_blob)
    trials = 1
    # every candidate already trialed this search — a repeat can never beat
    # the incumbent (best_size only shrinks after a candidate loses), so
    # sweep 2 skips sweep-1 losers instead of re-encoding them
    seen = {dataclasses.astuple(best)}
    for _ in range(_MAX_SWEEPS):
        improved = False
        for field, values in _knobs_for(wave_format.num_channels):
            for value in values:
                if getattr(best, field) == value:
                    continue
                cand = dataclasses.replace(best, **{field: value})
                key = dataclasses.astuple(cand)
                if key in seen:
                    continue
                seen.add(key)
                blob = _trial(sample, wave_format, cand, trial_config, device)
                trials += 1
                if blob is not None and len(blob) < best_size:
                    best, best_blob, best_size = cand, blob, len(blob)
                    improved = True
        if not improved:
            break

    if sampled:
        # finalists on the full file: the winner, and the seed as the
        # never-worse guarantee when they differ. Either finalist may be
        # rejected by content outside the sampled slice (e.g. a residual
        # burst overflowing the initial Rice parameter at an extreme
        # order) — keep whichever full-file encode survives, smaller wins.
        final_blob = _trial(data, wave_format, best, trial_config, device)
        if best != start:
            seed_blob = _trial(data, wave_format, start, trial_config, device)
            if final_blob is None or (
                seed_blob is not None and len(seed_blob) <= len(final_blob)
            ):
                best, final_blob = dataclasses.replace(start), seed_blob
        if final_blob is None:
            raise SLAError(
                ApiResult.INVALID_ARGUMENT,
                "no searched parameter can encode this signal",
            )
        best_blob = final_blob

    if final_config.verify:
        # same self-check the plain encode path runs (segment-windowed on
        # long streams): one pass on the winner, trials skip it. The
        # set_* calls are load-bearing: _maybe_verify sizes its decode
        # windows from _segment_samples(), which reads the winner's
        # max_num_block_samples.
        enc = Encoder(final_config, device=device)
        enc.set_wave_format(wave_format)
        enc.set_encode_parameter(best)
        enc._maybe_verify(best_blob, data)

    if verbose:
        best_size = len(best_blob)
        print(
            f"optimize: {trials} trials -> parcor {best.parcor_order}, "
            f"longterm {best.longterm_order}, lms {best.lms_order_per_filter}, "
            f"window {best.window_function_type.name}, "
            f"block {best.max_num_block_samples}, "
            f"ch {best.ch_process_method.name}, {best_size} bytes"
        )
    return best_blob, best
