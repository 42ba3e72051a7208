"""The codec's filter stages sharded over a mesh of torch devices
(counterpart of sla_tpu/parallel/sharding.py).

The reference encoder iterates two serial axes in one thread: blocks
(SLAEncoder.c:846 `while (encode_offset_sample < num_samples)`) and channels
(SLAEncoder.c:531 `for (ch = 0; ...)`). Each (block, channel) row of a batch
is independent: the format resets every filter at block start
(SLADecoder.c:637-639), so a batch shards over devices with no halo
exchange.

A `Mesh` is a ('blocks', 'channels') grid of devices, as sla_tpu's is, and a
device may repeat in it (the CPU tests' 8-shard mesh, several shards of one
card). In sla_tpu the grid decides which shard_map tile a row lands in; in
torch every shard is its own tensor and its own launch, so the grid's shape
cannot change an output or the work done. A sharded batch (`Sharded`) is
therefore the (B, ...) rows cut into contiguous slices, one a device of the
grid in row-major order: no padding rows and nothing to trim.
`SLA_TPU_MESH_CHANNELS` still shapes the grid (and raises as sla_tpu's
does when the device count does not divide), for parity only.

Each `sharded_*` function runs one stage of `pipeline.py` on every shard —
the CUDA kernel on a CUDA shard, the plain version on a CPU shard —
launching every shard before it reads any result back. Per-row host
parameters (pitch, long-term coefficients) stay numpy, as `pipeline.py`
takes them, and are sliced per shard. The only cross-shard value is
`sharded_encode_step`'s `gmax`, the reference's `pmax`: the shards' maxima
are reduced onto the first shard's device and read once.

Not carried over from sla_tpu:

- `_vary`: shard_map's varying-axis typing of scan carries; a torch shard
  is an ordinary tensor.
- `batch_sharding`: a JAX `NamedSharding`; `shard_batch` places the shards
  itself.
- `_mesh_use_pallas`, `mesh_window_plans` and the Pallas mesh bodies
  `sharded_decode_step_pallas`, `sharded_encode_stage1_pallas` and
  `sharded_encode_stage2_pallas`: the gate between the scan and Pallas
  bodies and the long-term window plan (lag sort, per-shard tile bases)
  are TPU scaffolding. The port's kernels take every lag and any (B, L),
  so the functions below already run K1-K4 on every CUDA shard.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import debug, pipeline
from ..errors import ApiResult, SLAError

BLOCK_AXIS = "blocks"
CHANNEL_AXIS = "channels"
# the shard count of the mesh an Encoder or Decoder builds. None: one shard
# a card of pipeline.mesh_cards on a CUDA device, and 8 on the CPU (the 8
# virtual devices sla_tpu's tests run on). The shards take the cards in
# turn, so a count above the card count puts several shards on a card.
SHARDS: int | None = None


class Mesh:
    """A (blocks, channels) grid of torch devices. `devices` is a 2-D
    object array of torch.device; `shape` maps each axis name to its
    size, as jax.sharding.Mesh.shape does."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh needs a non-empty 2-D device grid, got {devices.shape}")
        self.devices = devices
        self.shape = {BLOCK_AXIS: devices.shape[0], CHANNEL_AXIS: devices.shape[1]}


def mesh_devices(device) -> list[torch.device]:
    """The SHARDS devices an encoder or decoder on `device` shards over."""
    device = torch.device(device)
    if device.type == "cuda":
        cards = pipeline.mesh_cards(device)
        n = SHARDS or len(cards)
    elif device.type == "cpu":
        cards, n = [device], SHARDS or 8
    else:
        raise ValueError(f"no mesh for device {device}")
    return [cards[i % len(cards)] for i in range(n)]


def make_mesh(devices=None, channel_parallel: int | None = None) -> Mesh:
    """Build a ('blocks', 'channels') mesh over the given devices (a device
    may repeat). None takes every visible CUDA card and raises without one.

    `channel_parallel` devices go to the channel axis, the rest to the
    block axis. None reads SLA_TPU_MESH_CHANNELS (default 1, pure block
    parallelism)."""
    if channel_parallel is None:
        channel_parallel = max(int(os.environ.get("SLA_TPU_MESH_CHANNELS", "1")), 1)
    if devices is None:
        if torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: torch finds no CUDA device; pass the devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n % channel_parallel != 0:
        raise ValueError(f"{n} devices not divisible by channel_parallel={channel_parallel}")
    grid = np.empty((n,), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n // channel_parallel, channel_parallel))


@dataclasses.dataclass
class Sharded:
    """A (B, ...) batch as contiguous row slices, one tensor a shard on its
    shard's device, in the mesh's row-major device order."""

    parts: list[torch.Tensor]

    @property
    def shape(self) -> tuple[int, ...]:
        return (sum(t.shape[0] for t in self.parts),) + tuple(self.parts[0].shape[1:])

    def slices(self):
        """(rows of the batch, tensor) for every shard."""
        r0 = 0
        for t in self.parts:
            yield slice(r0, r0 + t.shape[0]), t
            r0 += t.shape[0]


def shard_batch(mesh: Mesh, *arrays) -> tuple[Sharded, ...]:
    """Place (B, ...) arrays, numpy or torch, with the same B on the mesh:
    rows cut into one contiguous slice a device (fewer when B is below the
    device count), each slice a tensor of its own on its device; a torch
    array goes device to device."""
    devices = list(mesh.devices.flat)
    B = arrays[0].shape[0]
    n = max(min(len(devices), B), 1)
    cuts = [k * B // n for k in range(n + 1)]
    out = []
    for a in arrays:
        parts = []
        for k in range(n):
            part = a[cuts[k] : cuts[k + 1]]
            if isinstance(part, np.ndarray):
                part = torch.from_numpy(np.ascontiguousarray(part))
            parts.append(part.to(devices[k]).contiguous())
        out.append(Sharded(parts))
    return tuple(out)


def gather(x: Sharded) -> np.ndarray:
    """The whole (B, ...) batch on the host; int32 shards come through
    pipeline.fetch_int32 (as int16 when every value fits)."""
    return np.concatenate([
        pipeline.fetch_int32(t) if t.dtype == torch.int32 else t.cpu().numpy()
        for t in x.parts
    ])


def gather_to(x: Sharded, device) -> torch.Tensor:
    """The whole (B, ...) batch as one tensor on `device`, copied from the
    shards' devices without a trip through the host."""
    device = torch.device(device)
    if len(x.parts) == 1 and x.parts[0].device == device:
        return x.parts[0]
    return torch.cat([t.to(device) for t in x.parts])


def _reject_assert_mode() -> None:
    """sla_tpu's checkify asserts cannot be functionalized through
    shard_map, so its mesh functions refuse assert mode; the port keeps the
    same contract. The encoder demotes the mesh to the device path in
    assert mode instead."""
    if debug.asserts_enabled():
        raise SLAError(
            ApiResult.INVALID_ARGUMENT,
            "SLA_TPU_DEBUG_ASSERTS is not supported on the mesh path",
        )


def sharded_encode_stage1(data: Sharded, parcor_coef: Sharded, parcor_order: int) -> Sharded:
    """Pre-emphasis + lattice predict (K1) on every shard of a (B, L)
    int32 batch; parcor_coef (B, p) sharded alike. The first half of the
    encode cascade: pitch analysis sits between the stages on the host."""
    _reject_assert_mode()
    return Sharded([
        pipeline.encode_stage1(t, c, parcor_order)
        for t, c in zip(data.parts, parcor_coef.parts)
    ])


def sharded_encode_stage2(residual: Sharded, pitch: np.ndarray, ltm_coef: np.ndarray,
                          num_taps: int, lms_order: int) -> Sharded:
    """Long-term + LMS predict (K2) on every shard of the stage-1 residual.
    pitch (B,) and ltm_coef (B, >=T) are host numpy; a row with pitch 0
    skips the long-term stage (pipeline.encode_stage2)."""
    _reject_assert_mode()
    return Sharded([
        pipeline.encode_stage2(t, pitch[rows], ltm_coef[rows], num_taps, lms_order)
        for rows, t in residual.slices()
    ])


def sharded_decode_step(residual: Sharded, parcor_coef: Sharded, pitch: np.ndarray,
                        ltm_coef: np.ndarray, parcor_order: int, num_taps: int,
                        lms_order: int) -> Sharded:
    """The synthesis cascade (K3) on every shard: the decode mirror of
    sharded_encode_step. residual (B, L) int32 and parcor_coef sharded,
    pitch and ltm_coef host numpy. Returns PCM rows before the MS inverse
    and the final left shift. sla_tpu's `lt_chunk` (samples per long-term
    scan step, from the batch's shortest lag) has no counterpart: K3 takes
    every lag in its per-sample loop."""
    _reject_assert_mode()
    return Sharded([
        pipeline.decode_stage(t, c, pitch[rows], ltm_coef[rows], parcor_order, num_taps,
                              lms_order)
        for (rows, t), c in zip(residual.slices(), parcor_coef.parts)
    ])


def sharded_encode_step(data: Sharded, parcor_coef: Sharded, pitch: np.ndarray,
                        ltm_coef: np.ndarray, parcor_order: int, num_taps: int,
                        lms_order: int):
    """The whole encode cascade for known parameters (K4,
    pipeline.encode_filters_fused) on every shard.

    data: (B, L) int32 and parcor_coef (B, p) sharded; pitch (B,) and
    ltm_coef (B, T) host numpy.

    Returns (residual (B, L), abs_sum (B,) int64, bits (B,) float32, gmax
    float): the final residual, each row's zigzag magnitude sum (the
    initial Rice parameter numerator, SLACoder.c:361-385), each row's crude
    bit-length estimate (2 + log2(mean)) * L over the row length L, and its
    maximum over every shard. gmax is a reduction smoke value, not the
    header's `max_block_size`, which the host computes from the real
    encoded block sizes (SLAEncoder.c:890-898)."""
    _reject_assert_mode()
    L = data.shape[1]
    res, sums, bits = [], [], []
    for (rows, t), c in zip(data.slices(), parcor_coef.parts):
        out = pipeline.encode_filters_fused(t, c, pitch[rows], ltm_coef[rows], parcor_order,
                                            num_taps, lms_order)
        wide = out.to(torch.int64)
        abs_sum = torch.where(wide < 0, -2 * wide - 1, 2 * wide).sum(dim=1)
        mean = torch.clamp(abs_sum // L, min=1)
        res.append(out)
        sums.append(abs_sum)
        bits.append((2 + torch.log2(mean.to(torch.float32))) * L)
    first = bits[0].device
    gmax = float(torch.stack([b.max().to(first) for b in bits]).max())
    return Sharded(res), Sharded(sums), Sharded(bits), gmax
