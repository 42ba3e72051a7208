"""Opt-in overflow asserts (SLA_TPU_DEBUG_ASSERTS=1), counterpart of
sla_tpu/debug.py.

The reference peppers its hot loops with `SLA_Assert` (disabled by NDEBUG
in release builds, e.g. the per-tap LMS overflow checks at
src/SLAPredictor.c:1265-1271). sla_tpu embeds `checkify.check` calls in its
scan kernels under this variable; here the plain PyTorch versions of the
filters carry the same checks as explicit range tests on their own device:
LMS tap products (kernels/lms.py), lattice stage products both directions
(kernels/lattice.py), and the long-term synthesis prediction range
(kernels/longterm.py). A run collects its checks' results on the device
and raises the message of the first one that failed, in the order they
were made, after the loop, with one host sync: what checkify's
`err.throw()` does.

A hand-written CUDA kernel carries no check, as a Pallas kernel carries no
`checkify.check` in sla_tpu; so with the variable set the pipeline runs the
checked plain versions on the encoder's or decoder's own device (CUDA
tensors on the card) in place of the kernels, as sla_tpu runs its checked
scans in place of Pallas (sla_tpu/pipeline.py encode_stage1,
encode_stage2, decode_stage). That route is the assert mode's semantics
and is taken only when the variable is set; they compute the same values.
Off by default, exactly like NDEBUG. The native C++ cascades carry the
same checks in the -DSLA_TPU_DEBUG build that SLA_TPU_NATIVE_DEBUG=1
selects (native/__init__.py).
"""

from __future__ import annotations

import os

import torch

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def asserts_enabled() -> bool:
    return bool(os.environ.get("SLA_TPU_DEBUG_ASSERTS"))


class DebugAssertError(RuntimeError):
    """A check of the assert mode failed."""


def fits_int32(v: torch.Tensor) -> torch.Tensor:
    """All of the int64 values `v` lie in the int32 range (0-d bool)."""
    return torch.all((v >= INT32_MIN) & (v <= INT32_MAX))


class Checks:
    """The checks of one run, kept on the device: `check(ok, msg)` records
    a 0-d bool that must hold, `raise_first()` raises the message of the
    first one that did not."""

    def __init__(self) -> None:
        self._ok: list[torch.Tensor] = []
        self._msgs: list[str] = []

    def check(self, ok: torch.Tensor, msg: str) -> None:
        self._ok.append(ok)
        self._msgs.append(msg)

    def raise_first(self) -> None:
        if not self._ok:
            return
        failed = ~torch.stack(self._ok)
        if bool(failed.any()):
            raise DebugAssertError(self._msgs[int(failed.nonzero()[0, 0])])
