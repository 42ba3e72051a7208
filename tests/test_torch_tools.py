"""The port's on-card tools, run on the CPU at a tiny size: every check of
the verify twin and the bench twin must pass (each wrapper runs its plain
version here), and without a CUDA device each tool's main() exits non-zero
and the bench's timing refuses to run."""

import pytest
import torch

from sla_tpu_torch.tools import bench_device, verify_device


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_verify_checks_pass_on_cpu():
    results = verify_device.run_checks("cpu", rows=8, samples=2048, cascade_rows=8,
                                       pcm_samples=4096)
    assert len(results) == 14
    assert [name for name, ok in results if not ok] == []


def test_bench_checks_pass_on_cpu():
    results = bench_device.check_cells("cpu", rows=8, samples=2048)
    assert len(results) == 4
    assert [name for name, ok in results if not ok] == []


def test_bench_cells_share_inputs():
    bs = bench_device.batches("cpu", rows=4, samples=64)
    assert set(bs) == set(bench_device.CELLS)
    assert bs["encode_fused"] is bs["decode_fused"] is bs["encode_stage12"]
    low = bs["decode_fused_low_pitch"].pitch
    assert low.min() >= 40 and low.max() < 120


@pytest.mark.parametrize("tool", [verify_device, bench_device])
def test_main_exits_nonzero_without_cuda(no_cuda, tool, capsys):
    assert tool.main() != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_timing_needs_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_device.time_cells(rows=4, samples=64)
