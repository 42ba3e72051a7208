"""chip_smoke.py's loader of the previous commit's package, which its
before/after times call through that commit's own wrappers: a copy of
`sla_tpu_torch/` loads under another name, its plain versions run on the
CPU and equal the current ones, and the port's own package stays the one
in sys.modules."""

import importlib
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    return importlib.import_module("chip_smoke")


def test_parent_loader_runs_a_copy_beside_the_port(tmp_path):
    import sla_tpu_torch
    from sla_tpu_torch.kernels import cuda_filters as cf

    smoke = _chip_smoke()
    assert smoke.load_parent(tmp_path, name="sla_tpu_torch_absent") is None
    shutil.copytree(REPO / "sla_tpu_torch", tmp_path / "sla_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    name = "sla_tpu_torch_copy_under_test"
    try:
        prev = smoke.load_parent(tmp_path, name=name)
        assert prev.__name__ == f"{name}.kernels.cuda_filters"
        assert pathlib.Path(prev.__file__).is_relative_to(tmp_path)
        assert sys.modules["sla_tpu_torch"] is sla_tpu_torch
        assert prev is not cf and prev.launches is not cf.launches
        build = importlib.import_module(f"{name}.kernels.build")
        assert build.BUILD_DIR == tmp_path / "build" / "sla_tpu_torch"

        rng = np.random.default_rng(61)
        B, L, p, T, M = 5, 300, 16, 1, 8
        x = torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, (B, L), dtype=np.int32))
        coef = torch.from_numpy(rng.integers(-25000, 25000, (B, p), dtype=np.int32))
        md = torch.tensor([0, 3, 40, 258, 9], dtype=torch.int32)
        q15 = torch.from_numpy(rng.integers(-32768, 32768, (B, T), dtype=np.int32))
        r1 = cf.lattice_predict_plain(x, coef)
        calls = smoke.kernel_calls(cf, x, coef, md, q15, r1, M)
        prev_calls = smoke.kernel_calls(prev, x, coef, md, q15, r1, M)
        assert calls.keys() == prev_calls.keys() == set(cf.launches)
        for k in calls:  # CPU tensors: both wrappers run their plain versions
            assert torch.equal(prev_calls[k](), calls[k]()), k
        assert not any(prev.launches.values()) and not any(cf.launches.values())
    finally:
        for mod in [m for m in sys.modules if m == name or m.startswith(name + ".")]:
            del sys.modules[mod]
    assert sys.modules["sla_tpu_torch"] is sla_tpu_torch


def test_tools_phase_runs_a_tool_and_requires_its_kernels(monkeypatch, tmp_path):
    """Phase 7's runner: a tool in a process of its own, its JSON line read,
    its log kept, and a kernel of its path that never launched refused (on
    the CPU no kernel launches)."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "TOOLS_OUT", tmp_path)
    args = ["fuzz_corruption", "2", "77", "--backend", "host", "--device", "cpu"]
    with pytest.raises(AssertionError, match="never launched"):
        smoke.run_tool("corruption on the cpu", args, (smoke.K9,), 240)
    res = smoke.run_tool("corruption on the cpu", args, (), 240)
    assert (res["tool"], res["cases"], res["failures"]) == ("fuzz_corruption", 2, 0)
    assert res["total_launches"] == dict.fromkeys(smoke.KERNELS, 0)
    assert "2/2 mutants" in res["summary"]
    assert (tmp_path / "corruption_on_the_cpu.log").exists()


def test_tools_phase_fuzz_counts():
    smoke = _chip_smoke()
    counts = {label: int(args[1]) for label, args, _ in smoke.FUZZERS}
    assert counts == {"fuzz_device_entropy": 100, "fuzz_corruption": 200, "fuzz_salvage": 50,
                      "fuzz_streaming": 50, "fuzz_streaming --seek": 20}
    assert smoke.SANITIZED[1][:3] == ["run_sanitized", "fuzz_corruption", "50"]


@pytest.mark.parametrize("host,card,want", [
    # the card no slower from the first size on: the midpoint to 0
    ((1.0, 2.0, 4.0), (0.9, 1.5, 3.0), (1_000_000, 500_000)),
    # the host faster at the smallest size only
    ((1.0, 2.0, 4.0), (1.1, 1.5, 3.0), (2_000_000, 1_500_000)),
    # a slower size above a faster one: the rule starts above it
    ((1.0, 2.0, 4.0), (0.9, 2.1, 3.0), (4_000_000, 3_000_000)),
    # equal counts as no slower
    ((1.0, 2.0, 4.0), (1.1, 2.0, 4.0), (2_000_000, 1_500_000)),
    # the largest size slower on the card: no threshold from the sweep
    ((1.0, 2.0, 4.0), (0.9, 1.5, 4.1), (None, None)),
])
def test_threshold_rule_from_the_sweep(host, card, want):
    """Phase 8's rule for the 'auto' threshold: the smallest swept size from
    which every larger size runs no slower on the card, written as the
    midpoint to the next smaller size, rounded to 100,000 row-samples."""
    smoke = _chip_smoke()
    sizes = (1_000_000, 2_000_000, 4_000_000)
    rows = [{"row_samples": n, "host encode": h, "device encode": c}
            for n, h, c in zip(sizes, host, card)]
    assert smoke.crossover(rows[::-1], "encode") == want
