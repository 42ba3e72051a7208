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
