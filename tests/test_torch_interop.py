"""The carry-across functions of amg_tpu_torch.interop place their tensors
as every entry point of the port does: ``device`` None means ``"cuda"``,
which raises without a CUDA device; ``device="cpu"`` builds on the CPU.
Bad inputs raise ValueError before any device is chosen.

The inputs are numpy arrays taken from the port's own CPU hierarchy, so no
JAX state is needed. CUDA is reported absent through monkeypatch, so the
checks hold on a machine with a card too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from amg_tpu_torch import interop
from amg_tpu_torch.parallel.structured_dist import DistConfig
from amg_tpu_torch.structured import build_stencil_hierarchy_device

torch.set_num_threads(1)

SIDE = 15


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _hier_arrays():
    h = build_stencil_hierarchy_device(SIDE, dtype=torch.float64,
                                       device="cpu")
    P1s = [getattr(h, f"P1_{l}").numpy() for l in range(h.n_levels - 1)]
    # the port keeps LAPACK's 1-based pivots; interop takes JAX's 0-based
    return (h.sides, list(h.w33s), h.coarse_lu.numpy(),
            h.coarse_piv.numpy() - 1, P1s)


def _planes():
    return np.random.default_rng(0).random((3, 3, SIDE, SIDE))


def _df():
    hi = np.random.default_rng(1).standard_normal((4, 8, 8)).astype(
        np.float32)
    return hi, (hi * 1e-8).astype(np.float32)


def _cfg():
    sides = (SIDE, 7, 3)
    return dataclasses.asdict(DistConfig(
        n_devices=2, sides=sides, blocks=(8,), n_sharded=1,
        w33s=(((0.0, -1.0, 0.0), (-1.0, 4.0, -1.0), (0.0, -1.0, 0.0)),)))


CALLS = {
    "hierarchy_from_numpy":
        lambda **kw: interop.hierarchy_from_numpy(*_hier_arrays(), **kw),
    "dist_hierarchy_from_numpy":
        lambda **kw: interop.dist_hierarchy_from_numpy(
            _cfg(), *_hier_arrays(), **kw),
    "planes_from_numpy": lambda **kw: interop.planes_from_numpy(_planes(),
                                                                **kw),
    "df32_from_numpy": lambda **kw: interop.df32_from_numpy(*_df(), **kw),
}


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, torch.nn.Module):
        return list(out.buffers())
    if isinstance(out, tuple) and len(out) == 2 and isinstance(
            out[1], torch.nn.Module):
        return list(out[1].buffers())
    return [out.hi, out.lo]


@pytest.mark.parametrize("name", sorted(CALLS))
def test_no_device_means_cuda(name, no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CALLS[name]()


@pytest.mark.parametrize("name", sorted(CALLS))
def test_cpu_when_asked(name, no_cuda):
    ts = _tensors(CALLS[name](device="cpu"))
    assert ts and all(t.device.type == "cpu" for t in ts)


def test_bad_input_raises_before_the_device(no_cuda):
    with pytest.raises(ValueError):
        interop.planes_from_numpy(np.zeros((3, 3, 5, 4)))
    hi, lo = _df()
    with pytest.raises(ValueError):
        interop.df32_from_numpy(hi.astype(np.float64), lo)
