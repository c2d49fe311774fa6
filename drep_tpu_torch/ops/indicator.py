"""[m, v_pad] 0/1 int8 indicator rows from packed ids: CUDA kernel wrapper
and its plain PyTorch version.

Counterpart of drep_tpu/ops/pallas_indicator.py. Every exact containment
matmul (ops/containment.py) reads these rows: inter[i, j] = <ind_i, ind_j>
over the id vocabulary. Ids >= v_pad (PAD_ID included) contribute nothing.

:func:`indicator` widens a uint16 pack to the int32/PAD_ID contract
first, then runs ``csrc/indicator.cu`` for a CUDA tensor and
:func:`indicator_plain` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from drep_tpu_torch.ops import _build
from drep_tpu_torch.ops.minhash import widen_ids

LAUNCHES = {"indicator": 0}


def indicator_plain(ids: torch.Tensor, v_pad: int) -> torch.Tensor:
    """The JAX package's scatter (containment.py::_indicator, XLA branch):
    every id >= v_pad lands in a trash column that is sliced away."""
    m = ids.shape[0]
    cols = torch.where(ids < v_pad, ids, torch.full_like(ids, v_pad)).to(torch.int64)
    out = torch.zeros((m, v_pad + 1), dtype=torch.int8, device=ids.device)
    out.scatter_(1, cols, 1)
    return out[:, :v_pad].contiguous()


def indicator(ids: torch.Tensor, v_pad: int) -> torch.Tensor:
    """[m, v_pad] int8 indicator of sorted id rows (int32 with PAD_ID, or a
    uint16 pack with 0xFFFF). CUDA tensors run the kernel, CPU tensors the
    plain version."""
    if ids.dim() != 2:
        raise ValueError(f"indicator: want ids [m, W], got {tuple(ids.shape)}")
    if v_pad <= 0 or v_pad % 16:
        raise ValueError(f"indicator: v_pad {v_pad} must be a positive multiple of 16")
    ids = widen_ids(ids).contiguous()
    if ids.device.type == "cpu":
        return indicator_plain(ids, v_pad)
    if ids.device.type != "cuda":
        raise ValueError(f"indicator: unsupported device {ids.device}")
    m, width = ids.shape
    out = torch.empty((m, v_pad), dtype=torch.int8, device=ids.device)
    fn = _build.load("indicator").indicator_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    rc = fn(ids.data_ptr(), out.data_ptr(), m, width, v_pad, _build.stream_handle(ids.device))
    _build.check(rc, "indicator")
    LAUNCHES["indicator"] += 1
    return out
