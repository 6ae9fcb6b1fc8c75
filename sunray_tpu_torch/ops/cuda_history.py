"""K13: the history gather — many fields read at one per-lane source index.

Counterpart of sunray_tpu/ops/pallas_window.py (window_select_t); the
kernel is csrc/history.cu. On the TPU the temporal history reads become a
window select over a transposed, padded (C, P) table behind a ladder of
motion tests (ops/banded.py), a workaround for dynamic gathers. What they
compute is a bit-preserving gather of history rows, which is what
history_gather does: each field at idx, in one launch, with no table
built. Indices clamp to [0, P-1] (every caller's are in range already).

window_select(table_t, key, g, taps) is the TPU kernel's function over
the same gather, so the tests can hold K13 to window_select_t itself.
"""

from __future__ import annotations

import ctypes

import torch

from sunray_tpu_torch.ops import cuda_build

MAX_FIELDS = 16     # csrc/history.cu kMaxFields
_DTYPES = (torch.float32, torch.int32)


def history_gather_plain(fields, idx):
    """The plain PyTorch version: [f[idx] for f in fields]."""
    p = fields[0].shape[0]
    i = idx.long().clamp(0, p - 1)
    return [f[i] for f in fields]


def history_gather(fields, idx):
    """Each of `fields` ((P,) or (P, k) float32/int32, one P) at the
    (M,) int64 indices `idx`: a list of (M,) / (M, k) tensors, bit-exact."""
    name = "history_gather"
    fields = list(fields)
    if not fields or len(fields) > MAX_FIELDS:
        raise cuda_build.KernelError(f"{name}: {len(fields)} fields, expected "
                                     f"1-{MAX_FIELDS}")
    p = fields[0].shape[0]
    for f in fields:
        if f.dtype not in _DTYPES or f.dim() not in (1, 2) or f.shape[0] != p:
            raise cuda_build.KernelError(
                f"{name}: fields must be (P,) or (P, k) float32/int32 with one "
                f"P, got {f.dtype} {tuple(f.shape)}")
    if idx.dim() != 1:
        raise cuda_build.KernelError(f"{name}: idx must be (M,)")
    if cuda_build.on_cpu(*fields, idx):
        return history_gather_plain(fields, idx)
    cuda_build.require_cuda(name, *fields, idx)
    cuda_build.require_dtype(name, idx, torch.int64)
    if p == 0:
        raise cuda_build.KernelError(f"{name}: empty fields")
    return _launch_gather(fields, idx)


def _launch_gather(fields, idx, lib=None):
    """K13 once on checked arguments, from `lib` (default: the port's
    library, whose launches are counted)."""
    m, k = idx.shape[0], len(fields)
    outs = [torch.empty((m, *f.shape[1:]), dtype=f.dtype, device=idx.device)
            for f in fields]
    srcs = (ctypes.c_void_p * k)(*(f.data_ptr() for f in fields))
    dsts = (ctypes.c_void_p * k)(*(o.data_ptr() for o in outs))
    widths = (ctypes.c_int * k)(*(1 if f.dim() == 1 else f.shape[1]
                                  for f in fields))
    kernels = cuda_build.library() if lib is None else lib
    err = kernels.sunray_history_gather(
        srcs, dsts, widths, k, idx.data_ptr(), m, fields[0].shape[0],
        cuda_build.stream_ptr())
    cuda_build.check_launch("history_gather", err)
    if lib is None:
        cuda_build.launches["history_gather"] += 1
    return outs


def window_select(table_t, key, g, taps, pad_l=0):
    """out[:, i] = table_t[:, pad_l + i + g + taps[key[i]]] for a (C, P')
    table (window_select_t's function, pallas_window.py:139-160; lanes with
    key < 0 read taps[0], which the callers mask). Returns (C, P)."""
    p = key.shape[0]
    taps = torch.as_tensor(taps, dtype=torch.int64, device=key.device)
    src = (torch.arange(p, device=key.device) + (pad_l + int(g))
           + taps[key.long().clamp(min=0)])
    return torch.stack(history_gather(list(table_t), src))
