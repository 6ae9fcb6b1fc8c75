"""K8: small-table row gather by clamped index.

Counterpart of sunray_tpu/ops/pallas_gather.py (onehot_gather_cols and
onehot_gather_cols_multi, one kernel here); the kernel is csrc/gather.cu.
The TPU kernels select rows with a one-hot MXU product because dynamic
gathers serialize there. On the card the gather is indexed loads.

gather_rows(table (K, C), idx (G, N)) -> (G, C, N): the (C, N) layout of
the TPU kernel's output, so callers take (N,) columns. Indices clamp to
[0, K-1] as at pallas_gather.py:57,126. float32 and int32 tables are
copied word for word, bit-exact.
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.ops import cuda_build

_DTYPES = (torch.float32, torch.int32)


def gather_rows_plain(table, idx):
    """The plain PyTorch version: (K, C) table, (G, N) int idx -> (G, C, N)."""
    k = table.shape[0]
    rows = table[idx.long().clamp(0, k - 1)]          # (G, N, C)
    return rows.permute(0, 2, 1).contiguous()


def gather_rows(table, idx):
    """Rows of `table` (K, C) at clamped indices `idx` (G, N), as (G, C, N)."""
    if table.dim() != 2 or idx.dim() != 2:
        raise cuda_build.KernelError(
            f"gather_rows: expected (K, C) and (G, N), got "
            f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype not in _DTYPES:
        raise cuda_build.KernelError(f"gather_rows: table dtype {table.dtype}")
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_plain(table, idx)
    dev = cuda_build.require_cuda("gather_rows", table, idx)
    cuda_build.require_dtype("gather_rows", idx, torch.int32)
    k, c = table.shape
    g, n = idx.shape
    if k == 0:
        raise cuda_build.KernelError("gather_rows: empty table")
    out = torch.empty((g, c, n), dtype=table.dtype, device=dev)
    err = cuda_build.library().sunray_gather_rows(
        table.data_ptr(), idx.data_ptr(), k, c, g, n, out.data_ptr(),
        cuda_build.stream_ptr(),
    )
    cuda_build.check_launch("gather_rows", err)
    cuda_build.launches["gather_rows"] += 1
    return out
