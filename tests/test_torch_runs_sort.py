"""The runs path's radix sort (K8's backward above 512 rows), on the CPU.

The kernels (csrc/gather.cu: sort_hist_kernel, sort_pass_kernel) run only
on the card; here their plain models are held to what they must give:
- runs_digit_plan, a pure function of K: the ids' own ceil(log2 K) bits
  in the fewest passes of at most SORT_DIGIT_BITS bits, widths as even
  as can be;
- runs_sort_model, the passes as the kernels compute each key's slot
  (histogram, look-back over tiles, warps, items, lanes), gives
  torch.sort(stable=True)'s keys and permutation of the clamped ids, for
  K = 513, 2,698, 262,144, 8,388,608 and 2^31 - 1, with out-of-range
  indices, heavy duplicates, all-equal keys and no index at all;
- gather_rows_bwd_runs_model, whose short runs are summed a position at a
  time over all runs at once, is bit-equal to one run at a time.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread, as every port test)
from sunray_tpu_torch.ops import cuda_build, cuda_gather

KS = [513, 2698, 262_144, 8_388_608, 2 ** 31 - 1]
# 3 x 7,001 keys: five full tiles of SORT_TILE and a partial one.
G, N = 3, 7001


def test_digit_plan():
    """Widths least significant first, covering ceil(log2 K) bits (at
    least 1) in the fewest passes of at most SORT_DIGIT_BITS, as even as
    can be; the code packs a width a nibble."""
    want = {1: [1], 2: [1], 3: [2], 512: [9], 513: [5, 5], 1024: [5, 5],
            2698: [6, 6], 262_144: [9, 9], 262_145: [7, 6, 6],
            8_388_608: [8, 8, 7], 2 ** 31 - 1: [8, 8, 8, 7]}
    for k, plan in want.items():
        assert cuda_gather.runs_digit_plan(k) == plan, k
    for k in [1, 2, 5, 513, 4097, 70_001, 2 ** 20, 2 ** 31 - 1]:
        plan = cuda_gather.runs_digit_plan(k)
        bits = max(1, (k - 1).bit_length())
        assert sum(plan) == bits and max(plan) - min(plan) <= 1
        assert max(plan) <= cuda_gather.SORT_DIGIT_BITS
        assert len(plan) == -(-bits // cuda_gather.SORT_DIGIT_BITS)
        assert len(plan) <= cuda_gather.SORT_MAX_PASSES
        code = cuda_gather.plan_code(plan)
        assert [(code >> (4 * p)) & 15 for p in range(len(plan))] == plan
        assert code >> (4 * len(plan)) == 0
    for k in (0, 2 ** 31):
        with pytest.raises(cuda_build.KernelError):
            cuda_gather.runs_digit_plan(k)


def _indices(k, pattern, seed):
    """(G, N) int32 row ids: "uniform" over [-5, K + 5) (clamped at both
    ends), "heavy" four in five on six rows (two out of range), "equal"
    one row, "ends" only out-of-range ids (two runs, at 0 and K - 1),
    "none" no index."""
    rng = np.random.default_rng(seed)
    hi = min(k + 5, 2 ** 31)
    idx = rng.integers(-5, hi, size=(G, N), dtype=np.int64)
    if pattern == "heavy":
        hot = np.asarray([-2, 0, 7 % k, k // 2, k - 1, hi - 1])
        idx = np.where(rng.random((G, N)) < 0.8, hot[rng.integers(0, 6, (G, N))],
                       idx)
    elif pattern == "equal":
        idx = np.full((G, N), k // 3)
    elif pattern == "ends":
        idx = np.where(rng.random((G, N)) < 0.5, -1 - rng.integers(0, 9, (G, N)),
                       hi - 1 - rng.integers(0, min(4, hi - k), (G, N)))
    elif pattern == "none":
        idx = idx[:, :0]
    return torch.from_numpy(idx.astype(np.int32))


@pytest.mark.parametrize("pattern", ["uniform", "heavy", "equal", "ends",
                                     "none"])
@pytest.mark.parametrize("k", KS)
def test_sort_model_is_torch_sort(k, pattern):
    idx = _indices(k, pattern, seed=k % 1000)
    keys, pos = cuda_gather.runs_sort_model(idx, k)
    want_keys, want_pos = torch.sort(idx.reshape(-1).long().clamp(0, k - 1),
                                     stable=True)
    assert torch.equal(keys, want_keys)
    assert torch.equal(pos, want_pos)
    # The CPU's runs_sort is the same sort, in int32.
    got = cuda_gather.runs_sort(idx, k)
    assert all(x.dtype == torch.int32 for x in got)
    assert torch.equal(got[0].long(), want_keys)
    assert torch.equal(got[1].long(), want_pos)


def test_sort_model_one_warp_item():
    """Inside one item of one warp, equal digits rank in lane order: 32
    keys on three digits of the first pass, the rest of the tile empty."""
    k = 2698
    lanes = torch.tensor([5, 64 + 5, 3, 5, 128 + 3] * 6 + [5, 3],
                         dtype=torch.int32)[None]
    keys, pos = cuda_gather.runs_sort_model(lanes, k)
    want_keys, want_pos = torch.sort(lanes.reshape(-1).long(), stable=True)
    assert torch.equal(keys, want_keys) and torch.equal(pos, want_pos)


def _runs_model_run_by_run(ct, idx, k):
    """gather_rows_bwd_runs_model's order, one run at a time."""
    g, c, n = ct.shape
    vals = ct.permute(0, 2, 1).reshape(-1, c).double()
    rows = idx.long().clamp(0, k - 1).reshape(-1)
    srow, perm = torch.sort(rows, stable=True)
    vals = vals[perm]
    out = torch.zeros((k, c), dtype=torch.float64)
    present, counts = torch.unique_consecutive(srow, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    for r, lo, cnt in zip(present.tolist(), starts.tolist(), counts.tolist()):
        run = vals[lo:lo + cnt]
        if cnt <= cuda_gather.RUN_SHORT:
            acc = torch.zeros((c,), dtype=torch.float64)
            for e in range(cnt):
                acc = acc + run[e]
            out[r] = acc
            continue
        tot = None
        for q in range(0, cnt, cuda_gather.RUN_CHUNK):
            part = cuda_gather._block_sum(run[q:q + cuda_gather.RUN_CHUNK])
            tot = part if tot is None else tot + part
        out[r] = tot
    return out.to(torch.float32)


@pytest.mark.parametrize("k,c,pattern", [(513, 4, "heavy"), (2698, 20, "uniform"),
                                         (70_001, 9, "ends")])
def test_runs_model_short_runs_at_once(k, c, pattern):
    """The model's short runs summed over all runs a position at a time are
    bit-equal to each run summed alone (runs of 1 to 32 and longer)."""
    idx = _indices(k, pattern, seed=c)
    rng = np.random.default_rng(k)
    # Runs of every length up to RUN_SHORT + 1: row r repeated r % 34 times.
    extra = torch.repeat_interleave(torch.arange(34), torch.arange(34))
    idx = torch.cat([idx.reshape(-1), extra.to(torch.int32)])[None]
    ct = torch.from_numpy(rng.standard_normal((1, c, idx.shape[1]))
                          .astype(np.float32))
    got = cuda_gather.gather_rows_bwd_runs_model(ct, idx, k)
    want = _runs_model_run_by_run(ct, idx, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
