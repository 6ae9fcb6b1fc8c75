"""K8: small-table row gather by clamped index.

Counterpart of sunray_tpu/ops/pallas_gather.py (onehot_gather_cols and
onehot_gather_cols_multi, one kernel here); the kernel is csrc/gather.cu.
The TPU kernels select rows with a one-hot MXU product because dynamic
gathers serialize there. On the card the gather is indexed loads.

gather_rows(table (K, C), idx (G, N)) -> (G, C, N): the (C, N) layout of
the TPU kernel's output, so callers take (N,) columns. Indices clamp to
[0, K-1] as at pallas_gather.py:57,126. float32 and int32 tables are
copied word for word, bit-exact.

The launch counts keep the two TPU kernels apart: "gather_rows" for one
index vector (G = 1, onehot_gather_cols, K8a), "gather_rows_multi" for
several (onehot_gather_cols_multi, K8b).

A float32 table that requires grad gathers through an autograd Function
whose backward is the custom_vjp of the TPU kernels
(pallas_gather.py:111-119, 178-190), a segment-sum of the cotangent
rows: gather_rows_bwd, a hand kernel on the card ("gather_rows_bwd" in
the launch counts) for tables of up to MAX_ROWS rows and the runs path
above (gather_rows_bwd_runs: a stable radix sort of the row ids by hand,
then each run of equal rows summed by hand kernels in one fixed order;
"gather_rows_bwd_runs"), index_add_ on the CPU. An int32 table has no
gradient. The texel fetches of ops/texture.py take the same backward.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sunray_tpu_torch.ops import cuda_build

_DTYPES = (torch.float32, torch.int32)
# csrc/gather.cu's backward launch shape (sunray_gather_bwd_launch_shape;
# checked when the library loads): the most rows, columns a pass, warps a
# block, indices a lane a step, groups of blocks.
MAX_ROWS = 512
MAX_COLS = 16
BWD_MAX_WARPS = 8
BWD_VEC = 4
BWD_MAX_GROUPS = 64
BWD_LAUNCH_SHAPE = (MAX_ROWS, MAX_COLS, BWD_MAX_WARPS, BWD_VEC,
                    BWD_MAX_GROUPS)
# csrc/gather.cu's runs path (sunray_gather_runs_launch_shape): threads a
# block of its sums (a chunk's order), the longest run summed alone in
# index order, columns a pass, positions of a long run's chunk; threads a
# block of its sort, keys a thread of a sort tile, the widest digit, the
# most passes.
RUN_THREADS = 256
RUN_SHORT = 32
RUN_COLS = 4
RUN_CHUNK = 2048
SORT_THREADS = 256
SORT_ITEMS = 16
SORT_DIGIT_BITS = 9
SORT_MAX_PASSES = 4
RUN_SHAPE = (RUN_THREADS, RUN_SHORT, RUN_COLS, RUN_CHUNK, SORT_THREADS,
             SORT_ITEMS, SORT_DIGIT_BITS, SORT_MAX_PASSES)
SORT_TILE = SORT_THREADS * SORT_ITEMS          # keys a block of a pass
BWD_STEP = 32 * BWD_VEC         # indices a warp a step
BWD_BLOCKS_SM = 2               # blocks an SM at most (__launch_bounds__)
# An H100's shared memory: a block may take 227 KB, an SM holds 228 KB and
# keeps 1 KB of it for each resident block.
SMEM_BLOCK = 227 * 1024
SMEM_SM = 228 * 1024


def gather_rows_plain(table, idx):
    """The plain PyTorch version: (K, C) table, (G, N) int idx -> (G, C, N)."""
    k = table.shape[0]
    rows = table[idx.long().clamp(0, k - 1)]          # (G, N, C)
    return rows.permute(0, 2, 1).contiguous()


def gather_rows_bwd_plain(ct, idx, k):
    """The plain backward: (G, C, N) cotangent, (G, N) idx -> (K, C)
    gradient of the table, index_add_ of the (G * N, C) cotangent rows at
    the clamped indices."""
    c = ct.shape[1]
    rows = ct.permute(0, 2, 1).reshape(-1, c)
    dtab = torch.zeros((k, c), dtype=ct.dtype, device=ct.device)
    return dtab.index_add_(0, idx.long().clamp(0, k - 1).reshape(-1), rows)


def gather_rows_bwd_runs_model(ct, idx, k):
    """A plain model of the runs path's order of work (float64 sums, as
    the kernels take them, rounded to float32 once): the clamped row ids
    in a stable order, each run of equal rows summed in index order by
    one thread up to RUN_SHORT indices; a longer run cut into chunks of
    RUN_CHUNK positions, each summed by RUN_THREADS threads (thread t
    every RUN_THREADS-th position from t), the threads of a warp added by
    the shuffle butterfly, the warps in order, and the chunks' sums added
    in chunk order. For tests: the short runs a position at a time over
    all of them, the long runs one by one."""
    g, c, n = ct.shape
    vals = ct.permute(0, 2, 1).reshape(-1, c).double()
    rows = idx.long().clamp(0, k - 1).reshape(-1)
    srow, perm = torch.sort(rows, stable=True)
    vals = vals[perm]
    out = torch.zeros((k, c), dtype=torch.float64)
    present, counts = torch.unique_consecutive(srow, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    short = counts <= RUN_SHORT
    lo, cnt = starts[short], counts[short]
    acc = torch.zeros((lo.numel(), c), dtype=torch.float64)
    for e in range(RUN_SHORT):
        live = cnt > e
        acc[live] = acc[live] + vals[lo[live] + e]
    out[present[short]] = acc
    for r, lo, cnt in zip(present[~short].tolist(), starts[~short].tolist(),
                          counts[~short].tolist()):
        run = vals[lo:lo + cnt]
        tot = None
        for q in range(0, cnt, RUN_CHUNK):
            part = _block_sum(run[q:q + RUN_CHUNK])
            tot = part if tot is None else tot + part
        out[r] = tot
    return out.to(torch.float32)


def runs_digit_plan(k):
    """The runs path's radix digits for row ids below k, least significant
    first: the ids' own ceil(log2 k) bits (at least 1) in as few passes of
    at most SORT_DIGIT_BITS bits as cover them, the widths as even as can
    be (the atlas's 23 bits: 8, 8, 7; 262,144 triangles: 9, 9; 2,698
    vertices: 6, 6)."""
    if k < 1 or k > 2 ** 31 - 1:
        raise cuda_build.KernelError(f"gather_rows_bwd_runs: {k} rows")
    bits = max(1, (k - 1).bit_length())
    passes = -(-bits // SORT_DIGIT_BITS)
    return [bits // passes + (p < bits % passes) for p in range(passes)]


def plan_code(plan):
    """A digit plan as the kernels take it: pass p's width in bits
    4p..4p+3."""
    return sum(b << (4 * p) for p, b in enumerate(plan))


def runs_sort_model(idx, k):
    """A plain model of the runs path's radix sort: (sorted clamped ids,
    their indices), int64, as the kernels compute them pass by pass
    (runs_digit_plan). A pass splits the keys in tiles of SORT_TILE, a
    tile in SORT_THREADS // 32 warps of SORT_ITEMS x 32 consecutive keys
    (item, then lane); a key's slot is its digit's first slot (the
    exclusive sum of the histogram), plus the digit's count in the tiles
    before (the look-back), in the warps before in its tile, in the items
    before in its warp, and in the lanes below of its own item. For
    tests."""
    keys = idx.reshape(-1).long().clamp(0, k - 1)
    pos = torch.arange(keys.numel())
    shift = 0
    for bits in runs_digit_plan(k):
        dest = _sort_pass_slots((keys >> shift) & ((1 << bits) - 1), 1 << bits)
        keys = torch.empty_like(keys).index_copy_(0, dest, keys)
        pos = torch.empty_like(pos).index_copy_(0, dest, pos)
        shift += bits
    return keys, pos


def _sort_pass_slots(digit, radix):
    """Each key's slot in one pass of runs_sort_model."""
    total = digit.numel()
    warps = SORT_THREADS // 32
    tiles = -(-total // SORT_TILE)
    # Past the end: a digit of its own (radix), never placed.
    d = torch.cat([digit, digit.new_full((tiles * SORT_TILE - total,),
                                         radix)])
    d = d.reshape(tiles, warps, SORT_ITEMS, 32)
    lanes = (d[..., :, None] == d[..., None, :]).tril(-1).sum(-1)
    per_item = torch.zeros((tiles, warps, SORT_ITEMS, radix + 1),
                           dtype=torch.long).scatter_add_(
        3, d, torch.ones_like(d))
    items = torch.cumsum(per_item, 2) - per_item
    per_warp = per_item.sum(2)
    warps_before = torch.cumsum(per_warp, 1) - per_warp
    per_tile = per_warp.sum(1)
    tiles_before = torch.cumsum(per_tile, 0) - per_tile
    hist = per_tile.sum(0)[:radix]
    first = torch.cumsum(hist, 0) - hist
    t = torch.arange(tiles)[:, None, None, None]
    w = torch.arange(warps)[None, :, None, None]
    slot = (first[d.clamp(max=radix - 1)] + tiles_before[t, d]
            + warps_before[t, w, d] + items.gather(3, d)
            + lanes)
    return slot.reshape(-1)[:total]


def runs_sort(idx, k):
    """The runs path's sort alone: (the clamped ids of idx (G, N) in a
    stable order, the index of each), int32; torch.sort(stable=True) on
    CPU tensors, the hand radix sort on CUDA tensors (for its tests and
    its timing; "gather_runs_sort" in the launch counts)."""
    name = "gather_runs_sort"
    rows = idx.reshape(-1)
    if cuda_build.on_cpu(idx):
        keys, pos = torch.sort(rows.long().clamp(0, k - 1), stable=True)
        return keys.to(torch.int32), pos.to(torch.int32)
    cuda_build.require_cuda(name, idx)
    cuda_build.require_dtype(name, idx, torch.int32)
    if idx.numel() >= 2 ** 31:
        raise cuda_build.KernelError(f"{name}: {idx.numel()} indices")
    kernels = cuda_build.library()
    plan = plan_code(runs_digit_plan(k))
    total = rows.numel()
    scratch = _runs_scratch(kernels, total, plan, k, 0, idx.device)
    keys = torch.empty((total,), dtype=torch.int32, device=idx.device)
    pos = torch.empty_like(keys)
    cuda_build.check_launch(name, kernels.sunray_gather_runs_sort(
        idx.data_ptr(), total, k, plan, scratch.data_ptr(), keys.data_ptr(),
        pos.data_ptr(), cuda_build.stream_ptr()))
    cuda_build.launches[name] += 1
    return keys, pos


def _runs_scratch(lib, total, plan, k, item_cap, dev):
    """The runs path's int32 scratch, sized by the library."""
    words = ctypes.c_int64()
    cuda_build.check_launch("gather_rows_bwd_runs", lib.sunray_gather_runs_scratch(
        total, plan, k, item_cap, ctypes.byref(words)))
    return torch.empty((words.value,), dtype=torch.int32, device=dev)


def _block_sum(rows):
    """The float64 sum of rows (M, C) as a block of RUN_THREADS threads
    takes it (gather_rows_bwd_runs_model)."""
    c = rows.shape[1]
    pad = -rows.shape[0] % RUN_THREADS
    lanes = torch.cat([rows, rows.new_zeros((pad, c))]).reshape(
        -1, RUN_THREADS, c)
    acc = torch.zeros((RUN_THREADS, c), dtype=torch.float64)
    for step in lanes:
        acc = acc + step
    acc = acc.reshape(RUN_THREADS // 32, 32, c)
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    tot = acc[0, 0]
    for w in range(1, RUN_THREADS // 32):
        tot = tot + acc[w, 0]
    return tot


def gather_rows_bwd(ct, idx, k):
    """The table's gradient (K, C) from the cotangent ct (G, C, N) of
    gather_rows(table (K, C), idx (G, N)): gather_rows_bwd_plain on CPU
    tensors; on CUDA tensors the kernel for K <= MAX_ROWS (ct made
    contiguous) and the runs path above (ct read through its strides).
    Deterministic: two runs give the same bits."""
    if ct.dim() != 3 or idx.dim() != 2 or tuple(idx.shape) != (ct.shape[0],
                                                               ct.shape[2]):
        raise cuda_build.KernelError(
            f"gather_rows_bwd: expected (G, C, N) and (G, N), got "
            f"{tuple(ct.shape)} and {tuple(idx.shape)}")
    if cuda_build.on_cpu(ct, idx):
        return gather_rows_bwd_plain(ct, idx, k)
    name = "gather_rows_bwd" if k <= MAX_ROWS else "gather_rows_bwd_runs"
    if k <= MAX_ROWS:
        ct = ct.contiguous()
    cuda_build.require_cuda(name, idx)
    if ct.device != idx.device:
        raise cuda_build.KernelError(f"{name}: ct on {ct.device}, idx on "
                                     f"{idx.device}")
    cuda_build.require_dtype(name, ct, torch.float32)
    cuda_build.require_dtype(name, idx, torch.int32)
    if k < 1:
        raise cuda_build.KernelError(f"{name}: {k} rows")
    if k <= MAX_ROWS:
        return _launch_bwd(ct, idx, k)
    if ct.numel() >= 2 ** 31 or k * ct.shape[1] >= 2 ** 31:
        raise cuda_build.KernelError(
            f"{name}: {ct.numel()} cotangents into {k} x {ct.shape[1]}: the "
            "kernels index in 32 bits")
    return _launch_bwd_runs(ct, idx, k)


def bwd_launch_shape(total, k, c, sms):
    """gather_rows_bwd's launch for total = G * N indices into a (k, c)
    table on a card of `sms` SMs: {"warps": warps a block, "blocks",
    "warp_chunk": indices a warp (a multiple of BWD_STEP), "group_blocks":
    blocks a group, "groups", "smem": dynamic shared memory a block,
    bytes}. A pure function of its arguments, so two runs on one card sum
    in one order. Each warp holds a (k, w) table and a (32, w) staging
    row, w = min(c, MAX_COLS); the block takes as many warps as shared
    memory allows up to BWD_MAX_WARPS, an SM up to BWD_BLOCKS_SM blocks,
    the indices cut in equal slices of whole steps (BWD_STEP indices) over
    every SM's blocks, and no block left without an index (the last
    block's last warps may find none)."""
    if not (1 <= k <= MAX_ROWS and c >= 1 and sms >= 1 and total >= 0):
        raise cuda_build.KernelError(
            f"gather_rows_bwd: no launch for {total} indices into {k} x {c} "
            f"on {sms} SMs")
    w = min(c, MAX_COLS)
    warp_bytes = 4 * (k + 32) * w
    warps = min(BWD_MAX_WARPS, SMEM_BLOCK // warp_bytes)
    smem = warps * warp_bytes
    per_sm = max(1, min(BWD_BLOCKS_SM, SMEM_SM // (smem + 1024)))
    steps = -(-total // BWD_STEP)
    blocks = min(sms * per_sm, BWD_MAX_GROUPS ** 2, -(-steps // warps))
    if blocks == 0:
        return dict(warps=warps, blocks=0, warp_chunk=BWD_STEP,
                    group_blocks=1, groups=0, smem=smem)
    warp_chunk = -(-steps // (blocks * warps)) * BWD_STEP
    blocks = -(-total // (warps * warp_chunk))       # none without an index
    group_blocks = math.isqrt(blocks - 1) + 1          # ceil(sqrt(blocks))
    return dict(warps=warps, blocks=blocks, warp_chunk=warp_chunk,
                group_blocks=group_blocks, groups=-(-blocks // group_blocks),
                smem=smem)


def bwd_vec(ct, idx):
    """The width of a lane's loads: BWD_VEC (one 16-byte load of idx and
    of each column a step) where N is a multiple of it and both tensors
    start on 16 bytes, else 1 (a word at a time). A lane takes BWD_VEC
    consecutive indices a step either way, so the sums' order does not
    depend on where the tensors lie."""
    aligned = ct.data_ptr() % 16 == 0 and idx.data_ptr() % 16 == 0
    return BWD_VEC if ct.shape[2] % BWD_VEC == 0 and aligned else 1


_SMS = {}


def _sm_count(dev):
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def _launch_bwd(ct, idx, k, lib=None):
    """gather_rows_bwd once on checked arguments, from `lib` (default: the
    port's library, whose launches are counted)."""
    name = "gather_rows_bwd"
    g, c, n = ct.shape
    kernels = cuda_build.library() if lib is None else lib
    shape = bwd_launch_shape(g * n, k, c, _sm_count(ct.device))
    # The blocks' and groups' (k, c) partials, then the groups' tickets and
    # the last group's (zeroed by the call).
    partial = torch.empty(((shape["blocks"] + shape["groups"]) * k * c
                           + shape["groups"] + 1,),
                          dtype=torch.float32, device=ct.device)
    dtab = torch.empty((k, c), dtype=torch.float32, device=ct.device)
    err = kernels.sunray_gather_rows_bwd(
        ct.data_ptr(), idx.data_ptr(), k, c, g, n, bwd_vec(ct, idx),
        shape["warps"], shape["blocks"], shape["warp_chunk"],
        shape["group_blocks"], partial.data_ptr(), dtab.data_ptr(),
        cuda_build.stream_ptr())
    cuda_build.check_launch(name, err)
    if lib is None:
        cuda_build.launches[name] += 1
    return dtab


def _launch_bwd_runs(ct, idx, k, lib=None):
    """The runs path once on checked arguments, from `lib` (default: the
    port's library, whose launches are counted): the hand radix sort of
    the clamped ids (runs_digit_plan), then the sums kernels; one call."""
    name = "gather_rows_bwd_runs"
    g, c, n = ct.shape
    total = g * n
    kernels = cuda_build.library() if lib is None else lib
    plan = plan_code(runs_digit_plan(k))
    # The long runs' chunks: at most 2 total / (RUN_SHORT + 1) + 1.
    item_cap = 2 * total // (RUN_SHORT + 1) + 1
    scratch = _runs_scratch(kernels, total, plan, k, item_cap, ct.device)
    partial = torch.empty((item_cap, c), dtype=torch.float64,
                          device=ct.device)
    dtab = torch.empty((k, c), dtype=torch.float32, device=ct.device)
    sg, sc, sn = ct.stride()
    err = kernels.sunray_gather_rows_bwd_runs(
        ct.data_ptr(), sg, sc, sn, n, total, idx.data_ptr(), k, c, plan,
        scratch.data_ptr(), item_cap, partial.data_ptr(), dtab.data_ptr(),
        cuda_build.stream_ptr())
    cuda_build.check_launch(name, err)
    if lib is None:
        cuda_build.launches[name] += 1
    return dtab


class _GatherRows(torch.autograd.Function):
    """gather_rows with the segment-sum backward; saves only idx."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return _gather(table, idx)

    @staticmethod
    def backward(ctx, ct):
        idx, = ctx.saved_tensors
        return gather_rows_bwd(ct, idx, ctx.rows), None


def take_rows(table, idx):
    """table[idx] for a float32 (K, C) table and an integer idx of any
    shape: (*idx.shape, C). Where the table requires grad, through
    gather_rows (its backward K8's segment sum; the reference gathers
    tables of at most SELECT_GATHER_MAX_ROWS rows with select chains whose
    transpose is a masked sum, sunray_tpu/ops/linalg.py:27), because
    plain indexing's backward on the card walks each row's indices in one
    thread: a 720p step's 14.7M light-candidate indices into a 2-row
    light table took 0.84 s a call on an H100; else plain indexing."""
    if not (table.requires_grad and torch.is_grad_enabled()):
        return table[idx.long()]
    rows = gather_rows(table.contiguous(), idx.reshape(1, -1).to(torch.int32))
    return rows[0].T.reshape(*idx.shape, table.shape[1])


def gather_rows(table, idx):
    """Rows of `table` (K, C) at clamped indices `idx` (G, N), as (G, C, N).
    Differentiable in a float32 table (gather_rows_bwd)."""
    if table.requires_grad and torch.is_grad_enabled():
        if table.dtype != torch.float32:
            raise cuda_build.KernelError(
                f"gather_rows: a {table.dtype} table has no gradient")
        return _GatherRows.apply(table, idx)
    return _gather(table, idx)


def _gather(table, idx):
    if table.dim() != 2 or idx.dim() != 2:
        raise cuda_build.KernelError(
            f"gather_rows: expected (K, C) and (G, N), got "
            f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype not in _DTYPES:
        raise cuda_build.KernelError(f"gather_rows: table dtype {table.dtype}")
    if cuda_build.on_cpu(table, idx):
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
    cuda_build.launches["gather_rows" if g == 1 else "gather_rows_multi"] += 1
    return out
