"""Row-halo exchange for the row-sharded frame — port of
sunray_tpu/parallel/halo.py on torch.distributed.

The frame's cross-pixel reads all have a bounded reach in screen space:

  - ReSTIR temporal reuse and the TAA history fetch: the reprojection
    distance (bounded by the configured history halo, halo_t),
  - ReSTIR spatial reuse: the tap radius (30 px DI / 20 px GI),
  - the TAA 3x3 neighbourhood clamp: 1 px,
  - an a-trous pass at step s: 2 * s px.

Under row sharding each reach becomes a halo of rows fetched from the
neighbouring ranks of the "sp" process group. A halo taller than a
rank's band takes several hops, as in the JAX package: hop k moves the
slice that rank i -/+ k owns, and rows beyond the image are zero-filled
(or, with edge="edge", replicated from the boundary row).

The exchange is differentiable: its backward runs the reverse hops, each
halo row's cotangent going back to the rank that owns the row, where the
arrivals are added in a fixed order (the same bits on every run). Every
rank posts its exchanges in program order (none sits behind a
data-dependent branch), and their backwards in the order autograd gives
them, which is the same on every rank: the ranks' graphs differ only in
the walks' round counts, and no exchange sits inside a walk. Each
exchange is numbered; its cotangent messages carry the number, and a
backward that meets another exchange's message raises, on both ranks.
No exchange runs inside a backward pass: a checkpointed function's
recompute would post forward messages among the backward's, so the
frame exchanges before its checkpoints.

Transport: each exchange is one dist.batch_isend_irecv of all its hops
in both directions. Device tensors go to NCCL as they are; under gloo
every send is copied to the host and every receive back to the band's
device, explicitly. Nothing here picks a backend, and nothing moves the
frame to the CPU. Without an initialised process group (or with one
rank) no message is sent: the halos are the out-of-image fill.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from sunray_tpu_torch.ops.cuda_restir import shift_window


@dataclasses.dataclass(frozen=True)
class ShardGrid:
    """Row-sharding context threaded through the render stages; grid=None
    everywhere means the single-device frame."""

    group: object       # the "sp" process group (None: the default group)
    nshards: int        # ranks along sp
    index: int          # this rank's place along sp
    row0: int           # global row of this rank's local row 0
    h: int              # global image height
    w: int              # image width (never sharded)
    hl: int             # local rows per rank (h // nshards)
    halo_t: int         # temporal-history halo rows (reprojection reach)
    halo_s: int         # spatial-reuse halo rows (max tap radius + 1)
    # True: the band is a share of the single-device frame, as GSPMD splits
    # JAX's render_frame (sharding.render_frame_sharded, training_step),
    # so the ReSTIR shadow-boundary term runs; False: JAX's spmd frame
    # (make_spmd_step), which leaves it out (pathtrace.py:371).
    whole_frame: bool = False


def group_size_rank(group=None):
    """(ranks, this rank's place) along `group`; (1, 0) without an
    initialised process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def make_grid(cfg, group=None, whole_frame: bool = False) -> ShardGrid:
    """The grid of this rank for cfg, its rows sharded over `group`
    (the asserts of halo.py:61-75, the halo reach asserted for the halos
    the config exchanges). whole_frame: a share of the
    single-device frame (ShardGrid.whole_frame) whose history halo reaches
    the whole image (halo_t = H - hl), so that no reprojected history is
    discarded at a band edge however fast the camera moves; otherwise
    halo_t is cfg.history_gather_halo, as in JAX's spmd frame."""
    nshards, index = group_size_rank(group)
    assert cfg.height % nshards == 0, (
        f"height {cfg.height} not divisible by {nshards} row shards"
    )
    hl = cfg.height // nshards
    reach = cfg.height - hl  # rows available beyond this shard's band
    halo_t = max(reach if whole_frame else int(cfg.history_gather_halo), 1)
    halo_s = int(max(cfg.di_spatial_radius, cfg.gi_spatial_radius)) + 1
    # The halos this config's frame exchanges: ReSTIR reads both, TAA
    # alone the history's.
    reads = ([halo_t, halo_s] if cfg.lighting == "restir"
             else [halo_t] if cfg.enable_taa else [])
    if nshards > 1 and reads:
        assert max(reads) <= reach, (
            f"halo ({max(reads)} rows) exceeds the {reach} rows the "
            f"rest of the mesh holds; use fewer shards or a taller image"
        )
    return ShardGrid(group=group, nshards=nshards, index=index,
                     row0=index * hl, h=cfg.height, w=cfg.width, hl=hl,
                     halo_t=halo_t, halo_s=halo_s, whole_frame=whole_frame)


# -- traffic accounting ------------------------------------------------------

_TALLY = None


class traffic_tally:
    """Context manager: counts what each exchange_rows on this rank moves
    while the context is open.

    with traffic_tally() as t:
        step(state, mats)
    t["bytes"], t["calls"]: the bytes and number of every hop's slice, the
        count of the JAX package's trace-time tally (the same on every
        rank; tests hold the two equal);
    t["sent_bytes"], t["sends"]: what this rank sent (an edge rank has no
        peer on one side, so it sends less);
    t["grad_bytes"], t["grad_calls"], t["grad_sent_bytes"],
        t["grad_sends"]: the same of the backward exchanges' cotangent
        slices (the columns that carry a gradient; each message's 8-byte
        header left out).
    """

    def __enter__(self):
        global _TALLY
        self._prev = _TALLY
        _TALLY = {f"{p}{k}": 0 for p in ("", "grad_")
                  for k in ("bytes", "calls", "sent_bytes", "sends")}
        return _TALLY

    def __exit__(self, *exc):
        global _TALLY
        _TALLY = self._prev
        return False


# Exchanges made so far, a process group (None: the default group).
_SEQ: dict = {}


def _exchange_id(grid: ShardGrid) -> int:
    """The next exchange's number in its group: every rank of the group
    makes the same exchanges in the same order, so the numbers agree."""
    _SEQ[grid.group] = _SEQ.get(grid.group, 0) + 1
    return _SEQ[grid.group]


def _peer(grid: ShardGrid, i: int) -> int:
    """The global rank of place i along the grid's group (P2POp takes
    global ranks with the group it runs on)."""
    if grid.group is None:
        return i
    return dist.get_global_rank(grid.group, i)


def host_staged(group, device) -> bool:
    """Whether messages of `device`'s tensors over `group` go through
    host copies: gloo with a card's tensors."""
    return (device.type != "cpu"
            and dist.get_backend(group) == dist.Backend.GLOO)


def _hop_plan(hl, halo_up, halo_dn, grid):
    """An exchange's hops in the order it posts them, up hops nearest
    first and then down hops: (is_up, hop, take, row), `row` the first
    row of the hop's slice in the extended block; and (rows above, rows
    below) beyond the whole mesh (out of image, zero-filled)."""
    plan, beyond = [], []
    for is_up, halo in ((True, halo_up), (False, halo_dn)):
        hop, rem, off = 1, halo, 0
        while rem > 0 and hop <= grid.nshards - 1:
            take = min(hl, rem)
            row = halo_up - off - take if is_up else halo_up + hl + off
            plan.append((is_up, hop, take, row))
            off += take
            rem -= take
            hop += 1
        beyond.append(rem)
    return plan, beyond


def _peers(grid, is_up, hop):
    """(the rank this hop's slice goes to, the rank it comes from): up,
    my bottom rows go to me + hop and the rows above me come from
    me - hop; down, the mirror image. None off the mesh."""
    me, n = grid.index, grid.nshards
    dst, src = (me + hop, me - hop) if is_up else (me - hop, me + hop)
    return (dst if 0 <= dst < n else None), (src if 0 <= src < n else None)


def _tally(prefix, nbytes, sends):
    """One hop's slice in the open traffic_tally (prefix "grad_": a hop of
    a backward exchange); `sends`: this rank sends it."""
    if _TALLY is not None:
        _TALLY[prefix + "bytes"] += nbytes
        _TALLY[prefix + "calls"] += 1
        if sends:
            _TALLY[prefix + "sent_bytes"] += nbytes
            _TALLY[prefix + "sends"] += 1


def _exchange(x, halo_up, halo_dn, grid):
    """The forward exchange: x with its halo rows, zero beyond the mesh."""
    hl = x.shape[0]
    rest = tuple(x.shape[1:])
    plan, (beyond_up, beyond_dn) = _hop_plan(hl, halo_up, halo_dn, grid)
    stage = bool(plan) and host_staged(grid.group, x.device)
    ops, recvs, parts = [], [], []
    for is_up, hop, take, _ in plan:
        sl = x[hl - take:] if is_up else x[:take]
        dst, src = _peers(grid, is_up, hop)
        _tally("", sl.numel() * sl.element_size(), dst is not None)
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, sl.cpu() if stage else sl,
                                  _peer(grid, dst), grid.group))
        if src is not None:
            buf = torch.empty((take,) + rest, dtype=x.dtype,
                              device="cpu" if stage else x.device)
            ops.append(dist.P2POp(dist.irecv, buf, _peer(grid, src),
                                  grid.group))
            recvs.append((len(parts), buf))
            parts.append(None)
        else:
            parts.append(x.new_zeros((take,) + rest))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for k, buf in recvs:
            parts[k] = buf.to(x.device) if stage else buf
    above = [p for (is_up, *_), p in zip(plan, parts) if is_up]
    below = [p for (is_up, *_), p in zip(plan, parts) if not is_up]
    # above parts are nearest-first; rows above stack farthest-first.
    return torch.cat([x.new_zeros((beyond_up,) + rest)] + above[::-1] + [x]
                     + below + [x.new_zeros((beyond_dn,) + rest)], dim=0)


# Each cotangent message leads with the exchange's number, as int64.
_HEADER = 8


def _exchange_grad(ct, hl, halo_up, halo_dn, grid, cols, xid):
    """The backward exchange: the reverse hops. The cotangent of every
    halo row this rank received goes back to the row's owner, and the
    cotangents of the rows this rank sent are added into the centre's in
    the plan's order (no atomics: the same bits on every run). cols: the
    last-axis columns that carry a gradient (None: all); the others get
    zeros and move nowhere. A message of another exchange raises."""
    plan, _ = _hop_plan(hl, halo_up, halo_dn, grid)

    def sel(t):
        return (t if cols is None else t[..., cols]).contiguous()

    centre = ct[halo_up:halo_up + hl]
    grad = sel(centre).clone()
    stage = bool(plan) and host_staged(grid.group, ct.device)
    on = "cpu" if stage else ct.device
    ops, recvs = [], []
    for is_up, hop, take, row in plan:
        # The forward's destination sends the cotangent of my slice; its
        # source gets back the cotangent of the rows it sent me.
        owner_of_mine, owner_of_halo = _peers(grid, is_up, hop)
        piece = sel(ct[row:row + take])
        nbytes = piece.numel() * piece.element_size()
        _tally("grad_", nbytes, owner_of_halo is not None)
        if owner_of_halo is not None:
            msg = torch.empty(_HEADER + nbytes, dtype=torch.uint8, device=on)
            msg[:_HEADER].copy_(torch.tensor([xid]).view(torch.uint8))
            msg[_HEADER:].copy_(piece.reshape(-1).view(torch.uint8))
            ops.append(dist.P2POp(dist.isend, msg, _peer(grid, owner_of_halo),
                                  grid.group))
        if owner_of_mine is not None:
            buf = torch.empty(_HEADER + nbytes, dtype=torch.uint8, device=on)
            ops.append(dist.P2POp(dist.irecv, buf, _peer(grid, owner_of_mine),
                                  grid.group))
            recvs.append((is_up, take, owner_of_mine, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for is_up, take, peer, buf in recvs:
        got = int(buf[:_HEADER].cpu().view(torch.int64))
        if got != xid:
            raise RuntimeError(
                f"halo exchange {xid}: its backward received the cotangent "
                f"of exchange {got} from place {peer} of the group: the "
                "ranks ran their backward exchanges in different orders")
        piece = (buf[_HEADER:].view(ct.dtype).to(ct.device)
                 .reshape((take,) + tuple(grad.shape[1:])))
        rows = slice(hl - take, hl) if is_up else slice(0, take)
        grad[rows] += piece
    if cols is None:
        return grad
    out = torch.zeros_like(centre)
    out[..., cols] = grad
    return out


class _Exchange(torch.autograd.Function):
    """exchange_rows' transport, its backward the reverse hops."""

    @staticmethod
    def forward(ctx, x, halo_up, halo_dn, grid, cols, xid):
        ctx.args = (x.shape[0], halo_up, halo_dn, grid, cols, xid)
        return _exchange(x, halo_up, halo_dn, grid)

    @staticmethod
    def backward(ctx, ct):
        return (_exchange_grad(ct, *ctx.args),) + (None,) * 5


def exchange_rows(x, halo_up: int, halo_dn: int, grid: ShardGrid,
                  edge: str = "zero", grad_cols=None):
    """Extend a local (hl, ...) row block with halo rows from neighbours.

    Returns (halo_up + hl + halo_dn, ...). Halo rows whose global row lies
    outside [0, h) are zero-filled (edge="zero") or replicated from the
    local boundary row (edge="edge", the jnp.pad mode="edge" semantics of
    the single-device taps).

    Differentiable in x: the backward runs the reverse hops (_Exchange).
    grad_cols: the columns of the last axis whose cotangents it moves
    (None: all of them). Every rank of the group makes the same exchanges
    in the same order, each numbered in that order; the backward's
    messages carry the number and a mismatch raises. No exchange may run
    inside a backward pass (a checkpoint's recompute would post forward
    messages among the backward's): it raises there."""
    if torch._C._current_graph_task_id() != -1:
        raise RuntimeError(
            "exchange_rows inside a backward pass (a checkpointed function's "
            "recompute?): exchange before the checkpoint and pass the "
            "windows in")
    xid = _exchange_id(grid)
    x = x.contiguous()
    if torch.is_grad_enabled() and x.requires_grad:
        ext = _Exchange.apply(x, halo_up, halo_dn, grid, grad_cols, xid)
    else:
        ext = _exchange(x, halo_up, halo_dn, grid)

    if edge == "edge" and (halo_up or halo_dn):
        grow = (grid.row0 - halo_up
                + torch.arange(ext.shape[0], device=x.device))
        mask_shape = (ext.shape[0],) + (1,) * (ext.dim() - 1)
        lo = (grow < 0).reshape(mask_shape)
        hi = (grow >= grid.h).reshape(mask_shape)
        ext = torch.where(lo, x[0:1], torch.where(hi, x[-1:], ext))
    return ext


def exchange_flat(x, halo: int, grid: ShardGrid, edge: str = "zero",
                  grad_cols=None):
    """exchange_rows for raster-flat (P, ...) arrays with P = hl * w.
    Returns ((hl + 2 * halo) * w, ...)."""
    img = x.reshape((grid.hl, grid.w) + tuple(x.shape[1:]))
    ext = exchange_rows(img, halo, halo, grid, edge=edge,
                        grad_cols=grad_cols)
    return ext.reshape(((grid.hl + 2 * halo) * grid.w,) + tuple(x.shape[1:]))


def exchange_flat_many(fields, halo: int, grid: ShardGrid):
    """exchange_flat of several (P,) / (P, C) float32 or int32 fields in
    one exchange: their columns packed side by side (int32 as its float32
    bit pattern), the same bytes as one exchange each. Returns the
    extended fields in order. The backward moves the cotangents of the
    fields that require grad alone: the int32 columns and the others
    carry none."""
    cols = [(f.view(torch.float32) if f.dtype == torch.int32 else f)
            .reshape(f.shape[0], -1) for f in fields]
    grad_cols, o = [], 0
    for f, c in zip(fields, cols):
        if f.requires_grad:
            grad_cols += range(o, o + c.shape[1])
        o += c.shape[1]
    ext = exchange_flat(torch.cat(cols, dim=1), halo, grid,
                        grad_cols=None if len(grad_cols) == o else grad_cols)
    out, o = [], 0
    for f, c in zip(fields, cols):
        g = ext[:, o:o + c.shape[1]]
        o += c.shape[1]
        if f.dtype == torch.int32:
            g = g.contiguous().view(torch.int32)
        out.append(g.reshape((ext.shape[0],) + tuple(f.shape[1:]))
                   .contiguous())
    return out


def window_index(idx, halo: int, grid: ShardGrid):
    """Window-local lanes of GLOBAL raster indices idx in a table extended
    by `halo` rows: (clamped local index, valid), valid=False for sources
    outside the exchanged window."""
    base = (grid.row0 - halo) * grid.w
    li = idx - base
    nrows = (grid.hl + 2 * halo) * grid.w
    valid = (li >= 0) & (li < nrows)
    return li.clamp(0, nrows - 1), valid


def gather_flat_ext(ext, idx, halo: int, grid: ShardGrid):
    """Rows of a halo-extended flat table at GLOBAL flat indices.

    ext: ((hl + 2 * halo) * w, C) from exchange_flat; idx: (P_local,)
    global raster indices (py * w + px). Returns (rows, valid) where
    valid=False for sources outside the exchanged window (callers treat
    them as invalid history)."""
    li, valid = window_index(idx, halo, grid)
    return ext[li], valid


def shift_flat_ext(x_ext, dx: int, dy: int, halo: int, grid: ShardGrid):
    """The band's view of a halo-extended flat field shifted by (dx, dy):
    lane i (local pixel i) reads source pixel (x + dx, y + dy); |dy| <=
    halo; dx wraps along the row (callers mask off-image sources with
    global coordinates, as with cuda_restir.shift_flat)."""
    if abs(dy) > halo:
        raise ValueError(f"shift dy={dy} beyond the {halo}-row halo")
    return shift_window(x_ext, dx, dy, grid.w, grid.hl, halo)
