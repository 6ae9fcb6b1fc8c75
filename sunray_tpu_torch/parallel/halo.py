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


def group_size_rank(group=None):
    """(ranks, this rank's place) along `group`; (1, 0) without an
    initialised process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def make_grid(cfg, group=None, halos: bool = True) -> ShardGrid:
    """The grid of this rank for cfg, its rows sharded over `group`
    (the asserts of halo.py:61-75). halos=False: for a frame that reads
    across no pixel (sharding.training_step's), which moves no halo, so
    the halo reach is not checked."""
    nshards, index = group_size_rank(group)
    assert cfg.height % nshards == 0, (
        f"height {cfg.height} not divisible by {nshards} row shards"
    )
    hl = cfg.height // nshards
    halo_t = max(int(cfg.history_gather_halo), 1)
    halo_s = int(max(cfg.di_spatial_radius, cfg.gi_spatial_radius)) + 1
    reach = cfg.height - hl  # rows available beyond this shard's band
    if nshards > 1 and halos:
        assert max(halo_t, halo_s) <= reach, (
            f"halo ({max(halo_t, halo_s)} rows) exceeds the {reach} rows the "
            f"rest of the mesh holds; use fewer shards or a taller image"
        )
    return ShardGrid(group=group, nshards=nshards, index=index,
                     row0=index * hl, h=cfg.height, w=cfg.width, hl=hl,
                     halo_t=halo_t, halo_s=halo_s)


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
        peer on one side, so it sends less).
    """

    def __enter__(self):
        global _TALLY
        self._prev = _TALLY
        _TALLY = {"bytes": 0, "calls": 0, "sent_bytes": 0, "sends": 0}
        return _TALLY

    def __exit__(self, *exc):
        global _TALLY
        _TALLY = self._prev
        return False


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


def exchange_rows(x, halo_up: int, halo_dn: int, grid: ShardGrid,
                  edge: str = "zero"):
    """Extend a local (hl, ...) row block with halo rows from neighbours.

    Returns (halo_up + hl + halo_dn, ...). Halo rows whose global row lies
    outside [0, h) are zero-filled (edge="zero") or replicated from the
    local boundary row (edge="edge", the jnp.pad mode="edge" semantics of
    the single-device taps)."""
    hl = x.shape[0]
    n, me = grid.nshards, grid.index
    rest = tuple(x.shape[1:])
    x = x.contiguous()
    stage = None
    ops, recvs = [], []

    def hop_parts(halo, is_up, offset):
        parts = []
        hop, rem = 1, halo
        while rem > 0 and hop <= n - 1:
            take = min(hl, rem)
            # up: my bottom rows go to me + hop, the rows above me come
            # from me - hop; down: the mirror image.
            sl = x[hl - take:] if is_up else x[:take]
            dst = me + hop if is_up else me - hop
            src = me - hop if is_up else me + hop
            nbytes = sl.numel() * sl.element_size()
            if _TALLY is not None:
                _TALLY["bytes"] += nbytes
                _TALLY["calls"] += 1
            nonlocal stage
            if stage is None:
                stage = host_staged(grid.group, x.device)
            if 0 <= dst < n:
                ops.append(dist.P2POp(dist.isend,
                                      sl.cpu() if stage else sl,
                                      _peer(grid, dst), grid.group))
                if _TALLY is not None:
                    _TALLY["sent_bytes"] += nbytes
                    _TALLY["sends"] += 1
            if 0 <= src < n:
                buf = torch.empty((take,) + rest, dtype=x.dtype,
                                  device="cpu" if stage else x.device)
                ops.append(dist.P2POp(dist.irecv, buf, _peer(grid, src),
                                      grid.group))
                recvs.append((offset + len(parts), buf))
                parts.append(None)
            else:
                parts.append(x.new_zeros((take,) + rest))
            rem -= take
            hop += 1
        return parts, rem

    above, rem_up = hop_parts(halo_up, True, 0)
    n_above = len(above)
    below, rem_dn = hop_parts(halo_dn, False, n_above)
    parts = above + below
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for k, buf in recvs:
            parts[k] = buf.to(x.device) if stage else buf
    above, below = parts[:n_above], parts[n_above:]
    if rem_up > 0:   # the halo reaches past the whole mesh: out of image
        above.append(x.new_zeros((rem_up,) + rest))
    if rem_dn > 0:
        below.append(x.new_zeros((rem_dn,) + rest))
    # above parts are ordered nearest-first; rows above stack farthest-first.
    ext = torch.cat(above[::-1] + [x] + below, dim=0)

    if edge == "edge" and (halo_up or halo_dn):
        grow = (grid.row0 - halo_up
                + torch.arange(ext.shape[0], device=x.device))
        mask_shape = (ext.shape[0],) + (1,) * (ext.dim() - 1)
        lo = (grow < 0).reshape(mask_shape)
        hi = (grow >= grid.h).reshape(mask_shape)
        ext = torch.where(lo, x[0:1], torch.where(hi, x[-1:], ext))
    return ext


def exchange_flat(x, halo: int, grid: ShardGrid, edge: str = "zero"):
    """exchange_rows for raster-flat (P, ...) arrays with P = hl * w.
    Returns ((hl + 2 * halo) * w, ...)."""
    img = x.reshape((grid.hl, grid.w) + tuple(x.shape[1:]))
    ext = exchange_rows(img, halo, halo, grid, edge=edge)
    return ext.reshape(((grid.hl + 2 * halo) * grid.w,) + tuple(x.shape[1:]))


def exchange_flat_many(fields, halo: int, grid: ShardGrid):
    """exchange_flat of several (P,) / (P, C) float32 or int32 fields in
    one exchange: their columns packed side by side (int32 as its float32
    bit pattern), the same bytes as one exchange each. Returns the
    extended fields in order."""
    cols = [(f.view(torch.float32) if f.dtype == torch.int32 else f)
            .reshape(f.shape[0], -1) for f in fields]
    ext = exchange_flat(torch.cat(cols, dim=1), halo, grid)
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
