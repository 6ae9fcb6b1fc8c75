"""The row-sharded frame on torch.distributed — port of
sunray_tpu/parallel/spmd.py.

Image rows shard over the ranks of an "sp" process group: each rank
renders its band of hl = H / n rows through the same stages and hand
kernels as the single-device frame (K1, K2 or K14, K3, K4, K8 on the
band's lanes), and the frame's six cross-pixel reads ride explicit halo
exchanges (parallel/halo.py):

  1. ReSTIR DI/GI temporal history reads (halo_t rows; K4 in place and
     K13 on the halo-extended table),
  2. ReSTIR DI/GI spatial-reuse taps (halo_s = max tap radius + 1; K5's
     window form, K6 on taps cut from the window),
  3. the TAA 3x3 neighbourhood clamp (1 row, edge-replicated; K9's
     window form under cfg.taa_kernel "auto" on the card, or "pallas"),
  4. the TAA bilinear history fetch (halo_t rows),
  5. the a-trous denoise taps (2 * step rows a pass; K7's window form),
  6. edge antialiasing's vertical pixel pairs (1 row;
     render/antialias.primary_edge_aa's grid hook). JAX's spmd frame
     leaves the pass out; its render_frame_sharded and training_step,
     which GSPMD splits, run it, and so does this frame.

Semantics against the single-device frame: the same, except that
temporal history whose reprojection crosses more than halo_t rows of a
band boundary is rejected like off-screen history (spmd.py:13-19), and
the ReSTIR shadow-boundary term is left out (pathtrace.py:371). With
whole_frame (sharding.render_frame_sharded, training_step) the term
runs, and render_frame_sharded's halo_t spans the image: the
single-device frame under any motion, as JAX's GSPMD frame is. With
motion below the halo the two agree to reassociation noise; on one rank
the sharded frame is the single-device frame bit for bit.

Every rank runs the same exchanges in the same order (none sits behind
a data-dependent branch), so the walks may end at different rounds on
different ranks; the reported rounds are the group's maximum (the JAX
pmax). Every exchange is differentiable (parallel/halo.py), so a
differentiable frame reads across bands with its gradients.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.profiler import record_function

from sunray_tpu_torch.parallel.halo import (
    ShardGrid,
    group_size_rank,
    host_staged,
    make_grid,
)
from sunray_tpu_torch.render import restir
from sunray_tpu_torch.render.antialias import primary_edge_aa
from sunray_tpu_torch.render.gbuffer import ris_pass
from sunray_tpu_torch.render.pathtrace import final_pass
from sunray_tpu_torch.render.pipeline import RenderState, check_supported
from sunray_tpu_torch.render.postprocess import (
    atrous_denoise_grid,
    temporal_accumulate,
    tonemap,
)
from sunray_tpu_torch.render.trace import make_tracer


def all_reduce_max(values, group=None, device="cpu"):
    """The group's elementwise maximum of a tuple of Python ints (the JAX
    pmax of the walk rounds); the values themselves without a process
    group."""
    if group_size_rank(group)[0] == 1:
        return tuple(values)
    dev = torch.device(device)
    on = "cpu" if dev.type == "cpu" or host_staged(group, dev) else dev
    t = torch.tensor(values, dtype=torch.int64, device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return tuple(int(v) for v in t.tolist())


def _frame_local(scene, cfg, state: RenderState, mats, grid: ShardGrid,
                 accel=None):
    """The per-rank frame body (spmd.py:51-119): pipeline.render_frame with
    every cross-pixel seam routed through the grid's halo exchanges."""
    check_supported(scene, cfg)
    if cfg.differentiable:
        state = state.detach()
    w, hl = cfg.width, grid.hl
    frame_count = state.frame_count

    tracer = make_tracer(scene, cfg, accel)
    lights = restir.Lights(scene) if scene.num_lights > 0 else None

    with record_function("ris_pass"):
        gbuf, r_di, r_gi, hitd, ris_rounds = ris_pass(
            scene, cfg, tracer, lights, mats, state.prev_view_proj,
            state.res_di, state.res_gi, frame_count, grid=grid,
        )
    first_hit = (hitd.first_tri, hitd.first_t)
    with record_function("final_pass"):
        raw, final_rounds = final_pass(
            scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi, frame_count,
            first_hit=first_hit, grid=grid,
        )
        for s in range(1, cfg.samples):
            raw_s, rounds_s = final_pass(
                scene, cfg, tracer, lights, mats, gbuf, r_di, r_gi,
                frame_count, sample_idx=s, first_hit=first_hit, grid=grid,
            )
            raw = raw + raw_s
            final_rounds = final_rounds + rounds_s
    if cfg.samples > 1:
        raw = raw / cfg.samples

    raw_img = raw.reshape(hl, w, 3)
    if cfg.edge_antialias:
        raw_img = primary_edge_aa(scene, cfg, tracer, mats, raw_img,
                                  tri=hitd.first_tri, t_hit=hitd.first_t,
                                  grid=grid)
    accum = raw_img
    if cfg.enable_taa:
        with record_function("taa"):
            accum = temporal_accumulate(
                raw_img, gbuf.motion.reshape(hl, w, 2), state.accum,
                frame_count, cfg.accumulation_factor,
                kernel="jnp" if cfg.differentiable else cfg.taa_kernel,
                history_select_kernel=restir.history_kernel_ok(cfg),
                grid=grid)
    den = accum
    if cfg.denoise_passes > 0:
        with record_function("denoise"):
            den = atrous_denoise_grid(
                accum, gbuf.depth.reshape(hl, w),
                gbuf.normal.reshape(hl, w, 3),
                gbuf.roughness.reshape(hl, w).contiguous(),
                gbuf.diffuse.reshape(hl, w, 3), cfg.denoise_passes, grid,
                kernel="jnp" if cfg.differentiable else cfg.denoise_kernel)
    with record_function("postprocess"):
        ldr = tonemap(den, cfg.exposure, cfg.tonemap, cfg.gamma)

    new_state = RenderState(
        accum=accum,
        res_di=r_di,
        res_gi=r_gi,
        prev_view_proj=mats["view_proj"],
        frame_count=frame_count + 1,
    )
    rounds = all_reduce_max((ris_rounds, final_rounds), grid.group,
                            ldr.device)
    return new_state, ldr, rounds


def _shard_leaf(x, cfg, grid: ShardGrid):
    """This rank's rows of an (H, ...) or (H*W, ...) array (state_specs,
    spmd.py:122-133); anything else whole."""
    h, w = cfg.height, cfg.width
    if x.dim() >= 2 and x.shape[0] == h:
        return x[grid.row0:grid.row0 + grid.hl].contiguous()
    if x.dim() >= 1 and x.shape[0] == h * w:
        return x[grid.row0 * w:(grid.row0 + grid.hl) * w].contiguous()
    return x


def shard_state(state: RenderState, cfg, grid: ShardGrid) -> RenderState:
    """This rank's share of a whole RenderState (any state of the full
    frame, e.g. one converted from the JAX package's by convert.py): the
    rows of every pixel array, the matrices and frame count whole."""
    def cut(x):
        if torch.is_tensor(x):
            return _shard_leaf(x, cfg, grid)
        return type(x)(**{f.name: cut(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    return cut(state)


def make_spmd_step(scene, cfg, group=None, accel=None, whole_frame=False):
    """One frame of the row-sharded pipeline over the ranks of `group`
    (default: every rank). Returns step(state, mats) -> (state', ldr
    band (hl, W, 3), (ris_rounds, final_rounds)); the state is this
    rank's share (shard_state). whole_frame: each band a share of the
    single-device frame (halo.make_grid), as JAX's GSPMD frame; default
    JAX's spmd frame."""
    grid = make_grid(cfg, group, whole_frame)

    def step(state, mats):
        return _frame_local(scene, cfg, state, mats, grid, accel)

    step.grid = grid
    return step


def render_frame_spmd(scene, cfg, state: RenderState, mats, group=None,
                      accel=None, whole_frame=False):
    """One frame through the row-sharded path. A whole state is sharded
    first. For a frame loop build the step once with make_spmd_step."""
    step = make_spmd_step(scene, cfg, group, accel, whole_frame)
    if state.accum.shape[0] == cfg.height and step.grid.hl != cfg.height:
        state = shard_state(state, cfg, step.grid)
    return step(state, mats)


def gather_rows(band, group=None):
    """The whole image from every rank's (hl, ...) band, on every rank of
    `group`, in rank order (the band's device; host copies under gloo)."""
    n, _ = group_size_rank(group)
    if n == 1:
        return band
    staged = host_staged(group, band.device)
    src = band.contiguous().cpu() if staged else band.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=0)
    return out.to(band.device) if staged else out
