"""ReSTIR DI / GI reservoirs, the light table, RIS audition and temporal
reuse — port of sunray_tpu/render/restir.py.

The reservoirs ride the frame state with their JAX fields and shapes
(light_idx and sample_tri int32). The merge-heavy steps run through the
K3/K4 wrappers of ops/cuda_restir.py (plain PyTorch on the CPU, the hand
kernels on a card). History reads are direct indexed loads at the
reprojected pixel, the plain-gather branch of the reference
(restir.py:452; ops/banded.py takes it on every backend but the TPU):
no banded or shift ladder. With history_select_kernel="auto" the reads
that are not fused into K4 go through the history gather K13
(ops/cuda_history.py), which moves the same words; with
history_joint_gather one reprojection and one K13 launch read the DI and
GI histories together (gather_temporal_histories). In a row-sharded
frame (grid, parallel/halo.py) the history table is exchanged once with
halo_t rows and read at window-local indices, by the same K4 and K13;
sources beyond the window come back invalid, as restir.py:431-435 has
it.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from sunray_tpu_torch.ops import cuda_history, cuda_restir
from sunray_tpu_torch.ops import rng as rng_mod
from sunray_tpu_torch.ops.brdf import (
    cross,
    dot,
    gi_target_pdf,
    normalize,
    vec_norm,
)
from sunray_tpu_torch.ops.cuda_gather import take_rows
from sunray_tpu_torch.ops.cuda_restir import one_minus_smoothstep, smoothstep
from sunray_tpu_torch.ops.fp import fma, sqrt
from sunray_tpu_torch.ops.loops import checkpointed
from sunray_tpu_torch.parallel.halo import exchange_flat_many, window_index


def _zeros(p, device, *shape):
    return torch.zeros((p, *shape), dtype=torch.float32, device=device)


@dataclasses.dataclass
class ReservoirDI:
    light_pos: torch.Tensor      # (P, 3)
    w_sum: torch.Tensor          # (P,)
    light_normal: torch.Tensor   # (P, 3)
    M: torch.Tensor              # (P,)
    light_idx: torch.Tensor      # (P,) int32
    W: torch.Tensor              # (P,)
    hit_normal: torch.Tensor     # (P, 3)
    depth: torch.Tensor          # (P,)

    @staticmethod
    def empty(p: int, device="cuda") -> "ReservoirDI":
        return ReservoirDI(
            light_pos=_zeros(p, device, 3), w_sum=_zeros(p, device),
            light_normal=_zeros(p, device, 3), M=_zeros(p, device),
            light_idx=torch.zeros((p,), dtype=torch.int32, device=device),
            W=_zeros(p, device), hit_normal=_zeros(p, device, 3),
            depth=_zeros(p, device),
        )


@dataclasses.dataclass
class ReservoirGI:
    sample_pos: torch.Tensor       # (P, 3)
    w_sum: torch.Tensor            # (P,)
    sample_radiance: torch.Tensor  # (P, 3)
    M: torch.Tensor                # (P,)
    sample_normal: torch.Tensor    # (P, 3)
    W: torch.Tensor                # (P,)
    hit_normal: torch.Tensor       # (P, 3)
    depth: torch.Tensor            # (P,)
    sample_tri: torch.Tensor       # (P,) int32, -1 = none

    @staticmethod
    def empty(p: int, device="cuda") -> "ReservoirGI":
        return ReservoirGI(
            sample_pos=_zeros(p, device, 3), w_sum=_zeros(p, device),
            sample_radiance=_zeros(p, device, 3), M=_zeros(p, device),
            sample_normal=_zeros(p, device, 3), W=_zeros(p, device),
            hit_normal=_zeros(p, device, 3), depth=_zeros(p, device),
            sample_tri=torch.full((p,), -1, dtype=torch.int32, device=device),
        )


class Lights:
    """Per-frame world-space light table (the EmissiveIndirection resolve)."""

    def __init__(self, scene):
        lv, le = scene.light_world_triangles()   # (L,3,3), (L,3)
        self.v0 = lv[:, 0]
        self.v1 = lv[:, 1]
        self.v2 = lv[:, 2]
        self.emission = le
        self.num = lv.shape[0]
        # World-triangle id per light, for occlusion-query exclusion.
        self.world_tri = scene.light_world_tri
        self.table = cuda_restir.LightTable(
            *(x.contiguous() for x in (self.v0, self.v1, self.v2, le)))

    def gather(self, idx):
        """Light triangles by index: (v0, v1, v2, emission), idx (N,)."""
        return tuple(take_rows(x, idx) for x in (self.v0, self.v1, self.v2,
                                                  self.emission))

    def sample_point(self, idx, u1, u2):
        """Area-uniform point on light idx (ray_gen_ris.slang:196-210).

        Returns (pos, normal, emission, area)."""
        v0, v1, v2, em = self.gather(idx)
        cr = cross(v1 - v0, v2 - v0)
        area = 0.5 * vec_norm(cr)
        nrm = normalize(cr, eps=1e-12)
        sqr1 = sqrt(u1)
        u = 1.0 - sqr1
        v = u2 * sqr1
        w = 1.0 - u - v
        pos = fma(v2, w[:, None], fma(v0, u[:, None], v1 * v[:, None]))
        return pos, nrm, em, area


def _fields(res) -> dict:
    """The reservoir's fields by name, the tensors themselves
    (dataclasses.asdict deep-copies, which a tensor in a graph refuses)."""
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}


def _where_fields(res, mask, other):
    """Per-field where(mask, res, other) over two reservoirs."""
    out = {}
    for f in dataclasses.fields(res):
        x, e = getattr(res, f.name), getattr(other, f.name)
        m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        out[f.name] = torch.where(m, x, e)
    return type(res)(**out)


def sky_emptied(res, found):
    """Sky pixels store an empty reservoir (ray_gen_ris.slang:160-171)."""
    return _where_fields(res, found, type(res).empty(found.shape[0],
                                                     found.device))


def ris_audition(lights: Lights, seed, hit_pos, hit_normal, v_view, albedo,
                 roughness, metallic, candidates: int, enable, kernel=True,
                 bf16=False):
    """RIS candidate audition (ray_gen_ris.slang:189-231) through K3, or
    through its plain version with kernel=False (a differentiable frame,
    gbuffer.py:295; bf16: its attributes are bf16, ops/brdf.is_bf16).
    Returns (seed, ReservoirDI) with W resolved."""
    args = (lights.table, seed, hit_pos, hit_normal, v_view, albedo,
            roughness, metallic, candidates, enable)
    if kernel:
        seed, f = cuda_restir.ris_audition(*args)
    else:
        # The K candidates' (K, P) planes are recomputed in the backward
        # pass rather than kept (ops/loops.checkpointed).
        seed, f = checkpointed(
            functools.partial(cuda_restir.ris_audition_plain, bf16=bf16),
            *args)
    p = hit_pos.shape[0]
    z = torch.zeros((p,), dtype=torch.float32, device=hit_pos.device)
    return seed, ReservoirDI(hit_normal=torch.zeros_like(hit_pos), depth=z,
                             **f)


def reproject(seed, prev_uv, prev_valid, frame_count, enable, width, height):
    """Jittered history pixel (ray_gen_ris.slang:233-240): two draws, then
    int(prev_pixel + jitter), jitter in [-0.5, 0.5). Returns (seed, pi
    (P,) int64 in range, ok)."""
    seed, j1, j2 = rng_mod.rnd2(seed)
    px = torch.floor(prev_uv[:, 0] * width + (j1 - 0.5)).to(torch.int64)
    py = torch.floor(prev_uv[:, 1] * height + (j2 - 0.5)).to(torch.int64)
    in_bounds = (px >= 0) & (py >= 0) & (px < width) & (py < height)
    ok = enable & prev_valid & in_bounds & (frame_count > 0)
    pi = torch.clamp(py * width + px, 0, width * height - 1)
    return seed, pi, ok


def history_kernel_ok(cfg) -> bool:
    """The gate of the history gather kernel K13 (restir.py:510-517):
    history_select_kernel="auto" on a forward frame. The JAX gate also
    asks for a TPU; here the wrapper launches K13 for tensors on the card
    and runs its plain version on the CPU."""
    return cfg.history_select_kernel == "auto" and not cfg.differentiable


def _read_histories(cfg, reservoirs, idx, grid=None):
    """The reservoirs' fields at idx in one gather (K13 under
    history_kernel_ok, plain indexing otherwise), each w_sum left out and
    returned as zeros: the merges read only the destination's w_sum
    (restir.py:488-507). grid: the fields hold the band's rows and idx is
    global; the fields are exchanged once with halo_t rows and read at
    window-local indices (restir.py:431-435). Returns (reservoirs,
    in-window mask or None)."""
    names = [[f.name for f in dataclasses.fields(r) if f.name != "w_sum"]
             for r in reservoirs]
    fields = [getattr(r, k) for r, ks in zip(reservoirs, names) for k in ks]
    in_band = None
    if grid is not None:
        fields = exchange_flat_many(fields, grid.halo_t, grid)
        idx, in_band = window_index(idx, grid.halo_t, grid)
    gather = (cuda_history.history_gather if history_kernel_ok(cfg)
              else cuda_history.history_gather_plain)
    rows = iter(gather(fields, idx))
    w_sum = torch.zeros((idx.shape[0],), dtype=torch.float32, device=idx.device)
    return [type(r)(w_sum=w_sum, **{k: next(rows) for k in ks})
            for r, ks in zip(reservoirs, names)], in_band


def gather_temporal_histories(cfg, seed, hist_di: ReservoirDI,
                              hist_gi: ReservoirGI, prev_uv, prev_valid,
                              frame_count, width, height, grid=None):
    """history_joint_gather (restir.py:524-568): ONE jittered reprojection
    and ONE gather of the DI and GI histories, where the reference draws a
    jitter for each. Returns (seed, h_di, h_gi, base_ok) with both w_sum
    zeroed; base_ok leaves out each pass's enable mask."""
    seed, pi, base_ok = reproject(seed, prev_uv, prev_valid, frame_count, True,
                                  width, height)
    (h_di, h_gi), in_band = _read_histories(cfg, (hist_di, hist_gi), pi,
                                            grid)
    if in_band is not None:
        base_ok = base_ok & in_band
    return seed, h_di, h_gi, base_ok


def di_temporal_reuse(lights: Lights, cfg, seed, r: ReservoirDI,
                      history: ReservoirDI, prev_uv, prev_valid, frame_count,
                      hit_pos, hit_normal, v_view, albedo, roughness, metallic,
                      virtual_distance, width, height, enable,
                      pregathered=None, grid=None):
    """DI temporal reuse with jittered reprojection and normal/depth
    confidence (ray_gen_ris.slang:233-267). The jitter draw and the
    reprojection come first in the pixel's stream, outside K4, as in the
    reference (pallas_restir.py:903-906); K4 reads the history in place.
    pregathered: (history, base_ok) from gather_temporal_histories; K4
    then reads that history at its own lane. grid: the history holds the
    band's rows; K4 reads it in place in the halo_t window exchanged
    around the band, and a source beyond the window is invalid."""
    if pregathered is not None:
        history, base_ok = pregathered
        ok = enable & base_ok
        pi = torch.arange(hit_pos.shape[0], device=hit_pos.device)
    else:
        seed, pi, ok = reproject(seed, prev_uv, prev_valid, frame_count,
                                 enable, width, height)
        if grid is not None:
            keys = [f.name for f in dataclasses.fields(history)
                    if f.name != "w_sum"]
            ext = exchange_flat_many([getattr(history, k) for k in keys],
                                     grid.halo_t, grid)
            history = dataclasses.replace(
                history, w_sum=torch.zeros_like(ext[0][:, 0]),
                **dict(zip(keys, ext)))
            pi, in_band = window_index(pi, grid.halo_t, grid)
            ok = ok & in_band
    # A differentiable frame keeps JAX's jnp merge (restir.py:596): K4
    # routes no gradient.
    merge_temporal = (
        functools.partial(cuda_restir.di_temporal_plain,
                          bf16=cfg.shading_dtype == "bf16")
        if cfg.differentiable else cuda_restir.di_temporal)
    seed, f = merge_temporal(
        lights.table, seed, _fields(r), _fields(history),
        pi, ok, hit_pos, hit_normal, v_view, albedo, roughness, metallic,
        virtual_distance, cfg.di_temporal_m_clamp, cfg.di_temporal_w_clamp,
    )
    return seed, dataclasses.replace(r, **f)


def gi_temporal_reuse(cfg, seed, r: ReservoirGI, history: ReservoirGI,
                      prev_uv, prev_valid, frame_count, hit_pos, hit_normal,
                      albedo, metallic, virtual_distance, width, height,
                      enable, pregathered=None, grid=None):
    """GI temporal reuse (ray_gen_ris.slang:408-432), plain PyTorch (the
    reference has no kernel for it); the history read is K13's under
    history_kernel_ok. pregathered, grid: as in di_temporal_reuse."""
    if pregathered is not None:
        h, base_ok = pregathered
        ok = enable & base_ok
    else:
        seed, pi, ok = reproject(seed, prev_uv, prev_valid, frame_count,
                                 enable, width, height)
        (h,), in_band = _read_histories(cfg, (history,), pi, grid)
        if in_band is not None:
            ok = ok & in_band
    conf = (smoothstep(0.8, 0.95, dot(hit_normal.float(), h.hit_normal))
            * one_minus_smoothstep(
                0.05, 0.20,
                torch.abs(virtual_distance - h.depth)
                / torch.clamp(virtual_distance, min=1e-4)))
    h_m = torch.clamp(h.M, max=cfg.gi_temporal_m_clamp) * conf
    h_w = torch.clamp(h.W, max=cfg.gi_temporal_w_clamp)
    use = ok & (h_w > 0.0) & (h_m > 0.0)
    bf16 = cfg.shading_dtype == "bf16"
    p_hat_hist = gi_target_pdf(hit_pos, hit_normal, albedo, metallic,
                               h.sample_pos, h.sample_radiance, bf16=bf16)
    seed, u_m = rng_mod.rnd(seed)
    w_sum, m, take = cuda_restir.merge(r.w_sum, r.M, h_m,
                                       p_hat_hist * h_w * h_m, u_m, use)
    t3 = take[:, None]
    r = dataclasses.replace(
        r, w_sum=w_sum, M=m,
        sample_pos=torch.where(t3, h.sample_pos, r.sample_pos),
        sample_normal=torch.where(t3, h.sample_normal, r.sample_normal),
        sample_radiance=torch.where(t3, h.sample_radiance, r.sample_radiance),
        sample_tri=torch.where(take, h.sample_tri, r.sample_tri),
    )
    p_hat_m = gi_target_pdf(hit_pos, hit_normal, albedo, metallic,
                            r.sample_pos, r.sample_radiance, bf16=bf16)
    w_new = torch.where(p_hat_m > 1e-6,
                        r.w_sum / torch.clamp(r.M * p_hat_m, min=1e-9), 0.0)
    return seed, dataclasses.replace(r, W=torch.where(use, w_new, r.W))
