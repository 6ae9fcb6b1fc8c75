"""Reservoirs and the light table — the part of sunray_tpu/render/restir.py
(restir.py:44-165) that the NEE frame needs.

The reservoirs ride the frame state with their JAX shapes; the NEE path
only carries them (empty) from frame to frame. RIS audition, temporal and
spatial reuse are the next port slice.
"""

from __future__ import annotations

import dataclasses

import torch

from sunray_tpu_torch.ops.brdf import cross, normalize, vec_norm
from sunray_tpu_torch.ops.fp import fma


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
    def empty(p: int, device="cpu") -> "ReservoirDI":
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
    def empty(p: int, device="cpu") -> "ReservoirGI":
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

    def gather(self, idx):
        """Light triangles by index: (v0, v1, v2, emission), idx (N,)."""
        idx = idx.long()
        return self.v0[idx], self.v1[idx], self.v2[idx], self.emission[idx]

    def sample_point(self, idx, u1, u2):
        """Area-uniform point on light idx (ray_gen_ris.slang:196-210).

        Returns (pos, normal, emission, area)."""
        v0, v1, v2, em = self.gather(idx)
        cr = cross(v1 - v0, v2 - v0)
        area = 0.5 * vec_norm(cr)
        nrm = normalize(cr, eps=1e-12)
        sqr1 = torch.sqrt(u1)
        u = 1.0 - sqr1
        v = u2 * sqr1
        w = 1.0 - u - v
        pos = fma(v2, w[:, None], fma(v0, u[:, None], v1 * v[:, None]))
        return pos, nrm, em, area
