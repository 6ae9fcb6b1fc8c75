"""BRDF math for the NEE path: ONB, GGX VNDF sampling, cosine hemisphere.

Port of the subset of sunray_tpu/ops/brdf.py that the forward NEE frame
calls, formula for formula (rt_utils.slang:150-201). All functions
broadcast over leading dims; vectors are (..., 3).
"""

from __future__ import annotations

import torch

from sunray_tpu_torch.ops import fp

PI = 3.14159  # the reference uses 3.14159 (not pi) throughout
PI_VNDF = 3.14159265  # sample_ggx_vndf uses the longer constant (rt_utils.slang:192)


def dot(a, b):
    return fp.dot(a, b)


def safe_sqrt(x, eps=1e-20):
    """sqrt with a finite gradient at 0."""
    return torch.sqrt(torch.clamp(x, min=eps))


def vec_norm(v, eps=1e-20):
    """Gradient-safe vector norm."""
    return safe_sqrt(fp.dot(v, v), eps)


def normalize(v, eps=0.0):
    n = vec_norm(v)[..., None]
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


cross = fp.cross


def reflect(i, n):
    """GLSL reflect: i - 2*dot(n,i)*n."""
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i, n, eta):
    """GLSL refract. Returns zero vector on total internal reflection."""
    cosi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    r = eta[..., None] * i - (eta * cosi + safe_sqrt(k))[..., None] * n
    return torch.where(tir[..., None], torch.zeros_like(r), r)


def build_onb(n):
    """Branchless ONB (rt_utils.slang:150-156, Duff et al.). -> (t, b)."""
    sign_n = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign_n + n[..., 2])
    bb = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [
            1.0 + sign_n * n[..., 0] * n[..., 0] * a,
            sign_n * bb,
            -sign_n * n[..., 0],
        ],
        dim=-1,
    )
    b = torch.stack(
        [bb, sign_n + n[..., 1] * n[..., 1] * a, -n[..., 1]],
        dim=-1,
    )
    return t, b


def smith_g1_ggx(NdotX, alpha):
    """rt_utils.slang:165-169."""
    a2 = alpha * alpha
    denom = NdotX + torch.sqrt(a2 + (1.0 - a2) * NdotX * NdotX)
    return 2.0 * NdotX / torch.clamp(denom, min=1e-4)


def cosine_hemisphere(normal, r1, r2):
    """get_random_bounce (rt_utils.slang:171-177)."""
    phi = 2.0 * PI * r1
    r = torch.sqrt(r2)
    u, v = build_onb(normal)
    d = (
        u * (torch.cos(phi) * r)[..., None]
        + v * (torch.sin(phi) * r)[..., None]
        + normal * safe_sqrt(1.0 - r2)[..., None]
    )
    return normalize(d)


def sample_ggx_vndf(normal, v_world, roughness, r1, r2):
    """Heitz VNDF half-vector sampling (rt_utils.slang:179-201)."""
    t, b = build_onb(normal)
    vl = torch.stack(
        [dot(v_world, t), dot(v_world, b), dot(v_world, normal)], dim=-1
    )
    a = torch.clamp(roughness * roughness, min=0.001)
    vh = normalize(
        torch.stack([a * vl[..., 0], a * vl[..., 1], vl[..., 2]], dim=-1)
    )

    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = torch.where(
        lensq > 0.0, 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-30)), 0.0
    )
    t1 = torch.where(
        (lensq > 0.0)[..., None],
        torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)], dim=-1)
        * inv_len[..., None],
        torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device),
    )
    t2 = cross(vh, t1)

    rr = torch.sqrt(r1)
    phi = 2.0 * PI_VNDF * r2
    p1 = rr * torch.cos(phi)
    p2 = rr * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2

    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))[..., None] * vh
    )
    hl = normalize(
        torch.stack(
            [a * nh[..., 0], a * nh[..., 1], torch.clamp(nh[..., 2], min=0.0)],
            dim=-1,
        )
    )
    return t * hl[..., 0:1] + b * hl[..., 1:2] + normal * hl[..., 2:3]
