"""Camera model — port of sunray_tpu/camera.py.

Right-handed look-at view, OpenGL-convention perspective and the Vulkan
y-flip (camera.rs:33-63); ray generation as in ray_gen_ris.slang:44-53.
Matrices act on column vectors. Every contraction is an fp32 elementwise
multiply-sum (no matmul, so no TF32 path exists), as the JAX code avoids
bf16 on the TPU's matrix unit (sunray_tpu/camera.py:187-207). Ray
generation rounds as XLA's CPU backend compiles the reference (ops/fp.py):
a division by a constant pixel count is a multiply by its float32
reciprocal, and multiply-adds are fused.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from sunray_tpu_torch.ops.fp import dot3, fma, sqrt

Z_NEAR = 0.1   # camera.rs:44
Z_FAR = 100.0  # camera.rs:45

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Camera:
    """Position/target/fov camera (camera.rs:3-8). Angles in degrees."""

    position: Tuple[float, float, float] = (0.0, 0.0, 1.0)  # or a (3,) tensor
    target: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    fov_y: float = 45.0

    def set_position(self, p) -> "Camera":
        return dataclasses.replace(self, position=tuple(p))

    def set_target(self, t) -> "Camera":
        return dataclasses.replace(self, target=tuple(t))

    def set_fov_y(self, f) -> "Camera":
        return dataclasses.replace(self, fov_y=float(f))


def _point(p, device):
    """A camera point as a float32 (3,) tensor on `device`; a tensor stays
    in its graph."""
    if torch.is_tensor(p):
        return p.to(device=device, dtype=_F32)
    return torch.tensor(p, dtype=_F32, device=device)


def _norm(v):
    return sqrt((v * v).sum(dim=-1, keepdim=True))


def _cross(a, b):
    """Unfused cross product: camera_matrices runs eagerly in the
    reference, op by op, so nothing there is fused."""
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _matmul(a, b):
    """fp32 (n, k) @ (k, m) as an elementwise multiply-sum."""
    return (a[:, :, None] * b[None, :, :]).sum(dim=1)


def look_at_rh(eye, target, up):
    """Right-handed look-at view matrix (nalgebra Isometry3::look_at_rh)."""
    zaxis = eye - target
    zaxis = zaxis / _norm(zaxis)
    xaxis = _cross(up, zaxis)
    xaxis = xaxis / _norm(xaxis)
    yaxis = _cross(zaxis, xaxis)

    rot = torch.stack([xaxis, yaxis, zaxis])  # rows
    view = torch.zeros((4, 4), dtype=_F32, device=eye.device)
    view[:3, :3] = rot
    view[:3, 3] = -(rot * eye[None, :]).sum(dim=1)
    view[3, 3] = 1.0
    return view


def perspective_gl(aspect, fov_y_rad, znear, zfar):
    """OpenGL-convention perspective (nalgebra Perspective3), z in [-1, 1]."""
    f = 1.0 / torch.tan(fov_y_rad / 2.0)
    proj = torch.zeros((4, 4), dtype=_F32, device=fov_y_rad.device)
    proj[0, 0] = f / aspect
    proj[1, 1] = f
    proj[2, 2] = (zfar + znear) / (znear - zfar)
    proj[2, 3] = 2.0 * zfar * znear / (znear - zfar)
    proj[3, 2] = -1.0
    return proj


def camera_matrices(camera: Camera, width: int, height: int, device="cuda"):
    """-> dict with view_inverse, proj_inverse, view_proj (camera.rs:33-63),
    each a (4, 4) float32 tensor on `device`. A tensor position or target
    keeps its graph, so the matrices are differentiable in it (as JAX's
    Camera is)."""
    eye = _point(camera.position, device)
    target = _point(camera.target, device)
    up = torch.tensor((0.0, 1.0, 0.0), dtype=_F32, device=device)

    view = look_at_rh(eye, target, up)
    aspect = (torch.tensor(float(width), dtype=_F32)
              / torch.tensor(float(height), dtype=_F32)).to(device)
    fov = torch.deg2rad(torch.tensor(camera.fov_y, dtype=_F32, device=device))
    proj = perspective_gl(aspect, fov, Z_NEAR, Z_FAR)
    proj[1, 1] = proj[1, 1] * -1.0  # Vulkan y-flip (camera.rs:51)

    # Analytic inverses: rigid view -> [[R^T, eye], [0, 1]]; perspective
    # [[a,0,0,0],[0,b,0,0],[0,0,c,d],[0,0,-1,0]] -> known closed form.
    rot = view[:3, :3]
    view_inverse = torch.zeros((4, 4), dtype=_F32, device=device)
    view_inverse[:3, :3] = rot.T
    view_inverse[:3, 3] = eye
    view_inverse[3, 3] = 1.0

    a, b = proj[0, 0], proj[1, 1]
    c, d = proj[2, 2], proj[2, 3]
    proj_inverse = torch.zeros((4, 4), dtype=_F32, device=device)
    proj_inverse[0, 0] = 1.0 / a
    proj_inverse[1, 1] = 1.0 / b
    proj_inverse[2, 3] = -1.0
    proj_inverse[3, 2] = 1.0 / d
    proj_inverse[3, 3] = c / d

    return {
        "view_inverse": view_inverse,
        "proj_inverse": proj_inverse,
        "view_proj": _matmul(proj, view),
    }


def pixel_centers(n: int, device):
    """(arange(n) + 0.5) / n in float32, the division by the constant n
    taken as a multiply by its float32 reciprocal, as XLA compiles it."""
    inv = torch.tensor(1.0 / n, dtype=_F32).item()
    return (torch.arange(n, dtype=_F32, device=device) + 0.5) * inv


def pixel_rows(height: int, device, row0=None, rows: int = 0):
    """pixel_centers(height) or its rows row0 .. row0 + rows - 1: a band
    takes the global centres (row0 + i + 0.5) times the float32
    reciprocal of the whole height, so it equals those rows of the whole
    image bit for bit."""
    if row0 is None:
        return pixel_centers(height, device)
    inv = torch.tensor(1.0 / height, dtype=_F32).item()
    return (torch.arange(rows, dtype=_F32, device=device) + float(row0)
            + 0.5) * inv


def generate_rays(matrices, width: int, height: int, row0=None,
                  rows: int = 0):
    """Primary camera rays for every pixel (ray_gen_ris.slang:44-53).

    Returns (origins, directions), each (H, W, 3). Row 0 is the top of the
    image (Vulkan launch-id convention). row0/rows: only the `rows`
    global rows from row0 (a row-sharded frame, parallel/spmd.py); the
    arrays are then (rows, W, 3)."""
    view_inverse = matrices["view_inverse"]
    proj_inverse = matrices["proj_inverse"]
    device = view_inverse.device

    v, u = torch.meshgrid(pixel_rows(height, device, row0, rows),
                          pixel_centers(width, device), indexing="ij")
    dx2 = u * 2.0 - 1.0
    dy2 = v * 2.0 - 1.0

    p = proj_inverse
    tgt = [fma(p[i, 0], dx2, p[i, 1] * dy2) + p[i, 2] + p[i, 3]
           for i in range(3)]
    norm = sqrt(dot3(tgt[0], tgt[0], tgt[1], tgt[1], tgt[2], tgt[2]))
    tgt = [t / norm for t in tgt]

    m = view_inverse
    dirs = torch.stack(
        [fma(m[i, 2], tgt[2], fma(m[i, 0], tgt[0], m[i, 1] * tgt[1]))
         for i in range(3)],
        dim=-1,
    )
    origins = view_inverse[:3, 3].expand(dirs.shape)
    return origins, dirs


def project_to_prev_uv(view_proj_prev, world_pos):
    """Reproject world positions with a previous-frame view-proj matrix.

    Mirrors ray_gen_ris.slang:119-130: returns (prev_uv, valid) where valid
    requires w > 0.01 and uv in [0,1)."""
    x, y, z = world_pos[..., 0], world_pos[..., 1], world_pos[..., 2]
    m = view_proj_prev

    def row(i):
        return m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]

    w = row(3)
    valid_w = w > 0.01
    safe_w = torch.where(valid_w, w, 1.0)
    uv = torch.stack([row(0), row(1)], dim=-1) / safe_w[..., None] * 0.5 + 0.5
    in_bounds = ((uv >= 0.0) & (uv < 1.0)).all(dim=-1)
    return uv, valid_w & in_bounds
