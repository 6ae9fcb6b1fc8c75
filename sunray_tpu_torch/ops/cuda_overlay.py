"""R1: the 2D overlay painter, every mesh rasterised and blended in one
launch.

Counterpart of sunray_tpu/render/overlay2d.py: rasterize_mesh and
paint_meshes (:79-155), which have no pallas_call: the reference runs
each mesh as a lax.scan over its triangles, about 20 elementwise
operations over the whole (H, W) plane a triangle, then a texture fetch,
a clip and a blend, each over the plane again. The kernel is
csrc/overlay.cu: one thread a pixel walks every mesh in submission order
and every triangle of a mesh in order, keeps the last covering
triangle's uv and colour, then fetches the texture, clips and blends
before the next mesh. It is bit-equal to the plain twin,
render/overlay2d.paint_meshes_plain, which is the CPU path.
"""

from __future__ import annotations

import numpy as np
import torch

from sunray_tpu_torch.ops import cuda_build

# csrc/overlay.cu: kThreadsX x kThreadsY threads a block, triangles staged
# through shared memory kTile at a time.
THREADS = (16, 16)
TILE = 256
META_INTS = 6        # tri start, tri count, texel offset, tex h, tex w, clip


def pack_meshes(meshes, device):
    """The kernel's inputs for `meshes` on `device`: (sum T, 24) triangle
    records, (M, 6) int32 metadata, (M, 4) float32 clip rects and the
    textures' texels in one float32 pool."""
    from sunray_tpu_torch.render.overlay2d import clip_bounds, mesh_to, tri_data

    records, texels, meta, clips = [], [], [], []
    n_tri, n_tex = 0, 0
    for mesh in meshes:
        mesh = mesh_to(mesh, device)
        td = tri_data(mesh)
        records.append(td)
        th = tw = 0
        off = -1
        if mesh.tex is not None:
            th, tw = mesh.tex.shape[:2]
            if mesh.tex.shape[2] != 4:
                raise cuda_build.KernelError("paint_meshes: textures must be "
                                             "(TH, TW, 4)")
            off = n_tex
            texels.append(mesh.tex.to(torch.float32).reshape(-1))
            n_tex += th * tw * 4
        meta.append((n_tri, td.shape[0], off, th, tw,
                     int(mesh.clip is not None)))
        clips.append(clip_bounds(mesh.clip) if mesh.clip is not None
                     else (0.0, 0.0, 0.0, 0.0))
        n_tri += td.shape[0]
    tris = (torch.cat(records) if records
            else torch.zeros((0, 24), dtype=torch.float32, device=device))
    pool = (torch.cat(texels) if texels
            else torch.zeros(4, dtype=torch.float32, device=device))
    meta_t = torch.from_numpy(np.asarray(meta, np.int32).reshape(-1, META_INTS))
    clip_t = torch.from_numpy(np.asarray(clips, np.float32).reshape(-1, 4))
    return (tris.contiguous(), meta_t.to(device), clip_t.to(device),
            pool.contiguous())


def paint_meshes(img, meshes):
    """Blend `meshes` (render/overlay2d.Mesh2D) onto the (H, W, 3) float32
    image in submission order; returns a new image. R1 on a CUDA image,
    the plain twin on a CPU one."""
    name = "paint_meshes"
    if img.dim() != 3 or img.shape[2] != 3 or img.dtype != torch.float32:
        raise cuda_build.KernelError(f"{name}: img must be (H, W, 3) float32, "
                                     f"got {img.dtype} {tuple(img.shape)}")
    if cuda_build.on_cpu(img):
        from sunray_tpu_torch.render.overlay2d import paint_meshes_plain

        return paint_meshes_plain(img, meshes)
    img = img.contiguous()
    cuda_build.require_cuda(name, img)
    if not meshes:
        return img.clone()
    return _launch_paint(img, *pack_meshes(meshes, img.device))


def _launch_paint(img, tris, meta, clip, pool, lib=None):
    """R1 once on packed arguments, from `lib` (default: the port's
    library, whose launches are counted)."""
    h, w = img.shape[:2]
    out = torch.empty_like(img)
    kernels = cuda_build.library() if lib is None else lib
    err = kernels.sunray_paint_meshes(
        img.data_ptr(), out.data_ptr(), h, w, tris.data_ptr(),
        meta.data_ptr(), clip.data_ptr(), pool.data_ptr(), meta.shape[0],
        cuda_build.stream_ptr())
    cuda_build.check_launch("paint_meshes", err)
    if lib is None:
        cuda_build.launches["paint_meshes"] += 1
    return out

