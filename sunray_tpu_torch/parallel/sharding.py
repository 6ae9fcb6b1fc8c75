"""Multi-device meshes, the sharded frame and the multi-view training step
— port of sunray_tpu/parallel/sharding.py on torch.distributed.

A (dp, sp) mesh over the ranks of the process group:

  - "dp" (data axis): independent camera views of a training batch,
    whose gradients all-reduce over the mesh;
  - "sp" (spatial axis): screen rows, each rank rendering a band of
    them (parallel/spmd.py, with explicit halo exchanges).

Rank r sits at (r // sp, r % sp), the JAX mesh's device order
(devices.reshape(dp, sp)). The caller starts the process group (gloo on
the CPU or for several processes sharing one card, NCCL over cards) and
names its backend; nothing here picks one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from sunray_tpu_torch.parallel.halo import (
    group_size_rank,
    host_staged,
    make_grid,
)
from sunray_tpu_torch.parallel.spmd import (
    _frame_local,
    gather_rows,
    render_frame_spmd,
    shard_state,
)
from sunray_tpu_torch.render.pipeline import RenderState


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (dp, sp) mesh over the first dp * sp ranks.
    dp_index / sp_index are None on a rank outside the mesh."""

    dp: int
    sp: int
    dp_index: Optional[int]
    sp_index: Optional[int]
    group: object       # every rank of the mesh (None: the default group)
    dp_group: object    # this rank's column: the ranks of its sp place
    sp_group: object    # this rank's row: the ranks that share its views

    @property
    def shape(self):
        return (self.dp, self.sp)


def mesh_shape(n: int, dp: Optional[int] = None):
    """(dp, sp) for n devices: dp defaults to the largest power-of-two
    divisor of n that is <= sqrt(n) (sharding.py:30-43)."""
    if dp is None:
        dp = 1
        while dp * 2 <= int(np.sqrt(n)) and n % (dp * 2) == 0:
            dp *= 2
    sp = n // dp
    assert dp * sp == n, f"can't factor {n} devices into ({dp}, {sp})"
    return dp, sp


def make_mesh(n_devices: Optional[int] = None,
              dp: Optional[int] = None) -> Mesh:
    """A (dp, sp) mesh over the first n ranks of the process group (all
    of them by default). Every rank of the group must call it: it makes
    the process groups of every row and column (dist.new_group)."""
    world, rank = group_size_rank()
    n = world if n_devices is None else n_devices
    assert n <= world, f"{n} devices, {world} ranks"
    dp, sp = mesh_shape(n, dp)
    if world == 1:
        return Mesh(dp, sp, 0, 0, None, None, None)
    group = None if n == world else dist.new_group(list(range(n)))
    rows = [dist.new_group([i * sp + j for j in range(sp)])
            for i in range(dp)]
    cols = [dist.new_group([i * sp + j for i in range(dp)])
            for j in range(sp)]
    if rank >= n:
        return Mesh(dp, sp, None, None, group, None, None)
    i, j = divmod(rank, sp)
    return Mesh(dp, sp, i, j, group, cols[j], rows[i])


def _tree_map(fn, tree):
    """fn on every tensor of a tensor, dict, list, tuple or dataclass."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def replicate(tree, mesh: Mesh):
    """Every tensor of `tree` as the mesh's first rank holds it, on every
    rank of the mesh (a broadcast; host copies of a card's tensors under
    gloo)."""
    if group_size_rank(mesh.group)[0] == 1:
        return tree
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)

    def bcast(x):
        staged = host_staged(mesh.group, x.device)
        buf = x.detach().contiguous().cpu() if staged else x.detach().clone()
        dist.broadcast(buf, src, group=mesh.group)
        return buf.to(x.device) if staged else buf

    return _tree_map(bcast, tree)


def shard_rows(x, mesh: Mesh):
    """This rank's rows of an image-like array's leading (row) axis."""
    hl = x.shape[0] // mesh.sp
    return x[mesh.sp_index * hl:(mesh.sp_index + 1) * hl]


def render_frame_sharded(scene, cfg, state: RenderState, mats, mesh: Mesh,
                         accel=None):
    """One frame with the image rows sharded over the mesh's sp ranks;
    every dp replica renders the same frame. Returns (this rank's share
    of the new state, the whole ldr image on every rank, the walk rounds,
    the sp group's maximum).

    The JAX version (sharding.py:56-86) lets GSPMD partition the
    unchanged frame. This one runs the row-sharded frame of
    parallel/spmd.py with each band a share of the single-device frame
    (halo.make_grid(whole_frame=True)): the history halo reaches the whole
    image, so no reprojected history is discarded at a band edge however
    fast the camera moves, and the frame is the single-device frame up to
    the reassociation of its sums."""
    new_state, ldr, rounds = render_frame_spmd(scene, cfg, state, mats,
                                               mesh.sp_group, accel,
                                               whole_frame=True)
    return new_state, gather_rows(ldr, mesh.sp_group), rounds


def training_step(scene, cfg, mats_batch, targets, mesh: Mesh,
                  param_path: str = "base_color"):
    """One differentiable multi-device training step (sharding.py:91-136).

    Renders a batch of views, the views split over dp and each view's
    rows over sp, compares them with the target images and returns
    (loss, gradient w.r.t. the material parameter), both the same on
    every rank. Each rank renders its views' band with differentiable=True
    and divides its sum of squared errors by the global count; the loss
    and the gradient are all-reduced (SUM) over the whole mesh, which is
    the JAX mean((imgs - targets) ** 2) and its GSPMD-psummed gradient.

    mats_batch: camera-matrices dict with a leading batch axis (K, ...);
    targets: (K, H, W, 3), whole on every rank; K a multiple of dp.
    Any config, at any (dp, sp): each band is a share of the
    single-device frame (ShardGrid.whole_frame), its cross-pixel reads
    ride the differentiable halo exchanges, and the ReSTIR
    shadow-boundary term runs as in JAX's render_frame. The state is
    fresh, so no history is read and the configured history halo
    suffices."""
    assert cfg.differentiable, "training_step needs cfg.differentiable=True"
    if mesh.dp_index is None:
        raise ValueError("training_step on a rank outside the mesh")
    k = targets.shape[0]
    assert k % mesh.dp == 0, f"{k} views over dp={mesh.dp}"
    per = k // mesh.dp
    grid = dataclasses.replace(make_grid(cfg, mesh.sp_group),
                               whole_frame=True)
    dev = targets.device

    mt = scene.materials
    param = getattr(mt, param_path).detach().clone().requires_grad_(True)
    scene2 = dataclasses.replace(
        scene, materials=dataclasses.replace(mt, **{param_path: param}))
    sse = torch.zeros((), dtype=torch.float32, device=dev)
    for v in range(mesh.dp_index * per, (mesh.dp_index + 1) * per):
        state = shard_state(RenderState.create(cfg, dev), cfg, grid)
        mats = {key: m[v] for key, m in mats_batch.items()}
        _, ldr, _ = _frame_local(scene2, cfg, state, mats, grid)
        tgt = targets[v, grid.row0:grid.row0 + grid.hl]
        sse = sse + ((ldr - tgt) ** 2).sum()
    loss = sse / targets.numel()
    grad, = torch.autograd.grad(loss, param)
    loss = loss.detach()
    if group_size_rank(mesh.group)[0] > 1:
        staged = host_staged(mesh.group, dev)
        out = []
        for x in (loss, grad):
            buf = x.cpu() if staged else x.contiguous()
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
            out.append(buf.to(dev) if staged else buf)
        loss, grad = out
    return loss, grad
