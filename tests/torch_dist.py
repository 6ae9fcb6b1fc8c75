"""Process groups for the port's multi-device tests (tests/test_torch_halo.py,
_spmd.py, _spmd_jax.py, _training_step.py, _training_restir.py,
_training_visibility.py, _halo_grad.py).

run_ranks(world, fn, *args) spawns `world` processes with
torch.multiprocessing, joins them into one gloo process group through a
file store in a fresh temporary directory, calls fn(rank, world, *args) in
each and returns the ranks' results in rank order. fn is a module-level
function of a module that imports no JAX (this one, or one of the port's),
so a child starts in ~1 s; its result is anything torch.save takes. A
child's exception fails the caller (the join re-raises it), and so does
a run past TIMEOUT_S. Each child
runs torch on one thread, as tests/torch_parity.py pins the test
process.
"""

from __future__ import annotations

import datetime
import importlib
import os
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
# A run's ranks are terminated, and the test fails, past this; a
# collective that waits longer raises in its rank.
TIMEOUT_S = 600


def _child(rank, world, tmp, module, name, args):
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    for p in (str(REPO), str(TESTS)):
        if p not in sys.path:
            sys.path.insert(0, p)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        fn = getattr(importlib.import_module(module), name)
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(world, fn, *args, meanwhile=None):
    """fn(rank, world, *args) on `world` gloo ranks; their results.
    meanwhile: a callable run in this process while the ranks run; with
    it, returns (results, meanwhile())."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _child, args=(world, tmp, fn.__module__, fn.__name__, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + TIMEOUT_S
        try:
            local = meanwhile() if meanwhile is not None else None
        finally:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    for p in ctx.processes:
                        p.terminate()
                    raise TimeoutError(f"{world} ranks of {fn.__name__} "
                                       f"still running after {TIMEOUT_S} s")
        out = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(world)]
    return out if meanwhile is None else (out, local)


# -- the sharded frame on every rank ------------------------------------------

SPMD_KW = dict(width=64, height=48, lighting="restir", bounces=3,
               virtual_bounces=3, ris_candidates=4, di_spatial_samples=2,
               gi_spatial_samples=2, di_spatial_radius=8.0,
               gi_spatial_radius=6.0, denoise_passes=2)   # test_spmd.py:31-38
CAMERA = dict(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)


def cameras(kind, frames):
    """The camera paths of tests/test_spmd.py: static, slow orbit (motion
    below the history halo) and fast motion (far beyond it)."""
    from sunray_tpu_torch.camera import Camera

    if kind == "static":
        return [Camera(**CAMERA)] * frames
    if kind == "slow":
        return [Camera(position=(1.0 + 0.02 * i, 1.0, 3.4 - 0.02 * i),
                       target=(1.0, 1.0, 0.0), fov_y=45.0)
                for i in range(frames)]
    if kind == "fast":
        return [Camera(position=(1.0, 1.0 + 0.6 * i, 3.4),
                       target=(1.0, 1.0, 0.0), fov_y=45.0)
                for i in range(frames)]
    raise ValueError(kind)


def spmd_frames(rank, world, runs):
    """Each run (kw, camera kind, frames) through the row-sharded frame
    on this rank; returns, a run each, the gathered ldr images (on every
    rank; numpy) and this rank's traffic tallies, one a frame."""
    from sunray_tpu_torch.camera import camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.parallel.halo import traffic_tally
    from sunray_tpu_torch.parallel.spmd import (
        gather_rows,
        make_spmd_step,
        shard_state,
    )
    from sunray_tpu_torch.render.pipeline import RenderState
    from sunray_tpu_torch.scene import cornell_box

    out = []
    scene = cornell_box(device="cpu")
    for kw, kind, frames in runs:
        cfg = RenderConfig(**kw)
        step = make_spmd_step(scene, cfg)
        state = shard_state(RenderState.create(cfg, "cpu"), cfg, step.grid)
        ldrs, tallies = [], []
        for cam in cameras(kind, frames):
            mats = camera_matrices(cam, cfg.width, cfg.height, device="cpu")
            with traffic_tally() as t:
                state, ldr, _ = step(state, mats)
            ldrs.append(gather_rows(ldr).numpy())
            tallies.append(dict(t))
        out.append((ldrs, tallies))
    return out


def single_frames(kw, kind, frames):
    """The same run through the single-device render_frame on the CPU."""
    from sunray_tpu_torch.camera import camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    cfg = RenderConfig(**kw)
    scene = cornell_box(device="cpu")
    state = RenderState.create(cfg, "cpu")
    ldrs = []
    for cam in cameras(kind, frames):
        mats = camera_matrices(cam, cfg.width, cfg.height, device="cpu")
        state, ldr, _ = render_frame(scene, cfg, state, mats)
        ldrs.append(ldr.numpy())
    return ldrs


def assert_close_frames(ref, got, rtol, atol, min_match=0.995):
    """tests/test_spmd.py:67-79: all finite, and near-total agreement
    (ReSTIR's takes amplify one-ulp differences on isolated pixels)."""
    import numpy as np

    for a, b in zip(ref, got):
        assert np.isfinite(b).all()
        match = np.isclose(b, a, rtol=rtol, atol=atol).all(axis=-1)
        assert match.mean() >= min_match, (
            f"only {match.mean():.4f} of pixels match "
            f"(max|d|={np.abs(a - b).max():.3e})")


# -- the halo functions on every rank (tests/test_torch_halo.py) -------------

def halo_ops(rank, world, case):
    """exchange_rows (zero and edge), exchange_flat of a float32 and (packed
    beside it by exchange_flat_many) an int32 field, gather_flat_ext and
    shift_flat_ext on this rank's share of case's arrays; make_grid's
    asserts; make_mesh for n = 1 .. world."""
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.parallel.halo import (
        ShardGrid,
        exchange_flat,
        exchange_flat_many,
        exchange_rows,
        gather_flat_ext,
        make_grid,
        shift_flat_ext,
    )
    from sunray_tpu_torch.parallel.sharding import make_mesh

    h, w, hl, halo, fh = (case[k] for k in ("h", "w", "hl", "halo", "fh"))
    grid = ShardGrid(None, world, rank, rank * hl, h, w, hl, halo, halo)
    band = torch.from_numpy(case["img"][rank * hl:(rank + 1) * hl])
    lanes = slice(rank * hl * w, (rank + 1) * hl * w)
    flat = torch.from_numpy(case["flat"][lanes])
    flat_i = torch.from_numpy(case["flat_i"][lanes])
    idx = torch.from_numpy(case["idx"][lanes]).long()
    out = {"zero": exchange_rows(band, halo, halo, grid).numpy(),
           "edge": exchange_rows(band, halo, halo, grid, "edge").numpy()}
    ext = exchange_flat(flat, fh, grid)
    ext_f, ext_i = exchange_flat_many([flat, flat_i], fh, grid)
    rows, valid = gather_flat_ext(ext, idx, fh, grid)
    out.update(flat=ext.numpy(), flat_many=ext_f.numpy(),
               flat_i=ext_i.numpy(), gather=rows.numpy(),
               valid=valid.numpy(),
               shift=[shift_flat_ext(ext, dx, dy, fh, grid).numpy()
                      for dx, dy in case["shifts"]])
    asserts = []
    for kw in (dict(width=8, height=30),
               dict(width=8, height=16, di_spatial_radius=8.0,
                    gi_spatial_radius=6.0)):
        try:
            make_grid(RenderConfig(**kw))
            asserts.append(None)
        except AssertionError as e:
            asserts.append(str(e))
    out["asserts"] = asserts
    out["meshes"] = []
    for n in range(1, world + 1):
        m = make_mesh(n)
        out["meshes"].append((m.dp, m.sp, m.dp_index, m.sp_index))
    return out


def halo_grads(rank, world, case):
    """The backward of exchange_rows (zero and edge fill) and of
    exchange_flat_many (a float (P, 3) and an int32 field) on this rank's
    band of seeded float64 (float32 for the flat fields) inputs: <ext, y>
    and <x, grad> for the adjoint identity, the gradient of two runs, the
    traffic tallies; then two exchanges whose backwards ranks 0 and 1 run
    in opposite orders, and the error that raises."""
    from sunray_tpu_torch.parallel.halo import (
        ShardGrid,
        exchange_flat_many,
        exchange_rows,
        traffic_tally,
    )

    h, w, hl, halo = (case[k] for k in ("h", "w", "hl", "halo"))
    grid = ShardGrid(None, world, rank, rank * hl, h, w, hl, halo, halo)
    gen = torch.Generator().manual_seed(7)
    img = torch.randn(h, w, 3, generator=gen, dtype=torch.float64)
    ys = torch.randn(world, hl + 2 * halo, w, 3, generator=gen,
                     dtype=torch.float64)
    flat = torch.randn(h * w, 3, generator=gen)
    ints = torch.randint(-2**31, 2**31 - 1, (h * w,), generator=gen,
                         dtype=torch.int32)
    yf = torch.randn(world, (hl + 2 * halo) * w, 3, generator=gen)
    band = slice(rank * hl, (rank + 1) * hl)
    lanes = slice(rank * hl * w, (rank + 1) * hl * w)
    out = {}
    for edge in ("zero", "edge"):
        grads = []
        for _ in range(2):
            x = img[band].clone().requires_grad_(True)
            with traffic_tally() as t:
                ext = exchange_rows(x, halo, halo, grid, edge=edge)
                g, = torch.autograd.grad(ext, x, ys[rank])
            grads.append(g)
        out[edge] = dict(lhs=float((ext.detach() * ys[rank]).sum()),
                         rhs=float((x.detach() * grads[0]).sum()),
                         grad=grads[0].numpy(), grad2=grads[1].numpy(),
                         tally=dict(t))
    grads = []
    for _ in range(2):
        x = flat[lanes].clone().requires_grad_(True)
        with traffic_tally() as t:
            ext, ext_i = exchange_flat_many([x, ints[lanes]], halo, grid)
            g, = torch.autograd.grad(ext, x, yf[rank])
        grads.append(g)
    ref_i = torch.cat([torch.zeros((halo * w,), dtype=torch.int32), ints,
                       torch.zeros((halo * w,), dtype=torch.int32)])
    win = slice((rank * hl) * w, (rank * hl + hl + 2 * halo) * w)
    out["flat_many"] = dict(
        lhs=float((ext.detach().double() * yf[rank].double()).sum()),
        rhs=float((x.detach().double() * grads[0].double()).sum()),
        grad=grads[0].numpy(), grad2=grads[1].numpy(), tally=dict(t),
        int_exact=bool(torch.equal(ext_i, ref_i[win])))
    # Two exchanges between ranks 0 and 1 alone; their backwards run in
    # opposite orders on the two ranks.
    out["mismatch"] = None
    if rank < 2:
        pair = ShardGrid(None, 2, rank, rank * hl, 2 * hl, w, hl, 1, 1)
        x = img[band].clone().requires_grad_(True)
        a = exchange_rows(x, 1, 1, pair)
        b = exchange_rows(x * 2.0, 1, 1, pair)
        first, second = (a, b) if rank == 0 else (b, a)
        try:
            torch.autograd.grad(first.sum(), x, retain_graph=True)
            torch.autograd.grad(second.sum(), x)
        except RuntimeError as e:
            out["mismatch"] = str(e)
    return out


# -- the training step on every rank (tests/test_torch_training_step.py) -----

def train_step(rank, world, case):
    """sharding.training_step on a (dp, sp) mesh of the ranks, on case's
    scene, view matrices and targets (numpy, from the JAX package), w.r.t.
    base_color; and the same step with case["restir_kw"] (ReSTIR, TAA,
    denoise)."""
    from sunray_tpu_torch import convert
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.parallel.sharding import make_mesh, training_step

    mesh = make_mesh(world, dp=case["dp"])
    scene = convert.scene_from_numpy(case["scene"], device="cpu")
    mats = {k: torch.from_numpy(v) for k, v in case["mats"].items()}
    targets = torch.from_numpy(case["targets"])
    loss, grad = training_step(scene, RenderConfig(**case["kw"]), mats,
                               targets, mesh)
    restir = training_step(scene, RenderConfig(**dict(case["kw"],
                                                      **case["restir_kw"])),
                           mats, targets, mesh)
    return dict(loss=loss.numpy(), grad=grad.numpy(),
                restir=tuple(x.numpy() for x in restir),
                mesh=(mesh.dp, mesh.sp, mesh.dp_index, mesh.sp_index))


def train_scene(case):
    """case's scene in the port, with its edge topology when
    case["topology"] (the shadow-boundary term needs it)."""
    from sunray_tpu_torch import convert
    from sunray_tpu_torch.render import boundary

    scene = convert.scene_from_numpy(case["scene"], device="cpu")
    if case.get("topology"):
        scene = boundary.with_edge_topology(scene)
    return scene


def train_meshes(rank, world, case, shapes, repeats=1):
    """training_step on each (dp, sp) of `shapes` over the ranks, `repeats`
    times each; returns, a mesh each, [(loss, gradient, traffic tally)] a
    run."""
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.parallel.halo import traffic_tally
    from sunray_tpu_torch.parallel.sharding import make_mesh, training_step

    scene = train_scene(case)
    mats = {k: torch.from_numpy(v) for k, v in case["mats"].items()}
    targets = torch.from_numpy(case["targets"])
    out = []
    for dp, sp in shapes:
        mesh = make_mesh(world, dp=dp)
        assert mesh.shape == (dp, sp)
        runs = []
        for _ in range(repeats):
            with traffic_tally() as t:
                loss, grad = training_step(scene, RenderConfig(**case["kw"]),
                                           mats, targets, mesh)
            runs.append((loss.numpy(), grad.numpy(), dict(t)))
        out.append(runs)
    return out


def single_step(case):
    """The port's single-device step on the CPU: mean((ldr - targets)^2)
    over case's views through pipeline.render_frame, and its gradient
    w.r.t. base_color (numpy)."""
    import dataclasses

    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame

    scene = train_scene(case)
    cfg = RenderConfig(**case["kw"])
    mt = scene.materials
    param = mt.base_color.clone().requires_grad_(True)
    scene = dataclasses.replace(
        scene, materials=dataclasses.replace(mt, base_color=param))
    targets = torch.from_numpy(case["targets"])
    imgs = [render_frame(scene, cfg, RenderState.create(cfg, "cpu"),
                         {k: torch.from_numpy(v[i])
                          for k, v in case["mats"].items()})[1]
            for i in range(targets.shape[0])]
    loss = ((torch.stack(imgs) - targets) ** 2).mean()
    grad, = torch.autograd.grad(loss, param)
    return float(loss.detach()), grad.numpy()


def sharded_runs(rank, world, runs):
    """Each run (path, kw, camera kind, frames) on this rank: path "spmd"
    through spmd_frames' row-sharded frame, "sharded" through
    sharding.render_frame_sharded on the (1, world) mesh; returns, a run
    each, the whole ldr images (numpy)."""
    from sunray_tpu_torch.camera import camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.parallel.sharding import (
        make_mesh,
        render_frame_sharded,
    )
    from sunray_tpu_torch.render.pipeline import RenderState
    from sunray_tpu_torch.scene import cornell_box

    out = []
    mesh = make_mesh(world, dp=1)
    scene = cornell_box(device="cpu")
    for path, kw, kind, frames in runs:
        if path == "spmd":
            out.append(spmd_frames(rank, world, [(kw, kind, frames)])[0][0])
            continue
        cfg = RenderConfig(**kw)
        state = RenderState.create(cfg, "cpu")
        ldrs = []
        for cam in cameras(kind, frames):
            mats = camera_matrices(cam, cfg.width, cfg.height, device="cpu")
            state, ldr, _ = render_frame_sharded(scene, cfg, state, mats,
                                                 mesh)
            ldrs.append(ldr.numpy())
        out.append(ldrs)
    return out


def mesh_frames(rank, world, kw, frames):
    """sharding.render_frame_sharded on the default (dp, sp) mesh of the
    ranks (static camera), replicate of a per-rank tensor and shard_rows
    of the gathered image; returns (mesh place, ldr images, replicated,
    rows)."""
    from sunray_tpu_torch.camera import camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.parallel.sharding import (
        make_mesh,
        render_frame_sharded,
        replicate,
        shard_rows,
    )
    from sunray_tpu_torch.render.pipeline import RenderState
    from sunray_tpu_torch.scene import cornell_box

    mesh = make_mesh()
    cfg = RenderConfig(**kw)
    scene = cornell_box(device="cpu")
    state = RenderState.create(cfg, "cpu")
    ldrs = []
    for cam in cameras("static", frames):
        mats = camera_matrices(cam, cfg.width, cfg.height, device="cpu")
        state, ldr, _ = render_frame_sharded(scene, cfg, state, mats, mesh)
        ldrs.append(ldr.numpy())
    rep = replicate({"x": torch.full((3,), float(rank))}, mesh)["x"]
    return ((mesh.dp, mesh.sp, mesh.dp_index, mesh.sp_index), ldrs,
            rep.numpy(), shard_rows(torch.from_numpy(ldrs[-1]), mesh).numpy())
