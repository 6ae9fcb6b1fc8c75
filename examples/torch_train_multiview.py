"""Distributed inverse rendering on the PyTorch port (sunray_tpu_torch):
recover the Cornell box's wall albedos from several camera views, the
views split over the "dp" axis and each view's rows over "sp" of a
(dp, sp) mesh (parallel/sharding.py), with torch.optim.Adam and npz
checkpoints that resume. Port of examples/train_multiview.py.

Usage:
  python examples/torch_train_multiview.py --cpu-ranks 4 --steps 40
      (4 gloo processes on the CPU)
  torchrun --nproc-per-node 4 examples/torch_train_multiview.py --steps 40
      (one process a card, NCCL)
  python examples/torch_train_multiview.py --steps 40
      (one card, no process group)
  ... --resume   (continues from the latest checkpoint in --ckpt-dir)
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the learned albedos and Adam's moments."""

    params: torch.Tensor
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor
    step: torch.Tensor


def train(rank, world, args, backend, init_method):
    import torch.distributed as dist

    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.parallel.sharding import (
        make_mesh,
        replicate,
        training_step,
    )
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box
    from sunray_tpu_torch.utils.checkpoint import AsyncCheckpointManager

    if backend is not None:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    if backend == "gloo":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    lead = rank == 0

    w, h = (int(x) for x in args.size.split("x"))
    cfg = RenderConfig(
        width=w, height=h, lighting="nee", bounces=2, virtual_bounces=2,
        denoise_passes=0, enable_taa=False, differentiable=True,
        tonemap="none",
    )
    scene = cornell_box(device=device)
    mesh = make_mesh()
    k = -(-max(args.views, 1) // mesh.dp) * mesh.dp  # views: a dp multiple
    if lead:
        print(f"mesh {mesh.shape} (dp={mesh.dp}), {k} views, {world} "
              f"rank(s) on {device.type}", flush=True)

    cams = [
        Camera(position=(1.0 + 0.25 * np.sin(i), 1.0, 3.0 + 0.3 * np.cos(i)),
               target=(1.0, 1.0, 0.0), fov_y=45.0)
        for i in range(k)
    ]
    per_view = [camera_matrices(c, w, h, device=device) for c in cams]
    mats_batch = {key: torch.stack([m[key] for m in per_view])
                  for key in per_view[0]}

    # Ground-truth renders, then the walls re-initialised to gray.
    with torch.no_grad():
        targets = torch.stack([
            render_frame(scene, cfg, RenderState.create(cfg, device), m)[1]
            for m in per_view])

    # Learn only the non-emissive materials' rgb (the light and alpha
    # frozen), projected to [0, 1] after each update.
    bc_true = scene.materials.base_color.detach().clone()
    em = scene.materials.emissive_factor[:, 3] > 0
    learn = torch.zeros_like(bc_true)
    learn[~em, :3] = 1.0
    params = bc_true.clone()
    params[~em, :3] = 0.5
    params.requires_grad_(True)
    opt = torch.optim.Adam([params], lr=args.lr)

    mgr = AsyncCheckpointManager(args.ckpt_dir, max_to_keep=3) if lead else None
    start = 0
    if args.resume:
        # The lead rank reads the newest checkpoint; the mesh takes its
        # copy (the JAX example re-replicates the restored arrays).
        z = torch.zeros_like(params)
        got = TrainState(z, z.clone(), z.clone(),
                         torch.zeros((), dtype=torch.int64, device=device))
        found = torch.zeros((), dtype=torch.int64, device=device)
        if lead and mgr.latest_step() is not None:
            got, found = mgr.restore(got), found + 1
        found, got = replicate((found, got), mesh)
        if int(found):
            with torch.no_grad():
                params.copy_(got.params)
            start = int(got.step)
            opt.state[params] = {"step": torch.tensor(float(start)),
                                 "exp_avg": got.exp_avg.clone(),
                                 "exp_avg_sq": got.exp_avg_sq.clone()}
            if lead:
                print(f"resumed after step {start - 1}", flush=True)

    def err():
        return float((params.detach()[~em, :3] - bc_true[~em, :3])
                     .abs().mean())

    loss = torch.zeros(())
    for i in range(start, start + args.steps):
        bc = bc_true * (1 - learn) + params.detach() * learn
        sc = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials,
                                                 base_color=bc))
        loss, g = training_step(sc, cfg, mats_batch, targets, mesh)
        opt.zero_grad()
        params.grad = g * learn
        opt.step()
        with torch.no_grad():
            params.clamp_(0.0, 1.0)
        if lead and (i + 1) % args.ckpt_every == 0:
            st = opt.state[params]
            mgr.save(i + 1, TrainState(
                params.detach(), st["exp_avg"], st["exp_avg_sq"],
                torch.tensor(int(st["step"]), dtype=torch.int64)))
        if lead and (i % 10 == 0 or i == start + args.steps - 1):
            print(f"step {i:3d}  loss {float(loss):.3e}  "
                  f"albedo_err {err():.4f}", flush=True)
    if lead:
        mgr.close()
        print(f"final albedo error {err():.4f} "
              f"({'RECOVERED' if err() < 0.05 else 'partial'}) "
              f"final loss {float(loss):.6e}", flush=True)
    if backend is not None:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--size", default="64x48")
    ap.add_argument("--cpu-ranks", type=int, default=0,
                    help="run this many gloo processes on the CPU")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "sunray_torch_train_ckpts"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args()

    if args.cpu_ranks:
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(train, args=(args.cpu_ranks, args, "gloo",
                                  f"file://{tmp}/store"),
                     nprocs=args.cpu_ranks, join=True)
    elif "RANK" in os.environ:      # under torchrun: one process a card
        train(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), args,
              "nccl", "env://")
    else:
        train(0, 1, args, None, None)


if __name__ == "__main__":
    main()
