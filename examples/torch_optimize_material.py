"""Inverse rendering on the PyTorch port (sunray_tpu_torch): recover wall
albedos from a target image. Port of examples/optimize_material.py; on the
card unless --cpu.

Renders a target Cornell box, re-initializes the wall colors to gray, and
optimizes material base colors by gradient descent through the whole
differentiable pipeline (trace -> shade -> NEE -> denoise -> tonemap),
with torch.optim.Adam at optax.adam's defaults and a clip to [0, 1] after
each step.

Usage: python examples/torch_optimize_material.py [--steps 60] [--lr 0.6]
       [--cpu]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import argparse
import dataclasses
import time

import torch

CAMERA = dict(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0)
SIZE = (96, 72)


@dataclasses.dataclass
class Problem:
    """The loss of optimize_material.py:41-70 on one device: `loss(p)` is
    the MSE of the frame rendered with base colors bc_true * (1 - mask) +
    p * mask against the frame of the true base colors."""

    loss: object
    init: torch.Tensor       # (M, 4) start: the walls' rgb at 0.5
    bc_true: torch.Tensor    # (M, 4) true base colors
    mask: torch.Tensor       # (M, 4) 1 on the learned entries [:3, :3]


def problem(size=SIZE, device="cuda") -> Problem:
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    w, h = size
    cfg = RenderConfig(
        width=w, height=h, lighting="nee", bounces=3, virtual_bounces=2,
        denoise_passes=1, enable_taa=False, differentiable=True,
    )
    scene = cornell_box(device=device)
    mats = camera_matrices(Camera(**CAMERA), w, h, device=device)

    def render(base_color):
        sc = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, base_color=base_color))
        _, ldr, _ = render_frame(sc, cfg, RenderState.create(cfg, device),
                                 mats)
        return ldr

    bc_true = scene.materials.base_color
    with torch.no_grad():
        target = render(bc_true)
    init = bc_true.clone()
    init[:3, :3] = 0.5     # white/red/green walls -> gray
    mask = torch.zeros_like(bc_true)
    mask[:3, :3] = 1.0     # the light's material stays fixed

    def loss(p):
        return torch.mean((render(bc_true * (1 - mask) + p * mask)
                           - target) ** 2)

    return Problem(loss, init, bc_true, mask)


def optimizer(params, lr):
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 (eps outside the root)."""
    return torch.optim.Adam([params], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def apply_step(opt, params, grad):
    """One update of optimize_material.py:77-79: Adam, then the clip."""
    params.grad = grad
    opt.step()
    with torch.no_grad():
        params.clamp_(0.0, 1.0)


def run(steps=60, lr=0.6, size=SIZE, device="cuda"):
    """The loop of optimize_material.py:72-91, printing its lines. Returns
    {"losses", "albedo_err" (after each step), "params" (after each step,
    numpy), "recovered", "true", "seconds"}."""
    pb = problem(size, device)
    params = pb.init.clone().requires_grad_()
    opt = optimizer(params, lr * 0.05)
    losses, errs, history = [], [], []
    t0 = time.time()
    for step in range(steps):
        loss = pb.loss(params)
        grad, = torch.autograd.grad(loss, params)
        apply_step(opt, params, grad)
        err = float(((params.detach() - pb.bc_true) * pb.mask).abs().max())
        losses.append(float(loss.detach()))
        errs.append(err)
        history.append(params.detach().cpu().numpy().copy())
        if step % 10 == 0 or step == steps - 1:
            print(f"step {step:3d}  loss {losses[-1]:.6f}  "
                  f"max albedo err {err:.4f}")
    seconds = time.time() - t0
    recovered = params.detach().cpu().numpy()[:3, :3]
    true = pb.bc_true.cpu().numpy()[:3, :3]
    print("recovered wall albedos:")
    print(recovered.round(3))
    print("true wall albedos:")
    print(true.round(3))
    return {"losses": losses, "albedo_err": errs, "params": history,
            "recovered": recovered, "true": true, "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.6)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    return run(steps=args.steps, lr=args.lr,
               device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
