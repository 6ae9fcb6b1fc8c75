"""Inverse rendering on the PyTorch port (sunray_tpu_torch): recover the
camera pose from a target image. Port of examples/optimize_camera.py; on
the card unless --cpu.

Renders a target Cornell box from a ground-truth camera, perturbs the
camera's position (and with --joint its look-at target), and recovers
them by gradient descent through the whole differentiable pipeline: the
pose is a pair of leaf tensors passed into Camera, so camera_matrices
(camera.py) stays in the graph, and gradients flow through ray generation
and the hit-attribute recompute (render/shade.py).

Usage: python examples/torch_optimize_camera.py [--steps 80] [--lr 2e-2]
       [--edge-aa] [--joint] [--cpu]
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
POSITION_OFFSET = (0.25, -0.2, 0.3)     # optimize_camera.py:68-70
TARGET_OFFSET = (-0.2, 0.15, 0.0)


@dataclasses.dataclass
class Problem:
    """The loss of optimize_camera.py:49-80 on one device: `loss(params)`
    is the MSE of the frame seen from params["position"] (and
    params["target"], else the true target) against the true pose's."""

    loss: object
    init: dict                # {"position"[, "target"]}: (3,) start tensors
    true_pos: torch.Tensor
    true_tgt: torch.Tensor

    def pose_err(self, params) -> float:
        with torch.no_grad():
            e = torch.linalg.norm(params["position"] - self.true_pos)
            if "target" in params:
                e = e + torch.linalg.norm(params["target"] - self.true_tgt)
        return float(e)


def problem(size=SIZE, edge_aa=False, joint=False, device="cuda") -> Problem:
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box

    w, h = size
    cfg = RenderConfig(
        width=w, height=h, lighting="nee", bounces=2, virtual_bounces=2,
        denoise_passes=1, enable_taa=False, differentiable=True,
        edge_antialias=edge_aa,
    )
    scene = cornell_box(device=device)
    cam = Camera(**CAMERA)

    def render(position, target):
        c = dataclasses.replace(cam, position=position, target=target)
        mats = camera_matrices(c, w, h, device=device)
        _, ldr, _ = render_frame(scene, cfg, RenderState.create(cfg, device),
                                 mats)
        return ldr

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    true_pos, true_tgt = vec(cam.position), vec(cam.target)
    with torch.no_grad():
        target_img = render(true_pos, true_tgt)
    init = {"position": true_pos + vec(POSITION_OFFSET)}
    if joint:
        init["target"] = true_tgt + vec(TARGET_OFFSET)

    def loss(p):
        img = render(p["position"], p.get("target", true_tgt))
        return torch.mean((img - target_img) ** 2)

    return Problem(loss, init, true_pos, true_tgt)


def optimizer(params, lr):
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 (eps outside the root)."""
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def run(steps=80, lr=2e-2, edge_aa=False, joint=False, size=SIZE,
        device="cuda"):
    """The loop of optimize_camera.py:82-100, printing its lines. Returns
    {"losses", "pose_err" (after each step), "e0", "e1", "result"
    ("RECOVERED" or "partial"), "seconds"}."""
    pb = problem(size, edge_aa, joint, device)
    params = {k: v.clone().requires_grad_() for k, v in pb.init.items()}
    opt = optimizer(params, lr)
    e0 = pb.pose_err(params)
    losses, errs = [], []
    t0 = time.time()
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = pb.loss(params)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        errs.append(pb.pose_err(params))
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:3d}  loss {losses[-1]:.3e}  "
                  f"pose_err {errs[-1]:.4f}", flush=True)
    seconds = time.time() - t0
    e1 = pb.pose_err(params)
    result = "RECOVERED" if e1 < 0.25 * e0 else "partial"
    print(f"pose error {e0:.4f} -> {e1:.4f} ({result})")
    return {"losses": losses, "pose_err": errs, "e0": e0, "e1": e1,
            "result": result, "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--edge-aa", action="store_true",
                    help="enable primary-silhouette gradients "
                         "(render/antialias.py); helps the --joint case")
    ap.add_argument("--joint", action="store_true",
                    help="also optimize the look-at target (harder: position"
                         "/target moves along the view ray are near-ambiguous"
                         " with shading-only gradients)")
    args = ap.parse_args(argv)
    return run(steps=args.steps, lr=args.lr, edge_aa=args.edge_aa,
               joint=args.joint, device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
