"""Reference-parity report on the PyTorch port (sunray_tpu_torch) — port of
examples/parity_report.py; on the card unless --cpu.

The reference's only offline golden path is examples/png/main.rs:43-61:
ReflectionRoom.glb at 1600x1200, camera (13,30,25)->(0,13,0) fov_y 45,
render_to_host_memory (16 warm-up frames, lib.rs:1927). That file is not
in the repository, so --gltf names the scene to render at that setup.
This script:

  1. renders the setup through the Renderer facade and writes a PNG;
  2. reports the camera matrices next to values computed from the
     reference's own formulas (nalgebra look_at_rh + Perspective3(0.1,100)
     with proj[1][1] *= -1, camera.rs:34-66) — an independent nalgebra
     re-derivation in numpy, not the port's camera.py code path;
  3. reports aux-channel physical checks (normal unit-length, depth range,
     hit coverage, finite everywhere);
  4. with --ref <png>, computes PSNR and mean absolute difference against
     a reference render.

Usage:
  python examples/torch_parity_report.py --gltf PATH [--size WxH]
      [--ref path.png] [--out out/parity_1600x1200.png] [--json] [--cpu]
"""

try:
    import _path  # noqa: F401  (repo-root sys.path bootstrap)
except ImportError:  # imported as examples.* (repo root already on path)
    pass

import argparse
import json
import os
import time

import numpy as np

CAMERA = dict(position=(13.0, 30.0, 25.0), target=(0.0, 13.0, 0.0),
              fov_y=45.0)
NO_REF = ("no reference render available: pass --ref with a render of the "
          "same scene and size")


def look_at_rh(eye, target, up):
    """nalgebra Isometry3::look_at_rh, re-derived independently
    (camera.rs:39): right-handed view with -z forward."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, np.float64)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective3(aspect, fov_y_rad, znear, zfar):
    """nalgebra Perspective3 (camera.rs:41-46): OpenGL-style [-1,1] z."""
    f = 1.0 / np.tan(fov_y_rad / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = 2.0 * zfar * znear / (znear - zfar)
    m[3, 2] = -1.0
    return m


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10((255.0 ** 2) / mse)


def camera_parity(w, h, device="cuda"):
    """The camera arm (parity_report.py:106-124): the port's view_proj
    against the numpy nalgebra re-derivation, passing within 1e-4."""
    from sunray_tpu_torch.camera import Camera, camera_matrices

    cam = Camera(**CAMERA)
    ours = camera_matrices(cam, w, h, device=device)
    view = look_at_rh(cam.position, cam.target, (0.0, 1.0, 0.0))
    proj = perspective3(w / h, np.radians(45.0), 0.1, 100.0)
    proj[1, 1] *= -1.0                      # camera.rs:51 y-flip
    view_proj_ref = proj @ view
    vp_ours = ours["view_proj"].cpu().numpy().astype(np.float64)
    dv = float(np.abs(vp_ours - view_proj_ref).max())
    return {
        "max_abs_diff_view_proj": dv,
        "view_proj_ref_row0": [round(x, 6) for x in view_proj_ref[0]],
        "view_proj_ours_row0": [round(float(x), 6) for x in vp_ours[0]],
        "pass": bool(dv < 1e-4),
    }


def run(gltf, size="1600x1200", ref=None, out="out/parity_1600x1200.png",
        as_json=False, device="cuda"):
    """The report of parity_report.py:254-351, printed; returns it."""
    from sunray_tpu_torch.camera import Camera
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.pipeline import render_frame_with_camera
    from sunray_tpu_torch.render.renderer import Renderer
    from sunray_tpu_torch.utils.png import read_png, write_png

    w, h = (int(x) for x in size.split("x"))
    report = {"setup": {
        "scene": gltf,
        "camera": {"position": list(CAMERA["position"]),
                   "target": list(CAMERA["target"]),
                   "fov_y": CAMERA["fov_y"]},
        "size": [w, h], "warmup_frames": 16,
        "reference": "examples/png/main.rs:43-61",
    }}

    # -- 2. camera-matrix parity (independent nalgebra re-derivation) --
    report["camera_parity"] = camera_parity(w, h, device)

    # -- 1. the reference setup's render --
    cam = Camera(**CAMERA)
    cfg = RenderConfig(width=w, height=h, lighting="restir")
    r = Renderer(cfg, device=device)
    r.load_gltf(gltf)
    t0 = time.time()
    img = r.render_to_host_memory(cam, warmup=16)
    dt = time.time() - t0
    report["render"] = {"seconds": round(dt, 2)}
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    write_png(out, img)
    report["render"]["path"] = out

    # -- 3. aux-channel physical checks (the frame of parity_report.py:
    # 303-305: the report's own config, no load-time accel, from the
    # Renderer's state without advancing it) --
    ldr = r.render(cam)
    _, _, aux = render_frame_with_camera(r.scene, cfg, r.state, cam)
    normal = aux["normal"].cpu().numpy()
    depth = aux["depth"].cpu().numpy()
    nlen = np.linalg.norm(normal, axis=-1)
    hit = depth < 99999.0
    report["aux_checks"] = {
        "finite_ldr": bool(np.isfinite(ldr.cpu().numpy()).all()),
        "hit_coverage": round(float(hit.mean()), 4),
        "normal_unit_on_hits": round(
            float(np.abs(nlen[hit & (nlen > 0)] - 1.0).max()), 6
        ) if hit.any() else None,
        "depth_range_on_hits": [
            round(float(depth[hit].min()), 3),
            round(float(depth[hit].max()), 3),
        ] if hit.any() else None,
    }

    # -- 4. PSNR vs a reference render, when provided --
    if ref and os.path.exists(ref):
        ref_img = read_png(ref)
        mine = img[..., :3]
        if ref_img.shape[:2] != mine.shape[:2]:
            report["psnr_vs_reference"] = {
                "error": f"size mismatch {ref_img.shape} vs {mine.shape}"
            }
        else:
            ref3 = ref_img[..., :3]
            report["psnr_vs_reference"] = {
                "psnr_db": round(psnr(mine, ref3), 2),
                "mean_abs_diff": round(
                    float(np.abs(mine.astype(np.float64)
                                 - ref3.astype(np.float64)).mean()), 3
                ),
                "ref": ref,
            }
    else:
        report["psnr_vs_reference"] = {"status": NO_REF}

    print(json.dumps(report, indent=None if as_json else 2))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gltf", required=True,
                    help="GLB/glTF scene (the reference's ReflectionRoom.glb "
                         "is not in the repository)")
    ap.add_argument("--size", default="1600x1200",
                    help="render size (reference: 1600x1200)")
    ap.add_argument("--ref", default=None,
                    help="reference render PNG to compare against")
    ap.add_argument("--out", default="out/parity_1600x1200.png")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    return run(args.gltf, size=args.size, ref=args.ref, out=args.out,
               as_json=args.json, device="cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()
