"""The converged-truth quality cases (tests/test_quality.py) on the port:
the shipped BASELINE configs at 128x72, run as the JAX test runs them
(RUN_WARMUP frames, then the mean raw HDR output of RUN_FRAMES frames and
the last frame's LDR), scored against the checked-in truths
(tests/goldens/quality_gt_*.npz, made with per-pixel spatial taps) under
the ledger's bounds (tests/goldens/quality_ledger.json: 1.3x its relMSE,
1 dB below its PSNR; test_quality.py:48-70), with the port's own tonemap.

No JAX: tests/test_torch_quality*.py run the cases on the CPU and
chip_smoke.py's phase 12 on the card. Case 2 needs ReflectionRoom.glb,
which the repository does not hold; it is left out, as the JAX test
leaves it out where the file is absent (test_quality.py:110-115).
"""

import json
import os

import numpy as np
import torch

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
SIZE = (128, 72)              # test_quality.py:30
RUN_FRAMES, RUN_WARMUP = 8, 4  # test_quality.py:33-34
RELMSE_HEADROOM, PSNR_HEADROOM_DB = 1.3, 1.0   # test_quality.py:45-46
CORNELL_CAM = dict(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0),
                   fov_y=45.0)
CASES = {     # test_quality.py:76-115: (scene, camera, config)
    "1_cornell_1spp_nodenoise": (
        "cornell", CORNELL_CAM,
        dict(lighting="nee", denoise_passes=0, enable_taa=False)),
    "3_multimesh_restir_4spp": (
        "reflroom_proc",
        dict(position=(2.0, 2.2, 9.0), target=(2.0, 1.6, 0.0), fov_y=50.0),
        dict(lighting="restir", samples=4)),
    "4_progressive_64f_1080p": (
        "cornell", CORNELL_CAM, dict(lighting="restir", denoise_passes=0)),
    "5_full_pipeline": ("cornell", CORNELL_CAM, dict(lighting="restir")),
}


def bounds(name):
    """(relMSE bound, PSNR bound) from the checked-in ledger."""
    with open(os.path.join(GOLDENS, "quality_ledger.json")) as f:
        e = json.load(f)[name]
    return e["relmse_raw"] * RELMSE_HEADROOM, e["psnr_ldr"] - PSNR_HEADROOM_DB


def truth(name):
    path = os.path.join(GOLDENS, f"quality_gt_{name}.npz")
    return np.load(path)["gt_raw"].astype(np.float64)


def run_case(name, device):
    """(mean raw HDR over RUN_FRAMES frames after RUN_WARMUP, final LDR),
    numpy, of case `name` rendered on `device`."""
    from sunray_tpu_torch.camera import Camera, camera_matrices
    from sunray_tpu_torch.config import RenderConfig
    from sunray_tpu_torch.render.pipeline import RenderState, render_frame
    from sunray_tpu_torch.scene import cornell_box, reflection_room

    kind, cam, kw = CASES[name]
    w, h = SIZE
    cfg = RenderConfig(width=w, height=h, **kw)
    scene = (cornell_box if kind == "cornell" else reflection_room)(
        device=device)
    mats = camera_matrices(Camera(**cam), w, h, device=device)
    state = RenderState.create(cfg, device)
    acc = ldr = None
    for i in range(RUN_WARMUP + RUN_FRAMES):
        state, ldr, aux = render_frame(scene, cfg, state, mats)
        if i >= RUN_WARMUP:
            raw = aux["raw"].double().cpu().numpy()
            acc = raw if acc is None else acc + raw
    return acc / RUN_FRAMES, ldr.cpu().numpy()


def rel_mse(a, gt, eps=1e-3):
    """test_quality.py:142-144."""
    d = (np.asarray(a, np.float64) - gt) ** 2
    return float(np.mean(d / (gt * gt + eps)))


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def score(name, mean_raw, ldr):
    """(relMSE, PSNR, relMSE bound, PSNR bound) of a run against the
    truth, the truth tonemapped by the port (exposure 1, ACES, gamma 2.2,
    test_quality.py:155-162)."""
    from sunray_tpu_torch.render.postprocess import tonemap

    gt = truth(name)
    gt_ldr = tonemap(torch.from_numpy(gt.astype(np.float32)), 1.0, "aces",
                     2.2).numpy()
    r_max, p_min = bounds(name)
    return rel_mse(mean_raw, gt), psnr(ldr, gt_ldr), r_max, p_min


def check_case(name, device="cpu"):
    """Run case `name` on `device` and hold it to its truth under the
    ledger's bounds (the asserts of test_quality.py:124-139)."""
    mean_raw, ldr = run_case(name, device)
    assert np.isfinite(mean_raw).all() and np.isfinite(ldr).all()
    r, p, r_max, p_min = score(name, mean_raw, ldr)
    print(f"{name}: relMSE {r:.4f} (bound {r_max:.4f}), PSNR {p:.2f} dB "
          f"(bound {p_min:.2f})")
    assert r < r_max, f"{name}: relMSE vs converged truth {r:.4f} > {r_max}"
    assert p > p_min, f"{name}: LDR PSNR vs converged truth {p:.2f} < {p_min}"
