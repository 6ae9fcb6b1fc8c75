"""Seeded DI spatial frames for K5's tests: the CPU model of its order of
work (tests/test_torch_di_spatial_terms.py) and the kernel on the card
(tests/test_torch_cuda.py). Imports no JAX."""

import numpy as np
import torch

from sunray_tpu_torch.ops.cuda_restir import LightTable

CLAMPS = (20.0, 30.0, 10.0)          # (w_clamp, m_clamp, w_spatial_clamp)
N_LIGHTS = 3
FIELDS = ("light_pos", "light_normal", "w_sum", "M", "light_idx",
          "w_spatial", "f_y_w", "has")


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _frame(seed, width, height, device):
    """A seeded width x height frame: smooth normals and depths (most
    neighbours pass the test), random materials, N_LIGHTS lights above the surfaces, a
    centre reservoir with ids up to N_LIGHTS + 1, some W = 0, and ~15% of
    lanes not pending."""
    rng = np.random.default_rng(seed)
    p = width * height
    yy, xx = np.mgrid[0:height, 0:width].reshape(2, -1).astype(np.float32)
    pos = np.stack([xx / width * 2.0, yy / height * 2.0,
                    0.1 * np.sin(xx / 5.0) + 0.02 * rng.normal(size=p)], -1)
    normal = _unit(np.stack([0.1 * np.cos(xx / 5.0), 0.05 * np.sin(yy / 4.0),
                             np.ones(p)], -1) + rng.normal(size=(p, 3)) * 0.05)
    view = _unit(np.array([1.0, 1.0, 3.4]) - pos)
    v0 = rng.uniform([0.3, 0.3, 1.5], [1.7, 1.7, 1.9], (N_LIGHTS, 3))
    table = [v0, v0 + rng.uniform(-0.3, 0.3, (N_LIGHTS, 3)),
             v0 + rng.uniform(-0.3, 0.3, (N_LIGHTS, 3)),
             rng.uniform(1.0, 20.0, (N_LIGHTS, 3))]
    lpos = rng.uniform([0.2, 0.2, 1.4], [1.8, 1.8, 2.0], (p, 3))
    lnrm = _unit(np.array([0.0, 0.0, -1.0]) + rng.normal(size=(p, 3)) * 0.2)
    w = rng.uniform(0.0, 5.0, p)
    w[rng.random(p) < 0.1] = 0.0
    idx = rng.integers(0, N_LIGHTS + 2, p)                    # >= n_lights too
    depth = np.linalg.norm(pos - np.array([1.0, 1.0, 3.4]), axis=-1)

    def f(x, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(x, dt)).to(device)

    center = dict(light_pos=f(lpos), light_normal=f(lnrm), W=f(w),
                  M=f(rng.integers(1, 40, p)), light_idx=f(idx, np.int32))
    return (LightTable(*(f(x) for x in table)),
            f(rng.integers(0, 2**32, p, dtype=np.uint32), np.int64), center,
            f(rng.random(p) > 0.15, bool), f(normal),
            f(depth * (1.0 + rng.normal(size=p) * 0.05)), f(depth), f(pos),
            f(normal), f(view), f(rng.uniform(0, 1, (p, 3))),
            f(rng.uniform(0.05, 1.0, p)), f(rng.uniform(0, 1, p)))


def di_spatial_args(taps, seed, width=32, height=24, device="cpu"):
    """cuda_restir.di_spatial's arguments on a seeded frame with the shared
    tap offsets `taps`."""
    (table, seeds, center, pending, gnormal, gdepth, cur, pos, normal, view,
     albedo, rough, metal) = _frame(seed, width, height, device)
    return (table, seeds, center, list(taps), pending, gnormal, gdepth, cur,
            pos, normal, view, albedo, rough, metal, width, height, CLAMPS)
