"""PyTorch port, parallel/sharding.training_step on 4 gloo ranks
(tests/torch_dist.py) at (dp, sp) = (2, 2) against the JAX package's
training_step on a (2, 2) mesh of the conftest's virtual devices: the
training config of __graft_entry__.dryrun_multichip (NEE, TAA off, no
denoise, differentiable; 32 x 16, two views, one a dp row), seeded random
targets, the loss and the gradient w.r.t. base_color within 1e-5
relative; the ReSTIR config (TAA, denoise) at sp = 2 running, finite and
the same on every rank; and examples/torch_train_multiview.py for 2 steps on 2 gloo ranks (loss
finite). The JAX compile (~30 s) runs while the ranks render."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread in this process)
from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.parallel.sharding import make_mesh as jmake_mesh
from sunray_tpu.parallel.sharding import training_step as jtraining_step
from sunray_tpu.scene import cornell_box as jcornell_box
from torch_dist import run_ranks, train_step
from torch_parity import REPO, to_numpy

DP, SP = 2, 2
W, H = 32, 8 * SP                         # __graft_entry__.py:66-67
KW = dict(width=W, height=H, lighting="nee", bounces=2, virtual_bounces=2,
          denoise_passes=0, enable_taa=False, differentiable=True)
VIEWS = max(DP, 2)
RTOL = 1e-5
# ReSTIR with TAA and 2 a-trous passes, its halos within the 8 rows the
# other band holds.
RESTIR_KW = dict(lighting="restir", enable_taa=True, denoise_passes=2,
                 di_spatial_radius=6.0, gi_spatial_radius=6.0,
                 history_gather_halo=8)


@pytest.fixture(scope="module")
def steps():
    scene = jcornell_box()
    cams = [JCamera(position=(1.0, 1.0, 3.2 + 0.1 * i),
                    target=(1.0, 1.0, 0.0), fov_y=45.0) for i in range(VIEWS)]
    mats = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[jcamera_matrices(c, W, H) for c in cams])
    rng = np.random.default_rng(21)
    targets = rng.uniform(0.0, 1.0, (VIEWS, H, W, 3)).astype(np.float32)
    case = dict(dp=DP, kw=KW, restir_kw=RESTIR_KW, scene=to_numpy(scene),
                mats={k: np.asarray(v) for k, v in mats.items()},
                targets=targets)

    def reference():
        mesh = jmake_mesh(DP * SP)
        assert mesh.devices.shape == (DP, SP)
        loss, grad = jtraining_step(scene, JConfig(**KW), mats,
                                    jnp.asarray(targets), mesh)
        return float(loss), np.asarray(grad)

    return run_ranks(DP * SP, train_step, case, meanwhile=reference)


def test_mesh_placement(steps):
    got, _ = steps
    for rank, r in enumerate(got):
        assert r["mesh"] == (DP, SP, rank // SP, rank % SP)


def test_loss_matches_jax(steps):
    got, (loss, _) = steps
    for r in got:
        np.testing.assert_allclose(float(r["loss"]), loss, rtol=RTOL)


def test_gradient_matches_jax(steps):
    """Within 1e-5 of the largest |gradient| component, every component;
    the same bits on every rank."""
    got, (_, grad) = steps
    scale = np.abs(grad).max()
    assert scale > 0
    for r in got:
        np.testing.assert_allclose(r["grad"], grad, rtol=0,
                                   atol=RTOL * scale)
        np.testing.assert_array_equal(r["grad"], got[0]["grad"])


def test_restir_refused_at_sp2(steps):
    """The ReSTIR config at sp = 2 runs (tests/test_torch_training_restir.py
    holds its value to JAX): its loss and gradient finite, the same bits
    on every rank."""
    got, _ = steps
    for r in got:
        loss, grad = r["restir"]
        assert np.isfinite(loss) and loss > 0
        assert np.isfinite(grad).all() and np.abs(grad).max() > 0
        assert loss.tobytes() == got[0]["restir"][0].tobytes()
        assert grad.tobytes() == got[0]["restir"][1].tobytes()


def test_example_two_steps_on_two_ranks(tmp_path):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "torch_train_multiview.py"),
         "--cpu-ranks", "2", "--steps", "2",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    losses = [float(x) for x in re.findall(r"loss (\S+)", proc.stdout)]
    assert len(losses) >= 2 and np.isfinite(losses).all(), proc.stdout
    assert "mesh (1, 2)" in proc.stdout
