"""PyTorch port, the many-lights Cornell box
(scene/procedural.cornell_box_many_lights, JAX procedural.py:122-169): a
panels x panels grid of ceiling emitters, 2 * panels^2 light triangles.
The scene against JAX's for panels 12 (288 lights) and 17 (578, K3's
table above 512 entries, examples/ab_many_lights.py:57), every array
bit-equal; and a small 578-light ReSTIR frame against the JAX frame
(PSNR > 40 dB, reservoirs by the take-flip scheme).
"""

import numpy as np
import pytest

from sunray_tpu.scene import cornell_box_many_lights as jmany
from sunray_tpu_torch.scene import cornell_box_many_lights
from torch_frame_cases import reservoir_agreement, run_frames
from torch_parity import GOLDEN_KW, WINNER_AGREE, n, psnr, to_numpy

PSNR_MIN = 40.0


@pytest.mark.parametrize("panels", [12, 17])
def test_scene_matches_jax(panels):
    want = to_numpy(jmany(panels))
    got = cornell_box_many_lights(panels, device="cpu")
    assert got.num_lights == want["light_world_tri"].shape[0] == 2 * panels ** 2

    def walk(w, g, path):
        if isinstance(w, dict):
            for k, v in w.items():
                walk(v, getattr(g, k), f"{path}.{k}")
        elif w is None:
            assert g is None, path
        else:
            gn = n(g) if hasattr(g, "detach") else np.asarray(g)
            assert gn.dtype == w.dtype, path
            np.testing.assert_array_equal(gn, w, err_msg=path)

    walk(want, got, "scene")


@pytest.fixture(scope="module")
def frames():
    kw = dict(GOLDEN_KW, lighting="restir", width=48, height=32)
    return run_frames(kw, 2, jscene=jmany(17))


def test_578_light_frame_matches_jax(frames):
    assert frames["scene"].num_lights == 578
    for i, ((jl, _, _), (pl, _, _)) in enumerate(zip(frames["jax"],
                                                     frames["port"])):
        p = psnr(pl, jl)
        assert p > PSNR_MIN, f"frame {i}: PSNR vs JAX {p:.2f} dB"


def test_578_light_reservoirs_match_jax(frames):
    for (_, _, js), (_, _, st) in zip(frames["jax"], frames["port"]):
        assert reservoir_agreement(st, js, "res_di", "light_idx",
                                   "light_pos") > WINNER_AGREE
        # The audition samples the grid: many lights win somewhere.
        assert np.unique(n(st.res_di.light_idx)).size > 100
