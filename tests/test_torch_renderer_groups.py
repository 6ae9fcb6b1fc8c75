"""PyTorch port, the Renderer's scene groups (lib.rs:779/849) on two
small synthetic GLBs (tests/torch_renderer_cases.py): load_gltf twice
(the second group's textures merged into the atlas, its meshes prefixed),
a frame above 40 dB PSNR against the JAX Renderer, unload_scene of the
second group (its atlas slice removed, the first group's texture indices
restored), a frame above 40 dB again, and the instance lists, capacities
and atlases equal to JAX's throughout."""

import numpy as np
import pytest

from torch_parity import n, psnr
from torch_renderer_cases import PSNR_MIN, frames, glb, renderers


def _state(r):
    tex = r._manager._textures
    return ([k for k, _ in r._instances], int(r.scene.num_tris),
            int(r.scene.inst_prim.shape[0]),
            None if tex is None else tuple(tex.data.shape),
            {k: tuple(np.asarray(m.material["tex_index"]).tolist())
             for k, m in r._manager._meshes.items()})


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    a = glb(tmp_path_factory, seed=0, spheres=4)
    b = glb(tmp_path_factory, seed=1, spheres=3)
    jr, pr = renderers(tracer="auto")
    out = {}
    for r in (jr, pr):
        r.load_gltf(a)
    first = [_state(r) for r in (jr, pr)]
    for r in (jr, pr):
        r.load_gltf(b)
    out["both"] = [_state(r) for r in (jr, pr)]
    out["both_frame"] = frames(jr, pr, 1)[0]
    for r in (jr, pr):
        r.unload_scene(r.last_scene_group)
    out["after"] = [_state(r) for r in (jr, pr)]
    out["after_frame"] = frames(jr, pr, 1)[0]
    out["first"] = first
    out["atlas"] = (np.asarray(jr._manager._textures.data),
                    n(pr._manager._textures.data))
    return out


def test_groups_match_jax(groups):
    for key in ("first", "both", "after"):
        assert groups[key][0] == groups[key][1], key
    # unloading the second group restores the first's meshes and textures
    assert groups["after"][1][0] == groups["first"][1][0]
    assert groups["after"][1][3] == groups["first"][1][3]
    assert groups["after"][1][4] == groups["first"][1][4]
    assert groups["both"][1][3][0] == 2 * groups["first"][1][3][0]
    np.testing.assert_array_equal(*groups["atlas"])


@pytest.mark.parametrize("when", ["both_frame", "after_frame"])
def test_group_frames_match_jax(groups, when):
    jl, pl = groups[when]
    assert np.isfinite(pl).all()
    p = psnr(pl, jl)
    assert p > PSNR_MIN, f"{when}: PSNR vs JAX {p:.2f} dB"
