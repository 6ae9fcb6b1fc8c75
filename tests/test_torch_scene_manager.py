"""PyTorch port, scene/manager.py, ops/accel_state.py and the Renderer's
accel choice: SceneManager (from_scene_buffers, default_instances, build
with capacity padding, add/remove) equal to JAX's on the Cornell box and
a spawn; degenerate padding never hit; AsState's ops equal to JAX's over
scripted sequences; the Renderer's AsState op sequence over a scripted
churn (fresh scene, static frames, animation, spawn, settling, a
directly loaded scene) equal to JAX's Renderer, frame by frame; "auto"
above the brute limit picking binned / two-level as JAX's does."""

import numpy as np
import pytest

from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.ops import accel_state as jaccel
from sunray_tpu.render.renderer import Renderer as JRenderer
from sunray_tpu.scene import cornell_box as jcornell_box
from sunray_tpu.scene.manager import SceneManager as JManager
from sunray_tpu.scene.manager import pad_scene_capacity as jpad
from sunray_tpu.scene.types import translate
from sunray_tpu_torch import convert
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import accel_state, binned_trace, bvh, bvh2, intersect
from sunray_tpu_torch.render.renderer import Renderer
from sunray_tpu_torch.scene import cornell_box
from sunray_tpu_torch.scene.manager import SceneManager, pad_scene_capacity
from test_scene_manager import tri_mesh
from torch_parity import n, t, to_numpy

KW = dict(width=32, height=24, bounces=2, virtual_bounces=1, ris_candidates=2,
          di_spatial_samples=1, gi_spatial_samples=1, denoise_passes=0,
          tracer="bvh")


def assert_scene_equal(jscene, pscene):
    def walk(want, got, pre=""):
        for k, v in want.items():
            g = getattr(got, k)
            if isinstance(v, dict):
                walk(v, g, f"{pre}{k}.")
            elif v is None:
                assert g is None, pre + k
            else:
                np.testing.assert_array_equal(n(g), v, err_msg=pre + k)
    walk(to_numpy(jscene), pscene)


def managers():
    jm = JManager.from_scene_buffers(jcornell_box())
    pm = SceneManager.from_scene_buffers(cornell_box(device="cpu"))
    return jm, pm


@pytest.mark.parametrize("pad", [False, True])
def test_build_matches_jax(pad):
    jm, pm = managers()
    jinst = jm.default_instances(jcornell_box())
    pinst = pm.default_instances(cornell_box(device="cpu"))
    assert [k for k, _ in jinst] == [k for k, _ in pinst]
    assert_scene_equal(jm.build(jinst, pad_to_capacity=pad),
                       pm.build(pinst, pad_to_capacity=pad))
    # a spawn of the smallest mesh and a runtime mesh add, then a removal
    small = min(jinst, key=lambda kt: jm._meshes[kt[0]].tri_vidx.shape[0])[0]
    p, nrm, tri = tri_mesh()
    for m in (jm, pm):
        m.add_mesh("quad", p, nrm, tri, {"base_color": (1, 1, 1, 1),
                                         "emissive_factor": (1, 1, 1, 30.0)})
    more = [(small, translate(0.1, 0.0, 0.1)), ("quad", translate(0, 0, 0))]
    assert_scene_equal(jm.build(jinst + more, pad_to_capacity=pad),
                       pm.build(pinst + more, pad_to_capacity=pad))
    jm.remove_mesh("quad")
    pm.remove_mesh("quad")
    assert_scene_equal(jm.build(jinst), pm.build(pinst))
    assert pm._tri_cap == jm._tri_cap and pm._inst_cap == jm._inst_cap


def test_pad_scene_capacity_matches_jax():
    jscene = jpad(jcornell_box(), 100, 9)
    pscene = pad_scene_capacity(cornell_box(device="cpu"), 100, 9)
    assert_scene_equal(jscene, pscene)
    assert pscene.num_tris == 100 and pscene.inst_prim.shape[0] == 9


def test_degenerate_padding_never_hits():
    scene = pad_scene_capacity(cornell_box(device="cpu"))
    h = intersect.trace_closest_brute(scene.world_triangle_vertices(),
                                      t(np.float32([[1.0, 1.0, 1.0]])),
                                      t(np.float32([[0.0, -1.0, 0.0]])))
    assert bool(h.hit[0]) and float(h.t[0]) == pytest.approx(1.0, rel=1e-4)


@pytest.mark.parametrize("script", ["settle", "dynamic", "topology"])
def test_as_state_matches_jax(script):
    g = np.random.default_rng(len(script))
    seq = {"settle": [(False, False)] * 20,
           "dynamic": [(True, False)] * 12,
           "topology": [tuple(x) for x in g.random((40, 2)) < 0.3]}[script]
    states = (jaccel.AsState(), accel_state.AsState())
    for st, mod in zip(states, (jaccel, accel_state)):
        st.mark(mod.FAST_BUILD, changed=True)
    for geom, topo in seq:
        ops = [st.next_op(geometry_changed=geom, topology_changed=topo)
               for st in states]
        assert ops[0] == ops[1]
        for st in states:
            st.mark(ops[0], changed=geom or topo)
        assert dataclass_tuple(states[0]) == dataclass_tuple(states[1])


def dataclass_tuple(st):
    return (st.optimal, st.updates_since_rebuild, st.quiet_frames)


def _renderers(**over):
    cfg = dict(KW, **over)
    jr = JRenderer(JConfig(**cfg))
    pr = Renderer(RenderConfig(**cfg), device="cpu")
    for r, m, scene in ((jr, JManager, jcornell_box()),
                        (pr, SceneManager, cornell_box(device="cpu"))):
        r._manager = m.from_scene_buffers(scene)
        r._instances = r._manager.default_instances(scene)
        r.scene = r._manager.build(r._instances)
    return jr, pr


def _nudged(instances, dx):
    out = list(instances)
    out[0] = (out[0][0], translate(dx, 0.0, 0.0))
    return out


def test_renderer_churn_ops_match_jax():
    """Frame by frame: load (SLOW_BUILD), quiet frames, 12 moving frames
    (UPDATE x8 then FAST_BUILD), a spawn (FAST_BUILD), quiet frames until
    the settling SLOW_BUILD, a despawn."""
    jr, pr = _renderers()
    inst = list(pr._instances)
    small = min(inst, key=lambda kt: pr._manager._meshes[kt[0]]
                .tri_vidx.shape[0])[0]
    script = ([None] * 4 + [_nudged(inst, 0.001 * (k + 1)) for k in range(12)]
              + [inst + [(small, translate(0.1, 0.0, 0.1))]]
              + [None] * (accel_state.FRAMES_TO_SETTLE + 2) + [inst])
    ops = []
    for frame in script:
        got = []
        for r in (jr, pr):
            if frame is not None:
                r.set_instances(frame)
            accel = r._scene_accel()
            got.append(r.last_accel_op)
        assert got[0] == got[1], f"frame {len(ops)}: {got}"
        assert isinstance(accel, bvh.Bvh)
        ops.append(got[1])
    assert ops[0] == accel_state.SLOW_BUILD
    assert ops.count(accel_state.UPDATE) >= 8
    assert ops.count(accel_state.SLOW_BUILD) == 2
    assert ops[-1] == accel_state.FAST_BUILD


def test_directly_loaded_scene_builds_once():
    r = Renderer(RenderConfig(**KW), scene=cornell_box(device="cpu"),
                 device="cpu")
    accel = r._scene_accel()
    assert r.last_accel_op == accel_state.SLOW_BUILD
    for _ in range(3):
        assert r._scene_accel() is accel and r.last_accel_op == "none"
    r.load_scene(cornell_box(device="cpu"))
    assert r._scene_accel() is not accel
    assert r.last_accel_op == accel_state.SLOW_BUILD


@pytest.mark.parametrize("over,want", [
    (dict(tracer="auto", brute_force_max_tris=4), bvh2.BlasSet),
    (dict(tracer="auto", brute_force_max_tris=4, bvh2_blas_max_tris=2),
     binned_trace.ClusterSet),
    (dict(tracer="auto"), type(None)),
    (dict(tracer="bvh2"), bvh2.BlasSet),
    (dict(tracer="binned"), binned_trace.ClusterSet)])
def test_auto_mode_matches_jax(over, want):
    jr, pr = _renderers(**over)
    jacc, pacc = jr._scene_accel(), pr._scene_accel()
    assert isinstance(pacc, want)
    assert type(jacc).__name__ == type(pacc).__name__
    assert pr._scene_accel() is pacc          # cached for the same topology
    if want is bvh2.BlasSet:
        ref = convert.blas_set_from_numpy(to_numpy(jacc), device="cpu")
        np.testing.assert_array_equal(n(pacc.node_box), n(ref.node_box))
