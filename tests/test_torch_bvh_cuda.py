"""PyTorch port on the card, B2 and B3 (csrc/bvh.cu): the unified walk
(LBVH and SAH trees, leaf sizes 1, 4 and 8, one leaf) and the two-level
walk (many instances, one instance, a TLAS too large for shared memory,
32- and 64-bit stack words) against their plain twin (ops/bvh.walk_plain)
on camera, bounce, grazing and axis-parallel rays: t, tri, u, v and hit
bit-equal (tmax finite and infinite), any hit with and without exclude ids bit-equal, the kernel's
test counters equal to the twin's;
a degenerate chain 100 nodes deep whose walks spill the stack past its
shared-memory entries and reach the clamp at 63; the fused alpha walk
against its plain twin (ops/bvh.walk_alpha_plain) and the batch rounds
over the kernel (render/trace.py) on the synthetic GLB, the tunnel and the
wrap-mode scenes, one launch a query; a mixed-device call raises.
Skipped where there is no CUDA device; imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_bvh_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.native import build_sah_bvh
from sunray_tpu_torch.ops import bvh, bvh2, cuda_build, cuda_bvh, intersect
from sunray_tpu_torch.render import trace
from sunray_tpu_torch.scene.gltf import load_gltf
from sunray_tpu_torch.scene.types import MaterialTable, TextureAtlas, build_scene
from torch_bvh_cases import (
    alpha_scene_rays,
    ray_families,
    soup,
    tunnel_arrays,
    wraps_arrays,
)
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.gpu

FAMILIES = ["camera", "bounce", "grazing", "axis"]


def check_walk(tables, tris_np, dev):
    for family in FAMILIES:
        o, d = (torch.from_numpy(x).to(dev)
                for x in ray_families(tris_np, n=4096, seed=3)[family])
        n = o.shape[0]
        tn = torch.full((n,), intersect.T_MIN, device=dev)
        tests = torch.empty((n, 2), dtype=torch.int32, device=dev)
        # The walk takes any tmax, an infinite one too.
        for far in (intersect.T_MAX, torch.inf):
            tx = torch.full((n,), far, device=dev)
            t, tri, u, v, hit = cuda_bvh._launch(tables, o, d, tn, tx, None,
                                                 False, tests=tests)
            plain = bvh.walk_plain(tables, o, d, tn, tx, any_hit=False)
            assert torch.equal(hit, plain.found), family
            assert torch.equal(tri, plain.tri), family
            pt = torch.where(plain.found, plain.t, torch.inf)
            for a, b in ((t, pt), (u, plain.u), (v, plain.v)):
                assert torch.equal(a.view(torch.int32),
                                   b.view(torch.int32)), family
            assert torch.equal(tests, torch.stack(
                [plain.box_tests, plain.tri_tests], 1).to(torch.int32))
        seg = torch.rand((n,), generator=torch.Generator(dev).manual_seed(1),
                         device=dev) * 6
        ex = torch.where(torch.arange(n, device=dev) % 2 == 0, tri, -1)
        for exclude in (None, ex.contiguous()):
            got = cuda_bvh._launch(tables, o, d, tn, seg, exclude, True,
                                   tests=tests)[4]
            want = bvh.walk_plain(tables, o, d, tn, seg, any_hit=True,
                                  exclude=exclude)
            assert torch.equal(got, want.found), family
            assert torch.equal(tests, torch.stack(
                [want.box_tests, want.tri_tests], 1).to(torch.int32))


@pytest.mark.parametrize("build,leaf,count", [
    ("lbvh", 4, 400), ("lbvh", 1, 300), ("lbvh", 8, 1000), ("lbvh", 4, 3),
    ("sah", 4, 400), ("sah", 2, 1000)])
def test_b2_matches_plain(cuda_device, build, leaf, count):
    tris_np = soup(count, seed=count, floor=6 if count > 10 else 0)
    tris = tuple(torch.from_numpy(x).to(cuda_device) for x in tris_np)
    b = (bvh.build_bvh(tris, leaf) if build == "lbvh"
         else build_sah_bvh(*tris_np, leaf_size=leaf, device=cuda_device))
    before = cuda_build.launches["bvh_walk"]
    check_walk(bvh.pack_tables(b, tris), tris_np, cuda_device)
    assert cuda_build.launches["bvh_walk"] > before


def instanced(n_inst, dev):
    g = np.random.default_rng(n_inst)
    pos, tv, pt, off = [], [], [], 0
    for p, cnt in enumerate((300, 90)):
        c = g.uniform(-1, 1, (cnt, 3))
        v = np.stack([c, c + g.normal(0, .2, (cnt, 3)),
                      c + g.normal(0, .2, (cnt, 3))], 1).astype(np.float32)
        pos.append(v.reshape(-1, 3))
        tv.append(np.arange(3 * cnt).reshape(cnt, 3) + off)
        pt.append(np.full(cnt, p))
        off += 3 * cnt
    pos = np.concatenate(pos)
    inst = []
    for i in range(n_inst):
        a = 0.7 * i
        m = np.array([[np.cos(a), 0, np.sin(a)], [0, 1.2, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32) * (0.5 + 0.1 * i)
        inst.append((i % 2, np.concatenate(
            [m, g.uniform(-3, 3, (3, 1)).astype(np.float32)], 1)))
    return build_scene(pos, np.zeros_like(pos), np.concatenate(tv),
                       np.concatenate(pt), MaterialTable.build([{}, {}], dev),
                       inst, device=dev)


@pytest.mark.parametrize("n_inst,words", [(1, 32), (9, 32), (40, 32), (40, 64),
                                          (200, 32), (200, 64)])
def test_b3_matches_plain(cuda_device, monkeypatch, n_inst, words):
    """200 instances: 199 TLAS rows, more than shared memory stages."""
    scene = instanced(n_inst, cuda_device)
    tables = bvh2.build_frame_tlas(bvh2.build_blas_set(scene), scene)
    assert tables.tlas_rows == n_inst - 1
    assert cuda_bvh.smem_rows(tables) == (
        n_inst - 1 if n_inst - 1 <= cuda_bvh.TLAS_SMEM_ROWS else 0)
    assert cuda_bvh.node_bits(tables) > 0
    if words == 64:
        monkeypatch.setattr(cuda_bvh, "node_bits", lambda tables: 0)
    tris_np = tuple(x.cpu().numpy() for x in scene.world_triangle_vertices())
    before = cuda_build.launches["bvh2_walk"]
    check_walk(tables, tris_np, cuda_device)
    assert cuda_build.launches["bvh2_walk"] > before


def chain_tables(dev, depth=100, two_level=False):
    """A degenerate tree: internal row j's children are internal row j + 1
    (left) and leaf j (right), both boxes the whole scene's, so every walk
    pushes a leaf and descends: the stack grows one entry a level, past the
    shared-memory entries, to the clamp at 63. Leaf j holds one triangle
    facing +z at a seeded depth. Two levels: the leaves alternate between
    instance codes 1 and 2 (two transforms), the last 12 rows staged in
    shared memory."""
    g = np.random.default_rng(depth)
    nl = depth + 1
    z = g.uniform(-4.0, 4.0, nl).astype(np.float32)
    corners = np.stack([np.stack([np.full(nl, -5.0), np.full(nl, -5.0), z], 1),
                        np.stack([np.full(nl, 5.0), np.full(nl, -5.0), z], 1),
                        np.stack([np.zeros(nl), np.full(nl, 5.0), z], 1)], 1)
    leaf_v = torch.from_numpy(corners.reshape(nl, 1, 9).astype(np.float32))
    j = np.arange(depth)
    left = np.where(j + 1 < depth, nl + j + 1, depth)
    codes = (1 + j % 2) if two_level else np.zeros(depth)
    ids = np.stack([left, j, np.zeros(depth), codes], 1).astype(np.int32)
    box = np.tile(np.float32([-10, -10, -10, 10, 10, 10] * 2), (depth, 1))
    kw = {}
    if two_level:
        a1 = np.float32([1.2, 0, 0, 0, 0.9, 0, 0, 0, 1.1, 0.1, -0.2, 0.05])
        a2 = np.float32([0.8, 0.1, 0, 0, 1, 0, 0, -0.1, 1, -0.3, 0.1, 0.2])
        ident = np.float32([1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0])
        kw = dict(inst_inv=torch.from_numpy(np.stack([ident, a1, a2])).to(dev),
                  inst_off=torch.tensor([0, 0, 1000], dtype=torch.int32,
                                        device=dev), tlas_rows=12)
    return bvh.WalkTables(
        torch.from_numpy(ids).to(dev), torch.from_numpy(box).to(dev),
        leaf_v.to(dev), torch.arange(nl, dtype=torch.int32).reshape(nl, 1).to(dev),
        torch.tensor([nl, 1 if two_level else 0], dtype=torch.int32,
                     device=dev), leaf_e=bvh.leaf_edges(leaf_v).to(dev), **kw)


@pytest.mark.parametrize("two_level,words", [(False, 32), (True, 32),
                                             (True, 64)])
def test_deep_chain_spills_and_clamps(cuda_device, monkeypatch, two_level,
                                      words):
    tables = chain_tables(cuda_device, two_level=two_level)
    if words == 64:
        monkeypatch.setattr(cuda_bvh, "node_bits", lambda tables: 0)
    g = np.random.default_rng(7)
    n = 4096
    o = np.stack([g.uniform(-1, 1, n), g.uniform(-1, 1, n),
                  np.full(n, 6.0)], 1).astype(np.float32)
    d = np.stack([g.normal(0, 0.05, n), g.normal(0, 0.05, n),
                  -np.ones(n)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o, d = (torch.from_numpy(x).to(cuda_device) for x in (o, d))
    tn = torch.full((n,), intersect.T_MIN, device=cuda_device)
    tx = torch.full((n,), intersect.T_MAX, device=cuda_device)
    tests = torch.empty((n, 2), dtype=torch.int32, device=cuda_device)
    for any_hit in (False, True):
        t, tri, u, v, hit = cuda_bvh._launch(tables, o, d, tn, tx, None,
                                             any_hit, tests=tests)
        plain = bvh.walk_plain(tables, o, d, tn, tx, any_hit=any_hit)
        assert torch.equal(hit, plain.found)
        assert torch.equal(tests, torch.stack(
            [plain.box_tests, plain.tri_tests], 1).to(torch.int32))
        if not any_hit:
            assert torch.equal(tri, plain.tri)
            pt = torch.where(plain.found, plain.t, torch.inf)
            for a, b in ((t, pt), (u, plain.u), (v, plain.v)):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # The walks pushed past the shared entries to the clamp: the stack
    # holds 63 leaves when the descent is cut at row 63 (the clamp
    # overwrites the top), so a closest walk tests 63 rows' boxes and 63
    # leaves of the chain's 100.
    full = bvh.walk_plain(tables, o, d, tn, tx, any_hit=False)
    assert bool((full.box_tests == 2 * 63).all())
    assert bool((full.tri_tests == 63).all())


def port_scene(which, dev, tmp_path):
    """The alpha scenes of torch_bvh_cases (or the synthetic GLB) built by
    the port on the card."""
    if which == "glb":
        from tools.synth_gltf import write_scene

        path = str(tmp_path / "scene.glb")
        write_scene(path, seed=3, tex=8, subdiv=0, spheres=2)
        return load_gltf(path, device=dev)
    a = tunnel_arrays() if which == "tunnel" else wraps_arrays()
    data, size, wrap, filt = (torch.from_numpy(np.asarray(x)).to(dev)
                              for x in a["atlas"])
    pos = a["positions"]
    return build_scene(pos, np.tile(np.float32([[0, 0, 1]]), (pos.shape[0], 1)),
                       a["tri_vidx"], a["prim_of_tri"],
                       MaterialTable.build(a["records"], dev), a["instances"],
                       uvs=a["uvs"], textures=TextureAtlas(data, size, wrap, filt),
                       device=dev)


def bit_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("tracer", ["bvh", "bvh2"])
@pytest.mark.parametrize("which", ["glb", "tunnel", "wraps"])
def test_fused_alpha_matches_plain(cuda_device, tmp_path, which, tracer):
    from tools.synth_gltf import CAMERA

    scene = port_scene(which, cuda_device, tmp_path)
    cfg = RenderConfig(width=8, height=8, alpha_mask_tracing=True,
                       tracer=tracer, bvh_leaf_size=2)
    accel = (bvh2.build_blas_set(scene, leaf_size=2) if tracer == "bvh2"
             else None)
    ctx = trace.make_tracer(scene, cfg, accel)
    assert ctx.alpha is not None
    o, d, tmax = (torch.from_numpy(x).to(cuda_device) for x in
                  alpha_scene_rays(which, 8192, 1, CAMERA["position"]))
    rays = bvh._rays(o, d, intersect.T_MIN, intersect.T_MAX)
    n = o.shape[0]
    tests = torch.empty((n, 2), dtype=torch.int32, device=cuda_device)
    rounds = ctx.alpha_rounds
    t, tri, u, v, hit = cuda_bvh._launch(ctx.walk, *rays, None, False,
                                         tests=tests, alpha=ctx.alpha,
                                         rounds=rounds)
    plain = bvh.walk_alpha_plain(ctx.walk, ctx.alpha, *rays, rounds,
                                 any_hit=False)
    batch = trace.closest_alpha_rounds(ctx, o, d, intersect.T_MIN,
                                       intersect.T_MAX)
    for want in (plain, batch):
        assert torch.equal(hit, want[4]) and torch.equal(tri, want[1])
        for a, k in ((t, 0), (u, 2), (v, 3)):
            assert bit_equal(a, want[k])
    assert torch.equal(tests, torch.stack([plain.box_tests, plain.tri_tests],
                                          1).to(torch.int32))
    seg = bvh._rays(o, d, intersect.T_MIN, tmax - 1e-3)
    ex = torch.where(torch.arange(n, device=cuda_device) % 2 == 0,
                     torch.where(hit, tri, -1), -1).to(torch.int32)
    for exclude in (None, ex):
        occ = cuda_bvh._launch(ctx.walk, *seg, exclude, True, tests=tests,
                               alpha=ctx.alpha, rounds=rounds)[4]
        want = bvh.walk_alpha_plain(ctx.walk, ctx.alpha, *seg, rounds,
                                    any_hit=True, exclude=exclude)
        assert torch.equal(occ, want.found)
        assert torch.equal(occ, trace.occluded_alpha_rounds(
            ctx, o, d, seg[3], intersect.T_MIN, exclude))
        assert torch.equal(tests, torch.stack([want.box_tests, want.tri_tests],
                                              1).to(torch.int32))
    # The frame's entry points take the fused walk: one launch a query.
    name = cuda_bvh.kernel_name(ctx.walk)
    before = cuda_build.launches[name]
    fused = trace.trace_closest(ctx, o, d)
    trace.trace_occluded(ctx, o, d, tmax, exclude=ex)
    assert cuda_build.launches[name] == before + 2
    assert bit_equal(fused.t, t) and torch.equal(fused.tri, tri)


def test_mixed_devices_raise(cuda_device):
    tris_np = soup(50, seed=1, floor=0)
    tris = tuple(torch.from_numpy(x) for x in tris_np)
    tables = bvh.pack_tables(bvh.build_bvh(tris, 4), tris)
    o = torch.zeros((4, 3), device=cuda_device)
    with pytest.raises(cuda_build.KernelError):
        cuda_bvh.walk_occluded(tables, o, o, o[:, 0], o[:, 0] + 1)
