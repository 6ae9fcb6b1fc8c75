"""PyTorch port on the card, B2 and B3 (csrc/bvh.cu): the unified walk
(LBVH and SAH trees, leaf sizes 1, 4 and 8, one leaf) and the two-level
walk (many instances, one instance) against their plain twin
(ops/bvh.walk_plain) on camera, bounce, grazing and axis-parallel rays:
t, tri, u, v and hit bit-equal, any hit with and without exclude ids
bit-equal, the kernel's test counters equal to the twin's; a mixed-device
call raises. Skipped where there is no CUDA device; imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_bvh_cuda.py -q
"""

import numpy as np
import pytest
import torch

from sunray_tpu_torch.native import build_sah_bvh
from sunray_tpu_torch.ops import bvh, bvh2, cuda_build, cuda_bvh, intersect
from sunray_tpu_torch.scene.types import MaterialTable, build_scene
from torch_bvh_cases import ray_families, soup
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.gpu

FAMILIES = ["camera", "bounce", "grazing", "axis"]


def check_walk(tables, tris_np, dev):
    for family in FAMILIES:
        o, d = (torch.from_numpy(x).to(dev)
                for x in ray_families(tris_np, n=4096, seed=3)[family])
        n = o.shape[0]
        tn = torch.full((n,), intersect.T_MIN, device=dev)
        tx = torch.full((n,), intersect.T_MAX, device=dev)
        tests = torch.empty((n, 2), dtype=torch.int32, device=dev)
        t, tri, u, v, hit = cuda_bvh._launch(tables, o, d, tn, tx, None,
                                             False, tests=tests)
        plain = bvh.walk_plain(tables, o, d, tn, tx, any_hit=False)
        assert torch.equal(hit, plain.found), family
        assert torch.equal(tri, plain.tri), family
        pt = torch.where(plain.found, plain.t, torch.inf)
        for a, b in ((t, pt), (u, plain.u), (v, plain.v)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), family
        assert torch.equal(tests, torch.stack(
            [plain.box_tests, plain.tri_tests], 1).to(torch.int32))
        seg = torch.rand((n,), generator=torch.Generator(dev).manual_seed(1),
                         device=dev) * 6
        ex = torch.where(torch.arange(n, device=dev) % 2 == 0, tri, -1)
        for exclude in (None, ex.contiguous()):
            got = cuda_bvh.walk_occluded(tables, o, d, tn, seg, exclude)
            want = bvh.walk_plain(tables, o, d, tn, seg, any_hit=True,
                                  exclude=exclude).found
            assert torch.equal(got, want), family


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


@pytest.mark.parametrize("n_inst", [1, 9, 40])
def test_b3_matches_plain(cuda_device, n_inst):
    scene = instanced(n_inst, cuda_device)
    tables = bvh2.build_frame_tlas(bvh2.build_blas_set(scene), scene)
    tris_np = tuple(x.cpu().numpy() for x in scene.world_triangle_vertices())
    before = cuda_build.launches["bvh2_walk"]
    check_walk(tables, tris_np, cuda_device)
    assert cuda_build.launches["bvh2_walk"] > before


def test_mixed_devices_raise(cuda_device):
    tris_np = soup(50, seed=1, floor=0)
    tris = tuple(torch.from_numpy(x) for x in tris_np)
    tables = bvh.pack_tables(bvh.build_bvh(tris, 4), tris)
    o = torch.zeros((4, 3), device=cuda_device)
    with pytest.raises(cuda_build.KernelError):
        cuda_bvh.walk_occluded(tables, o, o, o[:, 0], o[:, 0] + 1)
