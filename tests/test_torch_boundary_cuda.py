"""PyTorch port on the card, the visibility gradients: B1
(boundary_candidates, csrc/boundary.cu) against its plain version on
every lane (edge indices, live counts, silhouette flags, side-reference
faces) for every K it is built for, on tables of more edges than a
shared-memory tile, with an odd light count and more lights than a
launch takes; and the differentiable
frames with both visibility terms on the card against the CPU. Skipped
where there is no CUDA device; imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_boundary_cuda.py -q
"""

import dataclasses

import pytest
import torch

import chip_smoke
from sunray_tpu_torch.camera import Camera, camera_matrices
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import cuda_boundary, cuda_build
from sunray_tpu_torch.render import boundary, restir
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from sunray_tpu_torch.scene import cornell_box
from sunray_tpu_torch.scene.procedural import _MeshBuilder
from torch_boundary_cases import floating_scene
from torch_parity import CAMERA, cuda_device  # noqa: F401

pytestmark = pytest.mark.gpu


def _tables(scene):
    lights = restir.Lights(scene)
    _, _, table, _, _ = boundary._edge_geometry(
        scene.world_triangle_vertices(), scene.edge_tri, scene.edge_k)
    return table, cuda_boundary.light_table(lights.v0, lights.v1, lights.v2)


@pytest.mark.parametrize("name", ["cornell", "floating"])
@pytest.mark.parametrize("p,k", [(1, 1), (1000, 8), (65537, 16),
                                 (200000, 8)])
def test_candidates_match_plain(cuda_device, name, p, k):
    scene = (cornell_box(device=cuda_device) if name == "cornell"
             else floating_scene(_MeshBuilder).build(device=cuda_device))
    table, lt = _tables(boundary.with_edge_topology(scene))
    g = torch.Generator(device=cuda_device)
    g.manual_seed(p + k)
    xs = torch.rand((p, 3), generator=g, device=cuda_device) * 2.2 - 0.1
    mask = torch.rand((p,), generator=g, device=cuda_device) > 0.1
    got = cuda_boundary.boundary_candidates(xs, mask, table, lt, k)
    want = cuda_boundary.boundary_candidates_plain(xs, mask, table, lt, k)
    torch.cuda.synchronize()
    for a, b, what in zip(got, want, ("idx", "n_live", "sil", "face2")):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), what
    if p >= 1000:       # enough random points for a live candidate
        assert int(got[1].max()) > 0


def _random_points(dev, p, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    xs = torch.rand((p, 3), generator=g, device=dev) * 2.2 - 0.1
    return xs, torch.rand((p,), generator=g, device=dev) > 0.1


def _random_edges(dev, e_n, seed):
    """chip_smoke's random edge table: geometry in and around the box, one
    edge in four open."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return chip_smoke.random_edge_table(g, dev, e_n)


def _assert_plain(got, want):
    for a, b, what in zip(got, want, ("idx", "n_live", "sil", "face2")):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), what


@pytest.mark.parametrize("k", range(1, cuda_boundary.MAX_K + 1))
def test_every_k(cuda_device, k):
    table, lt = _tables(boundary.with_edge_topology(
        cornell_box(device=cuda_device)))
    xs, mask = _random_points(cuda_device, 20011, k)
    cuda_build.launches.clear()
    got = cuda_boundary.boundary_candidates(xs, mask, table, lt, k)
    assert cuda_build.launches["boundary_candidates"] == 1
    want = cuda_boundary.boundary_candidates_plain(xs, mask, table, lt, k)
    torch.cuda.synchronize()
    _assert_plain(got, want)
    assert int(got[1].max()) > 0


@pytest.mark.parametrize("e_n,k", [(cuda_boundary.EDGE_TILE + 1, 16),
                                   (2 * cuda_boundary.EDGE_TILE + 88, 8),
                                   (2 * cuda_boundary.EDGE_TILE + 88, 1)])
def test_tables_above_one_tile(cuda_device, e_n, k):
    _, lt = _tables(boundary.with_edge_topology(
        cornell_box(device=cuda_device)))
    table = _random_edges(cuda_device, e_n, e_n + k)
    xs, mask = _random_points(cuda_device, 30000, k)
    got = cuda_boundary.boundary_candidates(xs, mask, table, lt, k)
    want = cuda_boundary.boundary_candidates_plain(xs, mask, table, lt, k)
    torch.cuda.synchronize()
    _assert_plain(got, want)
    assert int(got[1].max()) > 0


@pytest.mark.parametrize("l_n", [1, 3, cuda_boundary.CONST_LIGHTS + 3])
def test_light_groups_and_launches(cuda_device, l_n):
    """An odd light count (a group of one) and more lights than a launch
    holds (two launches)."""
    table, lt = _tables(boundary.with_edge_topology(
        cornell_box(device=cuda_device)))
    lights = lt[torch.arange(l_n, device=cuda_device) % lt.shape[0]]
    lights = lights + 0.01 * torch.arange(l_n, device=cuda_device)[:, None]
    xs, mask = _random_points(cuda_device, 1003, l_n)
    cuda_build.launches.clear()
    got = cuda_boundary.boundary_candidates(xs, mask, table, lights, 8)
    assert cuda_build.launches["boundary_candidates"] == \
        cuda_boundary.launches_for(l_n)
    want = cuda_boundary.boundary_candidates_plain(xs, mask, table, lights, 8)
    torch.cuda.synchronize()
    _assert_plain(got, want)


def test_candidates_refuse_k_past_the_kernels_bound(cuda_device):
    table, lt = _tables(boundary.with_edge_topology(
        cornell_box(device=cuda_device)))
    xs = torch.ones((4, 3), device=cuda_device)
    mask = torch.ones((4,), dtype=torch.bool, device=cuda_device)
    with pytest.raises(cuda_build.KernelError):
        cuda_boundary.boundary_candidates(xs, mask, table, lt,
                                          cuda_boundary.MAX_K + 1)


def _step(device, **kw):
    cfg = RenderConfig(width=48, height=32, bounces=2, virtual_bounces=2,
                       denoise_passes=0, enable_taa=False,
                       differentiable=True, tonemap="none",
                       shadow_boundary_grads=True, edge_antialias=True, **kw)
    scene = boundary.with_edge_topology(cornell_box(device=device))
    pos = scene.positions.clone().requires_grad_()
    bc = scene.materials.base_color.clone().requires_grad_()
    scene = dataclasses.replace(scene, positions=pos, materials=dataclasses
                                .replace(scene.materials, base_color=bc))
    mats = camera_matrices(Camera(**CAMERA), 48, 32, device=device)
    _, ldr, _ = render_frame(scene, cfg, RenderState.create(cfg, device),
                             mats)
    loss = ldr.mean()
    return loss.detach().cpu(), [g.cpu() for g in
                                 torch.autograd.grad(loss, (bc, pos))]


@pytest.mark.parametrize("kw", [dict(lighting="nee"),
                                dict(lighting="restir",
                                     shadow_boundary_candidates=8)],
                         ids=["nee_dense", "restir_k8"])
def test_frame_with_both_terms_card_vs_cpu(cuda_device, kw):
    cuda_build.launches.clear()
    card = _step(cuda_device, **kw)
    launched = cuda_build.launches["boundary_candidates"]
    cpu = _step("cpu", **kw)
    assert launched == (2 if "shadow_boundary_candidates" in kw else 0)
    torch.testing.assert_close(card[0], cpu[0], rtol=1e-5, atol=0.0)
    for got, want in zip(card[1], cpu[1]):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))
