"""PyTorch port on the card, the differentiable slice: K8's backward kernel
(gather_rows_bwd) against its plain version (index_add_), deterministic,
at 1 and 512 rows, and its runs path above 512 rows (the hand radix
sort's permutation against torch.sort's, the sums bit-equal to their
plain model at the 720p step's shapes, strided cotangents included), on slices that cross block and group boundaries, N
not a multiple of a lane's 4 indices (and a cotangent off 16 bytes: one
index a lane), warps of more than 4 rows, tables wider than a pass;
the K7 and K9 autograd Functions (kernel forward, plain VJP backward);
and the differentiable ReSTIR frame on the card against the CPU. Skipped
where there is no CUDA device; imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_grads_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from sunray_tpu_torch.camera import Camera, camera_matrices
from sunray_tpu_torch.config import RenderConfig
from sunray_tpu_torch.ops import cuda_build, cuda_gather, cuda_image
from sunray_tpu_torch.render.pipeline import RenderState, render_frame
from sunray_tpu_torch.scene import cornell_box
from torch_parity import CAMERA, GOLDEN_KW, cuda_device, n  # noqa: F401

pytestmark = pytest.mark.gpu

# The plain K3-K7, K9 and K13: a differentiable frame launches none of them.
FORWARD_ONLY = ("ris_audition", "di_temporal", "di_spatial", "gi_spatial",
                "atrous_pass", "taa_clamp_blend", "history_gather")


def _bwd_case(k, c, g, nidx, dev, seed=0):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(-5, k + 5, size=(g, nidx))
                           .astype(np.int32)).to(dev)
    ct = torch.from_numpy(rng.standard_normal((g, c, nidx))
                          .astype(np.float32)).to(dev)
    return ct, idx


@pytest.mark.parametrize("k,c,g", [(72, 6, 3), (36, 4, 1), (300, 11, 2),
                                   (512, 6, 3)])
def test_gather_backward_kernel_matches_plain(k, c, g, cuda_device):
    """Within 1e-6 of each row's sum of |ct| of index_add_ (another order
    of the same float32 sums); two runs bit-equal."""
    ct, idx = _bwd_case(k, c, g, 200_003, cuda_device, seed=k)
    cuda_build.launches.clear()
    got = cuda_gather.gather_rows_bwd(ct, idx, k)
    again = cuda_gather.gather_rows_bwd(ct, idx, k)
    want = cuda_gather.gather_rows_bwd_plain(ct, idx, k)
    scale = cuda_gather.gather_rows_bwd_plain(ct.abs(), idx, k)
    torch.cuda.synchronize()
    assert cuda_build.launches["gather_rows_bwd"] == 2
    assert torch.equal(got, again)
    assert bool(((got - want).abs() <= 1e-6 * scale).all())


def _held(ct, idx, k):
    """gather_rows_bwd within 1e-6 of each row's sum of |ct| of the
    float64 sums, and two runs bit-equal."""
    got = cuda_gather.gather_rows_bwd(ct, idx, k)
    again = cuda_gather.gather_rows_bwd(ct, idx, k)
    want = cuda_gather.gather_rows_bwd_plain(ct.double(), idx, k)
    scale = cuda_gather.gather_rows_bwd_plain(ct.abs().double(), idx, k)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert bool(((got.double() - want).abs() <= 1e-6 * scale + 1e-30).all())
    return got


@pytest.mark.parametrize("k,c,g,nidx", [
    (1, 6, 3, 100_000),          # one row: every lane's run the same
    (512, 6, 3, 200_004),        # the largest table
    (512, 16, 1, 65_536),        # the largest table a pass holds
    (40, 20, 2, 30_004),         # two passes of columns
    (72, 6, 3, 921_600),         # the 720p corners' shape
    (4, 12, 1, 921_601),         # N not a multiple of 4: one index a lane
    (72, 9, 1, 1_000),           # one block
    (64, 21, 1, 921_600),        # the real step's instance rows: 48 KB of
                                 # dynamic shared memory and the static flag
])
def test_gather_backward_shapes(k, c, g, nidx, cuda_device):
    ct, idx = _bwd_case(k, c, g, nidx, cuda_device, seed=k + c)
    shape = cuda_gather.bwd_launch_shape(g * nidx, k, c,
                                         cuda_gather._sm_count(cuda_device))
    assert shape["blocks"] * shape["warps"] * shape["warp_chunk"] >= g * nidx
    assert cuda_gather.bwd_vec(ct, idx) == (4 if nidx % 4 == 0 else 1)
    _held(ct, idx, k)


def test_gather_backward_coherent_runs(cuda_device):
    """Runs of one row that cross lanes, warps, blocks and groups (camera-
    coherent indices: a row every 997 indices), with some rows changing
    inside a lane's 4 indices; and random rows (warps of more than 4
    rows); each bit-equal across runs, within 1e-6 of the float64 sums."""
    n = 3 * 640_000
    ramp = torch.arange(n, device=cuda_device, dtype=torch.int32)
    idx = (ramp // 997 % 72).reshape(3, -1).contiguous()
    ct = torch.randn((3, 6, n // 3), device=cuda_device)
    _held(ct, idx, 72)
    rand = torch.randint(-3, 75, (3, n // 3), device=cuda_device,
                         dtype=torch.int32)
    _held(ct, rand, 72)


def test_gather_backward_unaligned_cotangent(cuda_device):
    """A cotangent 4 bytes off 16: loads a word at a time, the same
    indices a lane, the same bits."""
    ct, idx = _bwd_case(72, 6, 3, 50_000, cuda_device, seed=5)
    off = torch.empty(ct.numel() + 1, device=cuda_device)[1:].view_as(ct)
    off.copy_(ct)
    assert cuda_gather.bwd_vec(off, idx) == 1
    assert cuda_gather.bwd_vec(ct, idx) == 4
    got = _held(off, idx, 72)
    want = _held(ct, idx, 72)
    assert torch.equal(got, want)


def test_gather_backward_kernel_edges(cuda_device):
    """No index at all gives zeros, in the shared-memory kernel and in the
    runs path above MAX_ROWS rows (which now takes those tables); a wrong
    dtype raises in both."""
    ct, idx = _bwd_case(72, 6, 3, 0, cuda_device)
    assert not cuda_gather.gather_rows_bwd(ct, idx, 72).any()
    big = cuda_gather.MAX_ROWS + 1
    empty = cuda_gather.gather_rows_bwd(ct, idx, big)
    assert empty.shape == (big, 6) and not empty.any()
    ct, idx = _bwd_case(600, 6, 1, 1000, cuda_device)
    cuda_build.launches.clear()
    _held(ct, idx, big)
    assert cuda_build.launches["gather_rows_bwd_runs"] == 2
    assert cuda_build.launches["gather_rows_bwd"] == 0
    for k in (72, big):
        with pytest.raises(cuda_build.KernelError):
            cuda_gather.gather_rows_bwd(ct, idx.long(), k)


def _runs_case(k, c, g, nidx, dup, dev, seed):
    """Heavy duplicates: four in five indices on six rows (two clamped),
    runs far above a block's 256 threads; rare: uniform over the rows."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-5, k + 5, size=(g, nidx))
    if dup == "heavy":
        hot = np.asarray([-2, 0, 7, k // 2, k - 1, k + 3])
        idx = np.where(rng.random((g, nidx)) < 0.8,
                       hot[rng.integers(0, 6, (g, nidx))], idx)
    ct = rng.standard_normal((g, c, nidx)).astype(np.float32)
    return (torch.from_numpy(ct).to(dev),
            torch.from_numpy(idx.astype(np.int32)).to(dev))


@pytest.mark.parametrize("dup", ["heavy", "rare"])
@pytest.mark.parametrize("k,c,g,nidx", [
    (513, 4, 1, 100_003), (3518, 20, 3, 921_600), (70_001, 9, 5, 50_000),
    (256_068, 9, 1, 921_600), (8_388_608, 4, 5, 921_600),
    (2698, 20, 3, 921_600), (262_144, 9, 1, 921_600)])
def test_gather_backward_runs_matches_model(k, c, g, nidx, dup, cuda_device):
    """The runs path (K > MAX_ROWS) bit-equal to its plain model of the
    kernels' order (gather_rows_bwd_runs_model) on the CPU, within 1e-6
    of a row's sum of |ct| of the float64 sums, two runs bit-equal; the
    shapes of the 720p step's corner (2,698 x 20), edge-AA (262,144 x 9)
    and texel (8,388,608 x 4) calls."""
    ct, idx = _runs_case(k, c, g, nidx, dup, cuda_device, seed=k + c)
    cuda_build.launches.clear()
    got = _held(ct, idx, k)
    assert cuda_build.launches["gather_rows_bwd_runs"] == 2
    want = cuda_gather.gather_rows_bwd_runs_model(ct.cpu(), idx.cpu(), k)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_gather_backward_runs_reads_strides(cuda_device):
    """A (G, N, C) cotangent viewed as (G, C, N) (the texel call's layout)
    gives the bits of its contiguous copy and of the model."""
    ct, idx = _runs_case(5000, 4, 5, 60_001, "heavy", cuda_device, seed=9)
    view = ct.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    assert not view.is_contiguous()
    got = cuda_gather.gather_rows_bwd(view, idx, 5000)
    assert torch.equal(got, cuda_gather.gather_rows_bwd(ct, idx, 5000))
    want = cuda_gather.gather_rows_bwd_runs_model(ct.cpu(), idx.cpu(), 5000)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k,c,layout", [(2698, 20, "corners"),
                                        (262_144, 9, "columns"),
                                        (8_388_608, 4, "rows")])
def test_gather_backward_runs_strided_step_shapes(k, c, layout, cuda_device):
    """At the step's three shapes through a strided cotangent: a (G, C, N)
    slice of a wider one ("corners", "columns": column stride N + 7) or a
    (G, N, C) one viewed as (G, C, N) ("rows"); bit-equal to the model."""
    g = 5 if layout == "rows" else (3 if layout == "corners" else 1)
    ct, idx = _runs_case(k, c, g, 921_600, "heavy", cuda_device, seed=c)
    if layout == "rows":
        view = ct.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    else:
        wide = torch.zeros((g, c, 921_600 + 7), device=cuda_device)
        wide[:, :, 3:921_603] = ct
        view = wide[:, :, 3:921_603]
    assert not view.is_contiguous()
    got = cuda_gather.gather_rows_bwd(view, idx, k)
    want = cuda_gather.gather_rows_bwd_runs_model(ct.cpu(), idx.cpu(), k)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def _sort_case(k, pattern, g, nidx, dev, seed):
    """Row ids for the sort: "uniform" over [-5, K + 5) (clamped at both
    ends), "heavy" four in five on six rows, "equal" one row, "ends" only
    out-of-range ids, "none" no index."""
    rng = np.random.default_rng(seed)
    hi = min(k + 5, 2 ** 31)
    idx = rng.integers(-5, hi, size=(g, nidx), dtype=np.int64)
    if pattern == "heavy":
        hot = np.asarray([-2, 0, 7, k // 2, k - 1, hi - 1])
        idx = np.where(rng.random((g, nidx)) < 0.8,
                       hot[rng.integers(0, 6, (g, nidx))], idx)
    elif pattern == "equal":
        idx = np.full((g, nidx), k // 3)
    elif pattern == "ends":
        idx = np.where(rng.random((g, nidx)) < 0.5, -1, hi - 1)
    elif pattern == "none":
        idx = idx[:, :0]
    return torch.from_numpy(idx.astype(np.int32)).to(dev)


@pytest.mark.parametrize("pattern", ["uniform", "heavy", "equal", "ends",
                                     "none"])
@pytest.mark.parametrize("k", [513, 2698, 262_144, 8_388_608, 2 ** 31 - 1])
def test_runs_sort_is_torch_sort(k, pattern, cuda_device):
    """The hand radix sort's keys and permutation equal torch.sort
    (stable=True)'s of the clamped ids, at the texel call's 5 x 921,600
    indices (one tile and a bit for "none")."""
    idx = _sort_case(k, pattern, 5, 921_600, cuda_device, seed=k % 997)
    keys, pos = cuda_gather.runs_sort(idx, k)
    want_keys, want_pos = torch.sort(idx.reshape(-1).long().clamp(0, k - 1),
                                     stable=True)
    assert keys.dtype == pos.dtype == torch.int32
    assert torch.equal(keys.long(), want_keys)
    assert torch.equal(pos.long(), want_pos)


@pytest.mark.parametrize("nidx", [1, 31, 4096, 4097, 100_003])
def test_runs_sort_small(nidx, cuda_device):
    """A partial tile, one tile, one key past it: the permutation of the
    model and of torch.sort."""
    idx = _sort_case(2698, "heavy", 1, nidx, cuda_device, seed=nidx)
    keys, pos = cuda_gather.runs_sort(idx, 2698)
    want_keys, want_pos = cuda_gather.runs_sort_model(idx.cpu(), 2698)
    assert torch.equal(keys.cpu().long(), want_keys)
    assert torch.equal(pos.cpu().long(), want_pos)


def test_texel_gradient_card_matches_cpu(cuda_device):
    """sample_texture's gradient w.r.t. a 2 x 64 x 64 atlas (8,192 texel
    rows): the runs path on the card, index_add_ on the CPU, within 1e-6
    of the largest entry; the forward bit-equal."""
    from sunray_tpu_torch.ops import texture
    from sunray_tpu_torch.scene.types import TextureAtlas

    g = torch.Generator().manual_seed(0)
    data = torch.rand((2, 64, 64, 4), generator=g)
    atlas = TextureAtlas(data=data, size=torch.tensor([[64, 64], [40, 24]],
                                                      dtype=torch.int32),
                         wrap=torch.tensor([[0, 0], [1, 2]], dtype=torch.int32),
                         filt=torch.tensor([1, 0], dtype=torch.int32))
    lanes = 300_000
    tex = torch.randint(-1, 2, (lanes,), generator=g, dtype=torch.int32)
    uv = torch.rand((lanes, 2), generator=g) * 3.0 - 1.0
    fb = torch.rand((lanes, 4), generator=g)
    w = torch.randn((lanes, 4), generator=g)
    out = {}
    for dev in ("cpu", cuda_device):
        leaf = data.to(dev).requires_grad_()
        at = dataclasses.replace(atlas.to(dev), data=leaf)
        cuda_build.launches.clear()
        val = texture.sample_texture(at, tex.to(dev), uv.to(dev), fb.to(dev))
        grad, = torch.autograd.grad(val, leaf, w.to(dev))
        out[str(dev)] = (val.detach().cpu(), grad.cpu())
    assert cuda_build.launches["gather_rows_bwd_runs"] == 1
    (vc, gc), (vg, gg) = out.values()
    assert torch.equal(vc, vg)
    assert torch.allclose(gg, gc, rtol=0, atol=1e-6 * float(gc.abs().max()))


def test_gather_function_runs_both_kernels(cuda_device):
    """A table that requires grad: K8 forward, gather_rows_bwd backward,
    the gradient the plain version's."""
    ct, idx = _bwd_case(72, 6, 3, 50_001, cuda_device, seed=3)
    table = torch.randn((72, 6), device=cuda_device, requires_grad=True)
    cuda_build.launches.clear()
    out = cuda_gather.gather_rows(table, idx)
    grad, = torch.autograd.grad(out, table, ct)
    assert cuda_build.launches["gather_rows_multi"] == 1
    assert cuda_build.launches["gather_rows_bwd"] == 1
    want = cuda_gather.gather_rows_bwd_plain(ct, idx, 72)
    scale = cuda_gather.gather_rows_bwd_plain(ct.abs(), idx, 72)
    assert bool(((grad - want).abs() <= 1e-6 * scale).all())


def _guides(dev, h=96, w=128, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    color = torch.rand((h, w, 3), generator=g) * 2.0
    depth = 1.0 + 3.0 * torch.rand((h, w), generator=g)
    depth[: h // 8] = 100000.0
    normal = torch.nn.functional.normalize(
        torch.tensor([0.0, 0.3, 1.0]) + 0.05 * torch.randn((h, w, 3),
                                                           generator=g),
        dim=-1)
    rough = torch.rand((h, w), generator=g)
    diffuse = torch.rand((h, w, 3), generator=g)
    return [x.contiguous().to(dev) for x in (color, depth, normal, rough,
                                             diffuse)]


def _vjp(fn, inputs, ct):
    xs = [x.detach().clone().requires_grad_(x.dtype.is_floating_point)
          for x in inputs]
    out = fn(*xs)
    want = [x for x in xs if x.requires_grad]
    return out, torch.autograd.grad(out, want, ct, allow_unused=True)


def _close(got, want, floor):
    for g, w in zip(got, want):
        if w is None:
            assert g is None or not g.any()
            continue
        atol = floor * float(w.abs().max())
        assert torch.allclose(g, w, rtol=1e-4, atol=atol)


def test_atrous_function_on_card(cuda_device):
    """K7 forward (one launch a pass) within 1e-5 of the plain passes; the
    backward is the plain passes' VJP, within rtol 1e-4 and a floor of
    1e-3 of the largest entry (the diffuse gradient is a cancellation,
    test_torch_grads_vjp.py)."""
    guides = _guides(cuda_device)
    ct = torch.randn_like(guides[0])
    cuda_build.launches.clear()
    out, got = _vjp(lambda *g: cuda_image.atrous_denoise(*g, 3), guides, ct)
    assert cuda_build.launches["atrous_pass"] == 3
    want_out, want = _vjp(lambda *g: cuda_image.atrous_denoise_plain(*g, 3),
                          guides, ct)
    assert torch.allclose(out, want_out, atol=1e-5)
    _close(got, want, floor=1e-3)


def test_taa_function_on_card(cuda_device):
    g = torch.Generator(device="cpu").manual_seed(1)
    raw = (torch.rand((96, 128, 3), generator=g) * 3.0).to(cuda_device)
    hist = (torch.rand((96, 128, 3), generator=g) * 3.0).to(cuda_device)
    use = (torch.rand((96, 128), generator=g) > 0.3).to(cuda_device)
    ct = torch.randn_like(raw)
    cuda_build.launches.clear()
    out, got = _vjp(lambda r, h: cuda_image.taa_clamp_blend(r, h, use, 0.14),
                    (raw, hist), ct)
    assert cuda_build.launches["taa_clamp_blend"] == 1
    want_out, want = _vjp(
        lambda r, h: cuda_image.taa_clamp_blend_plain(r, h, use, 0.14),
        (raw, hist), ct)
    assert torch.allclose(out, want_out, atol=1e-6)
    _close(got, want, floor=1e-6)


def diff_steps(dev, steps, **kw):
    """`steps` differentiable frames at the golden size with the state
    threaded through: [(loss, grad base_color, grad positions)]."""
    cfg = RenderConfig(**dict(GOLDEN_KW, lighting="restir",
                              differentiable=True, **kw))
    scene = cornell_box(device=dev)
    bc = scene.materials.base_color.clone().requires_grad_()
    pos = scene.positions.clone().requires_grad_()
    scene = dataclasses.replace(
        scene, positions=pos,
        materials=dataclasses.replace(scene.materials, base_color=bc))
    mats = camera_matrices(Camera(**CAMERA), cfg.width, cfg.height,
                           device=dev)
    state = RenderState.create(cfg, dev)
    out = []
    for _ in range(steps):
        state, ldr, _ = render_frame(scene, cfg, state, mats)
        loss = ldr.mean()
        gb, gp = torch.autograd.grad(loss, (bc, pos))
        out.append((n(loss), n(gb), n(gp)))
    return out


def test_differentiable_frame_card_matches_cpu(cuda_device):
    """Three differentiable ReSTIR frames at the golden size: losses within
    1e-5 relative, gradients within rtol 1e-4 and a floor of 1e-5 of the
    largest entry, the positions gradient nonzero on the card (the corner
    gather's backward kernel ran); the forward-only kernels never launch."""
    cpu = diff_steps("cpu", 3)
    cuda_build.launches.clear()
    card = diff_steps(cuda_device, 3)
    for name in ("trace_closest", "trace_occluded", "gather_rows",
                 "gather_rows_multi", "gather_rows_bwd"):
        assert cuda_build.launches[name] > 0, name
    for name in FORWARD_ONLY:
        assert cuda_build.launches[name] == 0, name
    for (lc, bc_c, pc), (lg, bc_g, pg) in zip(cpu, card):
        np.testing.assert_allclose(lg, lc, rtol=1e-5)
        for got, want in ((bc_g, bc_c), (pg, pc)):
            np.testing.assert_allclose(
                got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
        assert np.abs(pg).max() > 0.0
