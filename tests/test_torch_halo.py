"""PyTorch port, parallel/halo.py and the mesh: the halo functions on 8
gloo ranks (tests/torch_dist.py) held bit-equal to the JAX package's
under shard_map on the conftest's 8 virtual devices, from the same
seeded numpy input: exchange_rows with a 10-row halo over 4-row bands
(three hops, zero and edge fill), exchange_flat (and exchange_flat_many
with an int32 field), gather_flat_ext with its valid mask and
shift_flat_ext for every dy in [-halo, halo]; make_grid's asserts;
make_mesh's (dp, sp) and rank placement against JAX's make_mesh for
n = 1..8; generate_rays(row0, rows) bit-equal to the JAX band and to
the port's whole image; and spmd.shard_state of a JAX RenderState
converted by convert.py taking the rows state_specs shards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from sunray_tpu.camera import Camera as JCamera
from sunray_tpu.camera import camera_matrices as jcamera_matrices
from sunray_tpu.camera import generate_rays as jgenerate_rays
from sunray_tpu.parallel import halo as jhalo
from sunray_tpu.config import RenderConfig as JConfig
from sunray_tpu.parallel.sharding import make_mesh as jmake_mesh
from sunray_tpu.parallel.spmd import state_specs
from sunray_tpu.render.pipeline import RenderState as JState
from sunray_tpu_torch import convert
from sunray_tpu_torch.camera import generate_rays
from sunray_tpu_torch.parallel.halo import ShardGrid
from sunray_tpu_torch.parallel.spmd import shard_state
from torch_dist import halo_ops, run_ranks
from torch_parity import CAMERA, n, to_numpy

RANKS = 8
H, W, HL, HALO, FH = 32, 5, 4, 10, 6      # test_spmd.py:186-188; FH 2 hops
SHIFTS = [((-2, 0, 1, 3)[i % 4], dy) for i, dy in enumerate(range(-FH, FH + 1))]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    return dict(
        h=H, w=W, hl=HL, halo=HALO, fh=FH, shifts=SHIFTS,
        img=rng.standard_normal((H, W)).astype(np.float32),
        flat=rng.standard_normal((H * W, 3)).astype(np.float32),
        flat_i=rng.integers(-2**31, 2**31 - 1, (H * W,)).astype(np.int32),
        idx=rng.integers(0, H * W, (H * W,)).astype(np.int32),
    )


@pytest.fixture(scope="module")
def both(case):
    """The port on 8 ranks, and meanwhile the JAX functions."""
    return run_ranks(RANKS, halo_ops, case, meanwhile=lambda: _jax(case))


@pytest.fixture(scope="module")
def port(both):
    return both[0]


@pytest.fixture(scope="module")
def ref(both):
    return both[1]


def _jax(case):
    """The JAX functions under shard_map over 8 virtual devices."""
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]).reshape(RANKS), ("sp",))

    def body(x, f, fi, idx):
        grid = jhalo.ShardGrid(
            axis="sp", nshards=RANKS,
            row0=jax.lax.axis_index("sp").astype(jnp.int32) * HL,
            h=H, w=W, hl=HL, halo_t=HALO, halo_s=HALO)
        ext = jhalo.exchange_flat(f, FH, grid)
        rows, valid = jhalo.gather_flat_ext(ext, idx, FH, grid)
        shifts = jnp.stack([jhalo.shift_flat_ext(ext, dx, dy, FH, grid)
                            for dx, dy in SHIFTS])
        return (jhalo.exchange_rows(x, HALO, HALO, grid, edge="zero"),
                jhalo.exchange_rows(x, HALO, HALO, grid, edge="edge"),
                ext, jhalo.exchange_flat(fi, FH, grid), rows, valid, shifts)

    out = shard_map(
        body, mesh=mesh, in_specs=(P("sp"),) * 4,
        out_specs=(P("sp"),) * 6 + (P(None, "sp"),), check_vma=False,
    )(case["img"], case["flat"], case["flat_i"], case["idx"])
    keys = ("zero", "edge", "flat", "flat_i", "gather", "valid", "shift")
    return {k: np.asarray(v) for k, v in zip(keys, out)}


def _by_rank(port, key):
    return np.concatenate([r[key] for r in port], axis=0)


@pytest.mark.parametrize("edge", ["zero", "edge"])
def test_exchange_rows_matches_jax(port, ref, edge):
    got = _by_rank(port, edge)
    assert got.shape == (RANKS * (HL + 2 * HALO), W)
    np.testing.assert_array_equal(got, ref[edge])


def test_exchange_flat_matches_jax(port, ref):
    np.testing.assert_array_equal(_by_rank(port, "flat"), ref["flat"])
    np.testing.assert_array_equal(_by_rank(port, "flat_many"), ref["flat"])
    np.testing.assert_array_equal(_by_rank(port, "flat_i"), ref["flat_i"])


def test_gather_flat_ext_matches_jax(port, ref):
    valid = _by_rank(port, "valid")
    np.testing.assert_array_equal(valid, ref["valid"])
    assert 0.1 < valid.mean() < 0.9      # both sides of the window taken
    np.testing.assert_array_equal(_by_rank(port, "gather"), ref["gather"])


@pytest.mark.parametrize("k", range(len(SHIFTS)))
def test_shift_flat_ext_matches_jax(port, ref, k):
    got = np.concatenate([r["shift"][k] for r in port], axis=0)
    np.testing.assert_array_equal(got, ref["shift"][k])


def test_make_grid_asserts(port):
    """height 30 over 8 ranks does not divide; height 16 leaves 14 rows
    beyond a band for the 16-row temporal halo (halo.py:61-75)."""
    for r in port:
        not_divisible, too_tall = r["asserts"]
        assert not_divisible == "height 30 not divisible by 8 row shards"
        assert too_tall == (
            "halo (16 rows) exceeds the 14 rows the rest of the mesh holds; "
            "use fewer shards or a taller image")


@pytest.mark.parametrize("devices", range(1, RANKS + 1))
def test_make_mesh_matches_jax(port, devices):
    mesh = jmake_mesh(devices)
    ids = [[d.id for d in row] for row in mesh.devices]
    for rank, r in enumerate(port):
        dp, sp, i, j = r["meshes"][devices - 1]
        assert (dp, sp) == mesh.devices.shape
        if rank < devices:
            assert ids[i][j] == jax.devices()[rank].id
        else:
            assert (i, j) == (None, None)


@pytest.mark.parametrize("row0", [0, 12, 36])
def test_generate_rays_band(row0):
    w, h, rows = 64, 48, 12
    jmats = jcamera_matrices(JCamera(**CAMERA), w, h)
    mats = convert.mats_from_numpy({k: np.asarray(v) for k, v in
                                    jmats.items()}, device="cpu")
    jo, jd = jax.jit(lambda m, r: jgenerate_rays(m, w, h, row0=r, rows=rows))(
        jmats, jnp.int32(row0))
    o, d = generate_rays(mats, w, h, row0=row0, rows=rows)
    whole_o, whole_d = generate_rays(mats, w, h)
    assert d.shape == (rows, w, 3)
    np.testing.assert_array_equal(n(d), np.asarray(jd))
    np.testing.assert_array_equal(n(o), np.asarray(jo))
    assert torch.equal(d, whole_d[row0:row0 + rows])
    assert torch.equal(o, whole_o[row0:row0 + rows])


def test_shard_state_of_a_converted_jax_state():
    kw = dict(width=16, height=12, history_gather_halo=2,
              di_spatial_radius=2.0, gi_spatial_radius=2.0)
    jcfg = JConfig(**kw)
    rng = np.random.default_rng(3)
    jstate = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.uniform(size=x.shape).astype(x.dtype)),
        JState.create(jcfg))
    specs = state_specs(jcfg)
    state = convert.state_from_numpy(to_numpy(jstate), device="cpu")
    grid = ShardGrid(None, 4, 2, 6, 12, 16, 3, 2, 3)
    got = shard_state(state, jcfg, grid)
    sharded = 0
    for (j, spec), p in zip(
            zip(jax.tree_util.tree_leaves(jstate),
                jax.tree_util.tree_leaves(
                    specs, is_leaf=lambda x: isinstance(x, P))),
            _leaves(got), strict=True):
        j = np.asarray(j)
        if spec == P("sp"):
            rows = j.shape[0] // 4
            j = j[2 * rows:3 * rows]
            sharded += 1
        np.testing.assert_array_equal(n(p), j)
    assert sharded == 1 + 8 + 9     # accum and every reservoir field


def _leaves(x):
    import dataclasses

    if torch.is_tensor(x):
        return [x]
    return [leaf for f in dataclasses.fields(x)
            for leaf in _leaves(getattr(x, f.name))]
