"""PyTorch port, ops/packing.py: every pack and unpack bit-equal to the
jitted JAX functions (sunray_tpu/ops/packing.py) on seeded values, the
cases of tests/test_rng_packing.py::TestPacking, signed zeros, +-1,
half-way ties of each quantization, values out of range, infinities and
NaNs, and words with the top bit set. Words are int32 in the port and
compared as uint32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch's threads)
from sunray_tpu.ops import packing as jpk
from sunray_tpu_torch.ops import packing as pk

GEN = np.random.default_rng(18)
SPECIALS = np.array(
    [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 1e-8, -1e-8, 1e5, -1e5,
     np.inf, -np.inf, np.nan,
     # half-way ties of snorm16 (k + 1/2) / 32767 and unorm8 (k + 1/2) / 255
     0.5 / 32767, 1.5 / 32767, 2.5 / 32767, -0.5 / 32767, -1.5 / 32767,
     32766.5 / 32767, 0.5 / 255, 1.5 / 255, 2.5 / 255, 254.5 / 255,
     # float16: largest finite, rounds to inf, subnormals, a tie
     65504.0, 65520.0, 6e-5, 6e-8, 2.0 ** -25, 1.0 + 2.0 ** -11],
    np.float32)
WORDS = np.concatenate([
    GEN.integers(0, 2 ** 32, 100_000, dtype=np.uint64).astype(np.uint32),
    np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x80008000, 0x00008000,
              0x80000001, 0x7FFF8001, 0x3C003C00, 0x7C00FC00, 0xFC017E01,
              0xFE00FC00, 0x00010001, 0x03FF8400, 0xFF0000FF], np.uint32)])


def values(c):
    """Seeded values in [-2, 2) with every combination of SPECIALS in the
    first two channels (the rest random)."""
    rand = GEN.uniform(-2.0, 2.0, (50_000, c)).astype(np.float32)
    a, b = np.meshgrid(SPECIALS, SPECIALS, indexing="ij")
    combo = GEN.uniform(-2.0, 2.0, (a.size, c)).astype(np.float32)
    combo[:, 0], combo[:, 1] = a.ravel(), b.ravel()
    return np.concatenate([rand, combo])


def words(x):
    return x.numpy().view(np.uint32)


def bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("name,c", [("snorm_2x16", 2), ("unorm_4x8", 4),
                                    ("half_2x16", 2)])
def test_pack_bit_equal(name, c):
    v = values(c)
    want = np.asarray(jax.jit(getattr(jpk, f"pack_{name}"))(jnp.asarray(v)))
    got = words(getattr(pk, f"pack_{name}")(torch.from_numpy(v)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["snorm_2x16", "unorm_4x8", "half_2x16"])
def test_unpack_bit_equal(name):
    want = np.asarray(jax.jit(getattr(jpk, f"unpack_{name}"))(
        jnp.asarray(WORDS)))
    got = getattr(pk, f"unpack_{name}")(torch.from_numpy(WORDS.view(np.int32)))
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def test_pack_eager_jax_equal():
    """The packs also equal eager JAX (only the unpacks' divisions are
    folded into reciprocal products under jit)."""
    v = values(4)
    for name, c in (("snorm_2x16", 2), ("unorm_4x8", 4), ("half_2x16", 2)):
        want = np.asarray(getattr(jpk, f"pack_{name}")(jnp.asarray(v[:, :c])))
        got = words(getattr(pk, f"pack_{name}")(torch.from_numpy(v[:, :c])))
        np.testing.assert_array_equal(got, want, err_msg=name)


def unit_normals():
    n = GEN.normal(size=(100_000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    axes = np.eye(3, dtype=np.float32)
    diag = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1],
                     [1, 0, -1], [0, -1, -1]], np.float32)
    diag /= np.linalg.norm(diag, axis=-1, keepdims=True)
    signed_zero = np.array([[-0.0, -0.0, 1.0], [0.0, -0.0, -1.0],
                            [-0.0, 1.0, -0.0]], np.float32)
    return np.concatenate([n, axes, -axes, diag, signed_zero])


def test_normal_bit_equal():
    n = unit_normals()
    want = np.asarray(jax.jit(jpk.pack_normal)(jnp.asarray(n)))
    got = words(pk.pack_normal(torch.from_numpy(n)))
    np.testing.assert_array_equal(got, want)
    # every packed word a normal can give, and random words
    w = np.concatenate([want, WORDS])
    back = np.asarray(jax.jit(jpk.unpack_normal)(jnp.asarray(w)))
    got = pk.unpack_normal(torch.from_numpy(w.view(np.int32))).numpy()
    np.testing.assert_array_equal(bits(got), bits(back))


# tests/test_rng_packing.py::TestPacking, on the port.

def test_unorm4x8_roundtrip():
    v = np.random.default_rng(0).uniform(0, 1, (64, 4)).astype(np.float32)
    out = pk.unpack_unorm_4x8(pk.pack_unorm_4x8(torch.from_numpy(v))).numpy()
    np.testing.assert_allclose(out, v, atol=1.0 / 255.0 / 2 + 1e-6)


def test_unorm4x8_bit_layout():
    p = pk.pack_unorm_4x8(torch.tensor([[1.0, 0.0, 0.0, 1.0]]))
    assert words(p)[0] == np.uint32(0xFF0000FF)


def test_snorm2x16_roundtrip():
    v = np.random.default_rng(1).uniform(-1, 1, (64, 2)).astype(np.float32)
    out = pk.unpack_snorm_2x16(pk.pack_snorm_2x16(torch.from_numpy(v))).numpy()
    np.testing.assert_allclose(out, v, atol=1.0 / 32767.0)


def test_half2x16_roundtrip():
    v = np.array([[0.5, 2.25], [1.0, 0.0], [0.1, 100.0]], np.float32)
    out = pk.unpack_half_2x16(pk.pack_half_2x16(torch.from_numpy(v))).numpy()
    np.testing.assert_allclose(out, v.astype(np.float16).astype(np.float32))


def test_half2x16_bit_layout():
    p = pk.pack_half_2x16(torch.tensor([[1.0, 1.0]]))
    assert words(p)[0] == np.uint32(0x3C003C00)


def test_octahedral_normal_roundtrip():
    g = np.random.default_rng(2)
    n = g.normal(size=(256, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    out = pk.unpack_normal(pk.pack_normal(torch.from_numpy(n))).numpy()
    assert np.sum(out * n, axis=-1).min() > 0.99999


def test_octahedral_axes():
    axes = np.concatenate([np.eye(3, dtype=np.float32),
                           -np.eye(3, dtype=np.float32)])
    out = pk.unpack_normal(pk.pack_normal(torch.from_numpy(axes))).numpy()
    np.testing.assert_allclose(out, axes, atol=1e-4)


def test_top_bit_words_unpack_unsigned():
    """A word with its top bit set unpacks its high half unsigned where the
    format is unsigned (a signed >> would smear the bit)."""
    w = torch.from_numpy(np.array([0xFF000000, 0xBC000000], np.uint32)
                         .view(np.int32))
    np.testing.assert_array_equal(
        pk.unpack_unorm_4x8(w).numpy()[:, 3],
        np.float32([255, 188]) * np.float32(1.0 / 255.0))
    half = pk.unpack_half_2x16(w).numpy()[:, 1]
    np.testing.assert_array_equal(
        half, np.array([0xFF00, 0xBC00], np.uint16).view(np.float16)
        .astype(np.float32))
