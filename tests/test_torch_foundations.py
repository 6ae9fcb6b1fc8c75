"""PyTorch port, foundations: RNG bit-exactness, camera, blue noise, BRDF
helpers, config, TF32 flags, and that the port never imports JAX."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sunray_tpu import camera as jcam
from sunray_tpu import config as jconfig
from sunray_tpu.ops import brdf as jbrdf
from sunray_tpu.ops import rng as jrng
from sunray_tpu.render import pathtrace as jpath
from sunray_tpu.utils import bluenoise as jnoise
from sunray_tpu_torch import camera as pcam
from sunray_tpu_torch import config as pconfig
from sunray_tpu_torch.ops import brdf as pbrdf
from sunray_tpu_torch.ops import rng as prng
from sunray_tpu_torch.render import pathtrace as ppath
from sunray_tpu_torch.utils import bluenoise as pnoise
from torch_parity import n, t


def _seeds():
    rng = np.random.default_rng(0)
    s = rng.integers(0, 2**32, size=100_000, dtype=np.uint64).astype(np.uint32)
    s[:4] = [0, 0xFFFFFFFF, 1, 0x80000000]
    return s


def _u32(x):
    return np.asarray(x).astype(np.uint32)


def test_rng_bit_exact():
    s = _seeds()
    s_t = torch.from_numpy(s.astype(np.int64))
    np.testing.assert_array_equal(_u32(n(prng.pcg_hash(s_t))),
                                  np.asarray(jrng.pcg_hash(s)))
    for frame in (0, 1, 7, 1023, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            _u32(n(prng.init_seed(s_t, frame))),
            np.asarray(jrng.init_seed(s, np.uint32(frame))))
    ps, pu = prng.rnd(s_t)
    js, ju = jrng.rnd(jnp.asarray(s))
    np.testing.assert_array_equal(_u32(n(ps)), np.asarray(js))
    np.testing.assert_array_equal(n(pu).view(np.uint32),
                                  np.asarray(ju).view(np.uint32))
    ps, p1, p2 = prng.rnd2(ps)
    js, j1, j2 = jrng.rnd2(js)
    np.testing.assert_array_equal(_u32(n(ps)), np.asarray(js))
    for a, b in ((p1, j1), (p2, j2)):
        np.testing.assert_array_equal(n(a).view(np.uint32),
                                      np.asarray(b).view(np.uint32))
    assert 0.0 <= float(pu.min()) and float(pu.max()) <= 1.0


@pytest.mark.parametrize("size", [(96, 64), (64, 48), (331, 17)])
@pytest.mark.parametrize("cam", [
    dict(position=(1.0, 1.0, 3.4), target=(1.0, 1.0, 0.0), fov_y=45.0),
    dict(position=(0.3, 1.7, 3.0), target=(1.2, 0.8, 0.2), fov_y=60.0),
])
def test_camera_matrices_and_rays(size, cam):
    w, h = size
    jm = jcam.camera_matrices(jcam.Camera(**cam), w, h)
    pm = pcam.camera_matrices(pcam.Camera(**cam), w, h)
    for k in ("view_inverse", "proj_inverse", "view_proj"):
        np.testing.assert_allclose(n(pm[k]), np.asarray(jm[k]), atol=1e-6)
    mats = {k: t(v) for k, v in jm.items()}
    jo, jd = jax.jit(lambda m: jcam.generate_rays(m, w, h))(jm)
    po, pd = pcam.generate_rays(mats, w, h)
    assert pd.shape == (h, w, 3)
    np.testing.assert_allclose(n(po), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(n(pd), np.asarray(jd), atol=1e-6)

    pts = np.random.default_rng(1).uniform(-1, 3, size=(500, 3)).astype(np.float32)
    juv, jok = jcam.project_to_prev_uv(jm["view_proj"], pts)
    puv, pok = pcam.project_to_prev_uv(mats["view_proj"], t(pts))
    np.testing.assert_allclose(n(puv), np.asarray(juv), atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(n(pok), np.asarray(jok))


def test_blue_noise_identical():
    np.testing.assert_array_equal(pnoise.noise_texture(), jnoise.noise_texture())
    for w, h in ((96, 64), (200, 7)):
        for a, b in zip(ppath._blue_noise_tiled(w, h),
                        jpath._blue_noise_tiled(w, h)):
            np.testing.assert_array_equal(a, b)
    cfg = pconfig.RenderConfig(width=96, height=64)
    jcfg = jconfig.RenderConfig(width=96, height=64)
    for fc in (0, 3, 1500):
        pr = ppath._blue_noise_rands(cfg, torch.tensor(fc, dtype=torch.int32),
                                     "cpu")
        jr = jpath._blue_noise_rands(jcfg, jnp.int32(fc))
        for a, b in zip(pr, jr):
            np.testing.assert_array_equal(n(a), np.asarray(b))


def _vecs(rng, k=512):
    v = rng.normal(size=(k, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _brdf_cases():
    rng = np.random.default_rng(2)
    a, b = _vecs(rng), _vecs(rng)
    nrm = _vecs(rng)
    r1 = rng.uniform(size=512).astype(np.float32)
    r2 = rng.uniform(size=512).astype(np.float32)
    rough = rng.uniform(0.01, 1.0, size=512).astype(np.float32)
    eta = rng.uniform(0.5, 1.6, size=512).astype(np.float32)
    x = rng.normal(size=512).astype(np.float32) ** 2
    # Views in the normal's hemisphere, as the renderer passes them.
    view = np.where((a * nrm).sum(-1, keepdims=True) < 0.0, -a, a)
    return {
        "dot": ("dot", (a, b)),
        "safe_sqrt": ("safe_sqrt", (x,)),
        "vec_norm": ("vec_norm", (a * 3.0,)),
        "normalize": ("normalize", (a * 3.0,)),
        "cross": (None, (a, b)),
        "reflect": ("reflect", (a, nrm)),
        "refract": ("refract", (a, nrm, eta)),
        "build_onb": ("build_onb", (nrm,)),
        "cosine_hemisphere": ("cosine_hemisphere", (nrm, r1, r2)),
        "sample_ggx_vndf": ("sample_ggx_vndf", (nrm, view, rough, r1, r2)),
        "smith_g1_ggx": ("smith_g1_ggx", (np.abs(r1), rough * rough)),
    }


@pytest.mark.parametrize("name", sorted(_brdf_cases()))
def test_brdf_functions(name):
    fn_name, args = _brdf_cases()[name]
    if fn_name is None:
        want = jnp.cross(*args)
        got = pbrdf.cross(*(t(x) for x in args))
    else:
        want = getattr(jbrdf, fn_name)(*(jnp.asarray(x) for x in args))
        got = getattr(pbrdf, fn_name)(*(t(x) for x in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(n(g), np.asarray(w_), atol=1e-6)
    assert pbrdf.PI == jbrdf.PI and pbrdf.PI_VNDF == jbrdf.PI_VNDF


def test_config_matches_reference():
    assert (dataclasses.asdict(pconfig.RenderConfig())
            == dataclasses.asdict(jconfig.RenderConfig()))
    assert (dataclasses.asdict(pconfig.TEST_CONFIG)
            == dataclasses.asdict(jconfig.TEST_CONFIG))


def test_tf32_off():
    import sunray_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sunray_tpu_torch\n"
        "for m in pkgutil.walk_packages(sunray_tpu_torch.__path__, "
        "'sunray_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules "
        "if k == 'jax' or k.startswith(('jax.', 'sunray_tpu.')) "
        "or k == 'sunray_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules "
        "if k.startswith('sunray_tpu_torch')]))\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
