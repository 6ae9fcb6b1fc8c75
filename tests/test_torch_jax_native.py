"""The port's tests against the JAX package's native SAH builder:
torch_parity.jax_native_lib returns that library for certain.

sunray_tpu.native.get_lib() keeps a failed load as None for the life of
its process (_tried), and under pytest-xdist a worker can load the
library while another worker is still writing it. Each case runs in a
subprocess that stands in for such a worker: _tried set with no library.
The helper must still hand back the library (and build_sah_bvh a BVH),
and with no g++ on the PATH and nothing built it must raise its own named
error, never let a test compare with None."""

import os
import subprocess
import sys

import torch_parity  # noqa: F401  (pins torch's threads)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

FAILED_LOAD = (
    "import sys\n"
    "sys.path.insert(0, {tests!r})\n"
    "import numpy as np\n"
    "import sunray_tpu.native as jn\n"
    "jn._tried, jn._lib = True, None\n"
    "assert jn.get_lib() is None\n"
    "from torch_parity import jax_build_sah, jax_native_lib\n"
    "lib = jax_native_lib({build!r})\n"
    "assert lib is not None and jn.get_lib() is lib\n"
    "g = np.random.default_rng(3)\n"
    "v = [g.random((40, 3), dtype=np.float32) for _ in range(3)]\n"
    "b = jax_build_sah(*v, leaf_size=4)\n"
    "assert b is not None and b.num_leaves > 1, b\n"
    "print('ok', b.num_leaves)\n"
)


def run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_failed_load_still_returns_the_library(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = run(FAILED_LOAD.format(tests=TESTS, build=str(tmp_path)), env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    built = [p.name for p in tmp_path.iterdir()]
    assert len(built) == 1 and built[0].startswith("_sunray_native_"), built


def test_missing_toolchain_fails_with_its_name(tmp_path):
    code = (
        "import sys\n"
        f"sys.path.insert(0, {TESTS!r})\n"
        "import sunray_tpu.native as jn\n"
        "jn._tried, jn._lib = True, None\n"
        "from torch_parity import JaxNativeUnavailable, jax_native_lib\n"
        "try:\n"
        f"    jax_native_lib({str(tmp_path / 'empty')!r})\n"
        "except JaxNativeUnavailable as e:\n"
        "    print('raised', e)\n"
        "else:\n"
        "    raise SystemExit('no error without g++')\n"
    )
    no_gxx = tmp_path / "bin"
    no_gxx.mkdir()
    env = dict(os.environ, PATH=str(no_gxx), JAX_PLATFORMS="cpu")
    out = run(code, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised the JAX package's native SAH "
                                 "builder"), out.stdout
    assert "could not be built" in out.stdout
