"""Device placement and process-level settings: the compile cache location
and complex collections staying on the default device."""

import os
import subprocess
import sys

import numpy as np

import graphblas_tpu as gb

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _StubConfig:
    def __init__(self):
        self.updates = {}

    def update(self, key, value):
        self.updates[key] = value


class _StubJax:
    def __init__(self):
        self.config = _StubConfig()


def test_compile_cache_env_set_sets_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    stub = _StubJax()
    gb._configure_compile_cache(stub)
    assert stub.config.updates == {}


def test_compile_cache_env_unset_uses_fixed_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    stub = _StubJax()
    gb._configure_compile_cache(stub)
    path = stub.config.updates["jax_compilation_cache_dir"]
    assert path == gb.COMPILE_CACHE_DIR
    assert os.path.dirname(path) == _REPO and os.path.isdir(path)
    # the same path on every call: no temp name, pid or time in it
    stub2 = _StubJax()
    gb._configure_compile_cache(stub2)
    assert stub2.config.updates["jax_compilation_cache_dir"] == path
    with open(os.path.join(_REPO, ".gitignore")) as fh:
        assert os.path.basename(path) + "/" in fh.read().split()


def test_compile_cache_env_honoured_by_jax(tmp_path):
    """A fresh process with JAX_COMPILATION_CACHE_DIR set caches there."""
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path), JAX_PLATFORMS="cpu")
    code = (
        "import jax, graphblas_tpu as gb; gb._init(automatic=True); "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=_REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert out.stdout.strip().splitlines()[-1] == str(tmp_path)


def test_complex_results_stay_on_default_device():
    import jax

    from graphblas_tpu import Matrix, Vector, binary, dtypes, semiring

    default = jax.devices()[0]
    a = np.array([[1 + 2j, 0], [3 - 1j, 4j]], np.complex128)
    A = Matrix.from_dense(a, missing_value=0, dtype=dtypes.FC64)
    x = Vector.from_dense(np.array([2 - 1j, 1j], np.complex128), dtype=dtypes.FC64)
    y = A.mxv(x, semiring.plus_times).new()
    C = A.ewise_mult(A, binary.times).new()
    for arr in (A._values, y._values, C._values):
        assert arr.devices() == {default}
    np.testing.assert_allclose(y.to_dense(fill_value=0), a @ np.array([2 - 1j, 1j]))
    np.testing.assert_allclose(C.to_dense(fill_value=0), a * a)
