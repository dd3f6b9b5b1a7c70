"""chip_smoke.py's phases at small scale on the CPU: the same code paths and
oracles the card runs at full size."""

import os
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import chip_smoke  # noqa: E402


def test_phase_dsl_small():
    chip_smoke.phase_dsl(scale=10, edge_factor=8)


def test_phase_tc_small():
    chip_smoke.phase_tc(scale=10, edge_factor=8)


def test_phase_plan_small():
    chip_smoke.phase_plan(scale=9, edge_factor=8)


def test_phase_kernels_small():
    chip_smoke.phase_kernels(scan_log2=14, mxm_sizes=(64,), interpret=True)


@pytest.mark.parametrize("op", ["fill", "add", "min", "max"])
def test_np_segreduce_reference(op):
    """The vectorized numpy reference agrees with a per-segment loop."""
    rng = np.random.default_rng(3)
    n = 3000
    flags = rng.random(n) < 0.05
    flags[0] = True
    x = rng.random(n).astype(np.float32)
    starts = np.flatnonzero(flags)
    ends = np.concatenate([starts[1:], [n]])
    ref = np.empty(n)
    for s, e in zip(starts, ends):
        part = x[s:e].astype(np.float64)
        ref[s:e] = {"fill": part[0], "add": part.sum(), "min": part.min(), "max": part.max()}[op]
    np.testing.assert_allclose(chip_smoke._np_segreduce(x, flags, op), ref, rtol=1e-12)


def test_oracles_on_a_path_graph():
    src = np.array([0, 1, 2, 4])
    dst = np.array([1, 2, 3, 5])
    w = np.array([1.0, 2.0, 3.0, 1.0], np.float32)
    assert chip_smoke.oracle_bfs(src, dst, 6, 0).tolist() == [0, 1, 2, 3, -1, -1]
    d = chip_smoke.oracle_sssp(src, dst, w, 6, 0)
    assert d[:4].tolist() == [0.0, 1.0, 3.0, 6.0] and np.isinf(d[4:]).all()
    assert chip_smoke.oracle_cc(src, dst, 6).tolist() == [0, 0, 0, 0, 4, 4]
    r = chip_smoke.oracle_pagerank(src, dst, 6)
    assert abs(r.sum() - 1.0) < 1e-12


def test_main_refuses_without_gpu():
    """On the CPU the script exits non-zero and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=_REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
