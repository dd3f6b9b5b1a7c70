"""Test harness.

Mirrors the reference harness idea (reference: /root/reference/conftest.py and
graphblas/tests/conftest.py): a randomized-config matrix.  Tests run on the
CPU with a virtual 8-device mesh for the sharding tests, so they need no
accelerator.  Tests marked ``gpu`` take the ``gpu`` fixture, which skips
them unless JAX's first device is a GPU; run them on a card with

    GRAPHBLAS_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import os

# Must be set before jax (or graphblas_tpu) is imported anywhere.
if os.environ.get("GRAPHBLAS_TEST_GPU") != "1":
    os.environ.setdefault("GRAPHBLAS_TPU_PLATFORM", "cpu")
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import random
import time

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# Randomized-config matrix (reference: graphblas/tests/conftest.py:60-150
# randomizes backend x blocking x mapnumpy x record every run).  Every axis is
# drawn from a printed, re-pinnable seed so a default `pytest tests/`
# exercises the matmul/pallas lowerings, blocking mode, and mapnumpy aliasing
# instead of letting those paths rot behind opt-in env vars.
#
# Pin any axis (or reproduce a run) with:
#   GRAPHBLAS_TEST_SEED=<seed>            reproduce a whole run
#   GRAPHBLAS_TEST_MXM_STRATEGY=auto|mxu|generic|pallas
#   GRAPHBLAS_TEST_BLOCKING=0|1
#   GRAPHBLAS_TEST_MAPNUMPY=0|1
#   GRAPHBLAS_TEST_RECORD=0|1
# ---------------------------------------------------------------------------

_seed_env = os.environ.get("GRAPHBLAS_TEST_SEED")
_SEED = int(_seed_env) if _seed_env else int(time.time()) % 100000
_rng = random.Random(_SEED)


def _axis(env, choices, weights):
    val = os.environ.get(env)
    if val is not None and val != "":
        return val
    return _rng.choices(choices, weights=weights)[0]


_AXES = {
    "mxm_strategy": _axis(
        "GRAPHBLAS_TEST_MXM_STRATEGY", ["auto", "generic", "mxu", "pallas"], [5, 2, 2, 2]
    ),
    "blocking": _axis("GRAPHBLAS_TEST_BLOCKING", ["0", "1"], [3, 1]) not in ("0", ""),
    "mapnumpy": _axis("GRAPHBLAS_TEST_MAPNUMPY", ["1", "0"], [3, 1]) not in ("0", ""),
    "record": _axis("GRAPHBLAS_TEST_RECORD", ["0", "1"], [7, 1]) not in ("0", ""),
}
# export the resolved axes so tests that assert config state read the same
# values the harness applied (tests/test_misc.py::test_tx_namespace)
os.environ["GRAPHBLAS_TEST_MXM_STRATEGY"] = _AXES["mxm_strategy"]
os.environ["GRAPHBLAS_TEST_BLOCKING"] = "1" if _AXES["blocking"] else "0"
os.environ["GRAPHBLAS_TEST_MAPNUMPY"] = "1" if _AXES["mapnumpy"] else "0"
os.environ["GRAPHBLAS_TEST_RECORD"] = "1" if _AXES["record"] else "0"


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False, help="run slow tests")
    parser.addoption("--record", action="store_true", default=False, help="record engine calls")


def pytest_report_header(config):
    return (
        f"graphblas_tpu config matrix: seed={_SEED} "
        f"mxm_strategy={_AXES['mxm_strategy']} blocking={_AXES['blocking']} "
        f"mapnumpy={_AXES['mapnumpy']} record={_AXES['record']} "
        "(pin with GRAPHBLAS_TEST_SEED / GRAPHBLAS_TEST_* env vars)"
    )


def pytest_configure(config):
    import graphblas_tpu
    from graphblas_tpu.tx import config as txconfig

    if _AXES["mxm_strategy"] != "auto":
        txconfig["mxm_strategy"] = _AXES["mxm_strategy"]
    if _AXES["blocking"]:
        graphblas_tpu.init("jax", blocking=True)
    graphblas_tpu.config["mapnumpy"] = _AXES["mapnumpy"]
    if config.getoption("--record", default=False) or _AXES["record"]:
        # reference --record: wrap the run in a Recorder and dump every
        # engine call to record.txt (graphblas/tests/conftest.py:111-120)
        config._gb_recorder = graphblas_tpu.Recorder(start=True, max_rows=1 << 20)


def pytest_unconfigure(config):
    rec = getattr(config, "_gb_recorder", None)
    if rec is not None:
        rec.stop()
        if config.getoption("--record", default=False):
            with open("record.txt", "w") as f:
                f.write("\n".join(rec.data) + "\n")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="need --runslow option to run")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture(scope="session")
def rng():
    seed = int(os.environ.get("GRAPHBLAS_TEST_SEED", "42"))
    return np.random.default_rng(seed)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time, never at
    collection, so every xdist worker collects the same tests)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture
def gb():
    import graphblas_tpu

    return graphblas_tpu
