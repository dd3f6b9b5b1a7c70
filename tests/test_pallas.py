"""Kernel correctness on the CPU: the Triton tropical kernel in interpret
mode, the segmented fill/reduce and the SpGEMM eq-join bucket against numpy
references."""

import numpy as np
import pytest

import graphblas_tpu as gb  # noqa: F401 — engages x64 etc.


@pytest.mark.parametrize(
    "add,mul",
    [("min", "plus"), ("max", "plus"), ("min", "max"), ("max", "min")],
)
def test_tropical_mxm_vs_oracle(rng, add, mul):
    import jax.numpy as jnp

    from graphblas_tpu.ops.tropical import tropical_mxm

    m, k, n = 48, 72, 33
    av = rng.random((m, k)).astype(np.float32) * 10
    bv = rng.random((k, n)).astype(np.float32) * 10
    as_ = rng.random((m, k)) < 0.4
    bs = rng.random((k, n)) < 0.4
    cv, cs = tropical_mxm(
        jnp.asarray(av), jnp.asarray(as_), jnp.asarray(bv), jnp.asarray(bs), add, mul, np.float32,
        interpret=True,
    )
    fill = np.inf if add == "min" else -np.inf
    af = np.where(as_, av, fill)
    bf = np.where(bs, bv, fill)
    mul_fn = {"plus": np.add, "max": np.maximum, "min": np.minimum}[mul]
    prod = mul_fn(af[:, :, None], bf[None, :, :])
    ref = prod.min(axis=1) if add == "min" else prod.max(axis=1)
    refs = (as_.astype(int) @ bs.astype(int)) > 0
    assert np.array_equal(np.asarray(cs), refs)
    # each candidate is one IEEE op and min/max ignore order: bit-exact
    assert np.array_equal(np.asarray(cv)[refs], ref[refs])


@pytest.mark.parametrize(
    "sr_name,dtype",
    [
        ("plus_times", "FP32"),
        ("min_plus", "FP32"),
        ("max_first", "FP32"),
        ("plus_pair", "FP32"),
        ("lor_pair", "BOOL"),
    ],
)
def test_eqjoin_bucket_vs_numpy(rng, sr_name, dtype):
    """The masked-SpGEMM eq-join bucket (XLA broadcast compare + reduce) vs a
    brute-force numpy intersection per task."""
    import jax.numpy as jnp

    from graphblas_tpu import semiring
    from graphblas_tpu.core.sparse import _eq_bucket

    sr = getattr(semiring, sr_name)[dtype]
    out_np = np.dtype(sr.monoid.type_.np_type)
    W, T, chunk = 16, 512, 128
    ak = rng.integers(0, 40, (W, T)).astype(np.int32)
    bk = rng.integers(0, 40, (W, T)).astype(np.int32)
    # pad slots: missing A keys are -1, missing B keys -2
    ak[rng.random((W, T)) < 0.2] = -1
    bk[rng.random((W, T)) < 0.2] = -2
    av = rng.random((W, T)).astype(out_np)
    bv = rng.random((W, T)).astype(out_np)

    vals, nm = _eq_bucket(
        jnp.asarray(ak), jnp.asarray(av), jnp.asarray(bk), jnp.asarray(bv),
        chunk, sr.binaryop, sr.monoid, out_np,
    )
    vals, nm = np.asarray(vals), np.asarray(nm)
    mul = sr.binaryop.parent.name
    add = sr.monoid.parent.name
    for t in range(0, T, 37):
        eq = ak[:, t][:, None] == bk[:, t][None, :]
        prods = {
            "times": av[:, t][:, None] * bv[:, t][None, :],
            "plus": av[:, t][:, None] + bv[:, t][None, :],
            "first": np.broadcast_to(av[:, t][:, None], (W, W)),
            "pair": np.ones((W, W), out_np),
        }[mul][eq]
        assert nm[t] == eq.sum()
        if eq.sum() == 0:
            continue
        expected = {
            "plus": prods.sum(),
            "min": prods.min(),
            "max": prods.max(),
            "lor": bool(prods.any()),
        }[add]
        np.testing.assert_allclose(vals[t], expected, rtol=1e-5, err_msg=f"{sr_name} t={t}")


def _np_segreduce(x, flags, op):
    """Composed numpy reference (flags[0] set), one segment at a time:
    "fill" gives each slot its segment's first value, add/min/max the
    segment's total."""
    starts = np.flatnonzero(flags)
    ends = np.concatenate([starts[1:], [len(x)]])
    out = np.empty_like(x)
    for s, e in zip(starts, ends):
        part = x[s:e]
        out[s:e] = {"fill": part[0], "add": part.sum(), "min": part.min(), "max": part.max()}[op]
    return out


@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_segmented_reduce_vs_numpy(rng, op):
    import jax.numpy as jnp

    from graphblas_tpu.ops.segscan import segment_ids, segmented_reduce

    for n, density in [(1000, 0.0), (1024, 1.0), (4096, 0.03), (128 * 300, 0.06)]:
        flags = rng.random(n) < density
        flags[0] = True
        seg = segment_ids(flags)
        # integer-valued f32: every order of addition is exact
        x = rng.integers(-50, 50, n).astype(np.float32)
        got = np.asarray(segmented_reduce(jnp.asarray(x), jnp.asarray(seg), op, int(seg[-1]) + 1))
        np.testing.assert_array_equal(got, _np_segreduce(x, flags, op), err_msg=f"n={n} d={density}")


def test_segment_ids():
    from graphblas_tpu.ops.segscan import segment_ids

    flags = np.array([1, 0, 0, 1, 1, 0], bool)
    assert segment_ids(flags).tolist() == [0, 0, 0, 1, 2, 2]
    assert segment_ids(flags).dtype == np.int32
    with pytest.raises(AssertionError):
        segment_ids(np.array([0, 1], bool))


def test_segmented_fill_static_vs_scan(rng):
    """Static-gather segmented fill == numpy for random flags, including
    no-flag, all-flagged and unflagged-prefix inputs (0 before the first
    flag)."""
    import jax.numpy as jnp

    from graphblas_tpu.ops.segscan import build_fill_tables, segmented_fill_static

    for n, density in [(128 * 8, 0.0), (128 * 8, 1.0), (128 * 64, 0.03), (128 * 2048 + 0, 0.06)]:
        flags = rng.random(n) < density
        x = rng.random(n).astype(np.float32)
        j, hp = build_fill_tables(flags)
        assert j.dtype == np.int32 and j.shape == (n,)
        got = np.asarray(segmented_fill_static(jnp.asarray(x), jnp.asarray(j), jnp.asarray(hp)))
        first = int(np.argmax(flags)) if flags.any() else n
        np.testing.assert_array_equal(got[:first], 0)
        if first < n:
            np.testing.assert_array_equal(got[first:], _np_segreduce(x[first:], flags[first:], "fill"))


def test_segmented_scan_state_vs_composed(rng):
    """Fused reduce+state-update == contrib reduce + elementwise epilogue."""
    import jax.numpy as jnp

    from graphblas_tpu.ops.segscan import (
        STATE_BIG,
        segment_ids,
        segmented_reduce_contrib,
        segmented_reduce_state,
    )

    n = 128 * 32
    flags = rng.random(n) < 0.05
    flags[0] = True
    seg = jnp.asarray(segment_ids(flags))
    nseg = int(seg[-1]) + 1
    valid = rng.random(n) < 0.8
    il = np.zeros(n, bool)
    il[np.flatnonzero(flags)[1:] - 1] = True
    il[-1] = True
    x = rng.random(n).astype(np.float32)
    w = rng.random(n).astype(np.float32)

    dist = (rng.random(n) * 2).astype(np.float32)
    ref = np.asarray(
        segmented_reduce_contrib(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(valid), seg, "min", "plus", nseg
        )
    )
    # the contrib reduce itself against numpy
    contrib = np.where(valid, x + w, np.float32(np.inf))
    np.testing.assert_array_equal(ref, _np_segreduce(contrib, flags, "min"))
    # non-last slots carry the min identity (donor slots for the loop network)
    ref_new = np.where(il, np.minimum(dist, ref), STATE_BIG)
    got_new, got_ch = segmented_reduce_state(
        "sssp", jnp.asarray(x), jnp.asarray(w), jnp.asarray(valid), seg, nseg,
        jnp.asarray(il), jnp.asarray(dist), 0,
    )
    np.testing.assert_array_equal(np.asarray(got_new), ref_new)
    np.testing.assert_array_equal(np.asarray(got_ch), (ref_new < dist).astype(np.float32))

    lv = np.where(rng.random(n) < 0.3, 1, -1).astype(np.int32)
    fr = (rng.random(n) < 0.2).astype(np.float32)
    ref = np.asarray(
        segmented_reduce_contrib(
            jnp.asarray(fr), None, jnp.asarray(valid), seg, "max", "first", nseg
        )
    )
    nxt = il & (ref > 0) & (lv < 0)
    got_lv, got_fr = segmented_reduce_state(
        "bfs", jnp.asarray(fr), None, jnp.asarray(valid), seg, nseg,
        jnp.asarray(il), jnp.asarray(lv), 7,
    )
    np.testing.assert_array_equal(np.asarray(got_lv), np.where(nxt, 8, lv))
    np.testing.assert_array_equal(np.asarray(got_fr), nxt.astype(np.float32))


@pytest.mark.parametrize("signed", [True, False])
def test_segmented_reduce_contrib_wrap(rng, signed):
    """wrap=(8, signed): contributions wrap to the output width before a
    min/max reduce, as C integer semirings do."""
    import jax.numpy as jnp

    from graphblas_tpu.ops.segscan import segment_ids, segmented_reduce_contrib

    n = 2048
    flags = rng.random(n) < 0.1
    flags[0] = True
    seg = segment_ids(flags)
    valid = rng.random(n) < 0.9
    x = rng.integers(0, 200, n).astype(np.int32)
    w = rng.integers(0, 200, n).astype(np.int32)
    got = np.asarray(
        segmented_reduce_contrib(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(valid), jnp.asarray(seg),
            "max", "plus", int(seg[-1]) + 1, wrap=(8, signed),
        )
    )
    wrapped = (x + w).astype(np.int8 if signed else np.uint8).astype(np.int32)
    contrib = np.where(valid, wrapped, np.iinfo(np.int32).min)
    np.testing.assert_array_equal(got, _np_segreduce(contrib, flags, "max"))


@pytest.mark.gpu
def test_gpu_kernels_compiled(gpu):
    """On the card: the compiled Triton tropical kernel and the segmented
    reduce against their references (the CPU tests above run the kernel
    interpreted)."""
    import jax.numpy as jnp

    from graphblas_tpu.ops.segscan import segment_ids, segmented_reduce
    from graphblas_tpu.ops.tropical import tropical_mxm_filled

    rng = np.random.default_rng(0)
    a = rng.random((300, 200)).astype(np.float32)
    b = rng.random((200, 260)).astype(np.float32)
    got = np.asarray(tropical_mxm_filled(jnp.asarray(a), jnp.asarray(b), "min", "plus"))
    assert np.array_equal(got, (a[:, :, None] + b[None, :, :]).min(axis=1))
    flags = rng.random(1 << 16) < 0.01
    flags[0] = True
    seg = segment_ids(flags)
    x = rng.integers(-50, 50, 1 << 16).astype(np.float32)
    got = np.asarray(segmented_reduce(jnp.asarray(x), jnp.asarray(seg), "add", int(seg[-1]) + 1))
    np.testing.assert_array_equal(got, _np_segreduce(x, flags, "add"))
