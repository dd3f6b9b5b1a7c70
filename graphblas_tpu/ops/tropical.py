"""Tropical-family semiring matmul: a Pallas kernel through Triton.

plus_times-family semirings lower to ``jnp.matmul`` (ops/densemasked.
_mxm_fast_path).  The tropical family (min_plus, max_plus, min_max, max_min)
has no tensor-core form: it is arithmetic on the CUDA cores.  XLA's generic
chunked contraction materializes an (m, chunk, n) product block per k chunk
and streams the operands again for every chunk; this kernel keeps a
(BM, BN) running result in registers and walks the whole k extent inside
one program, reusing each loaded operand element BM or BN times.  Programs
are independent (a 2-D grid over output tiles): nothing is carried between
them.

Absence is encoded by value: the add-monoid identity annihilates the multiply
for these (add, mul) pairs (inf + x = inf; inf is the min identity), so the
kernel runs on "filled" value arrays with no separate structure operand —
structure comes from one integer matmul outside the kernel.  Each candidate
``a (x) b`` is one IEEE op and min/max do not depend on order, so the result
is bit-identical to the generic contraction.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

# (add, mul) -> fill value (the add identity, which annihilates mul)
_TROPICAL = {
    ("min", "plus"): np.inf,
    ("max", "plus"): -np.inf,
    ("min", "max"): np.inf,
    ("max", "min"): -np.inf,
}

# (BM, BN, BK, num_warps, num_stages): output tile, k step, Triton launch
# parameters.  Powers of two, as Triton requires.  Swept on an H100 SXM
# (700 W) at 2048^3 and 4096^3 min_plus: the (BK, BM, BN) product block of
# 8K-16K elements (32-128 registers a thread at 4 warps) is the sweet spot;
# 32K-element blocks spill and run 30-50x slower.
_BLOCK = (32, 32, 8, 4, 3)


def is_tropical(add_name, mul_name, np_dtype):
    return (add_name, mul_name) in _TROPICAL and np.issubdtype(np_dtype, np.floating)


def _ops(add_name, mul_name):
    reduce = jnp.min if add_name == "min" else jnp.max
    add = jnp.minimum if add_name == "min" else jnp.maximum
    mul = {"plus": jnp.add, "max": jnp.maximum, "min": jnp.minimum}[mul_name]
    return reduce, add, mul


def _kernel(add_name, mul_name, bk, nk, at_ref, b_ref, o_ref):
    """One (BM, BN) output tile: at_ref is A^T's (K, BM) column block, b_ref
    B's (K, BN) column block; the k loop runs inside the program."""
    import jax.experimental.pallas as pl

    reduce, add, mul = _ops(add_name, mul_name)
    fill = np.float32(_TROPICAL[(add_name, mul_name)])

    def body(kk, acc):
        rows = pl.ds(kk * bk, bk)
        at = at_ref[rows, :]  # (bk, BM)
        b = b_ref[rows, :]  # (bk, BN)
        return add(acc, reduce(mul(at[:, :, None], b[:, None, :]), axis=0))

    acc = jnp.full(o_ref.shape, fill, jnp.float32)
    o_ref[...] = jax.lax.fori_loop(0, nk, body, acc)


@functools.partial(jax.jit, static_argnames=("add_name", "mul_name", "interpret"))
def tropical_mxm_filled(a_filled, b_filled, add_name, mul_name, interpret=False):
    """Tropical matmul on filled (annihilator-encoded) f32 arrays.

    a: (M, K), b: (K, N) — padded internally to tile multiples with the fill
    value, so any shape works.  ``interpret=True`` runs the kernel in the
    Pallas interpreter (tests on the CPU)."""
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import triton as plgpu

    bm, bn, bk, num_warps, num_stages = _BLOCK
    fill = np.float32(_TROPICAL[(add_name, mul_name)])
    m, k = a_filled.shape
    _, n = b_filled.shape
    mp = -(-m // bm) * bm
    np_ = -(-n // bn) * bn
    kp = max(bk, -(-k // bk) * bk)
    at_p = jnp.pad(
        a_filled.astype(jnp.float32).T, ((0, kp - k), (0, mp - m)), constant_values=fill
    )
    b_p = jnp.pad(b_filled.astype(jnp.float32), ((0, kp - k), (0, np_ - n)), constant_values=fill)
    out = pl.pallas_call(
        functools.partial(_kernel, add_name, mul_name, bk, kp // bk),
        grid=(mp // bm, np_ // bn),
        in_specs=[
            pl.BlockSpec((kp, bm), lambda i, j: (0, i)),
            pl.BlockSpec((kp, bn), lambda i, j: (0, j)),
        ],
        out_specs=pl.BlockSpec((bm, bn), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((mp, np_), jnp.float32),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=num_stages),
        interpret=interpret,
        name=f"tropical_{add_name}_{mul_name}",
    )(at_p, b_p)
    return out[:m, :n]


def tropical_mxm(av, as_, bv, bs, add_name, mul_name, out_np_dtype, *, interpret=False):
    """Full tropical semiring mxm on (values, struct) pairs.

    Values go through the kernel on annihilator-filled arrays; structure is
    one int8 -> int32 matmul.
    """
    fill = np.asarray(_TROPICAL[(add_name, mul_name)], np.float32)
    a_filled = jnp.where(as_, av.astype(jnp.float32), fill)
    b_filled = jnp.where(bs, bv.astype(jnp.float32), fill)
    cv = tropical_mxm_filled(a_filled, b_filled, add_name, mul_name, interpret)
    overlap = jnp.matmul(
        as_.astype(jnp.int8), bs.astype(jnp.int8), preferred_element_type=jnp.int32
    )
    cs = overlap > 0
    cv = jnp.where(cs, cv, jnp.zeros((), cv.dtype)).astype(np.dtype(out_np_dtype))
    return cv, cs
