"""The kernel engine.

This package replaces the SuiteSparse:GraphBLAS C library (reference layer L0,
SURVEY.md §1): every GraphBLAS operation family implemented over static-shape
device arrays.

- ``densemasked``: the reference semantics engine — (values, structure) dense
  pairs, every op family as jit-compiled jnp code.  This is the differential
  oracle and the fallback path (analogue of the reference's
  "suitesparse-vanilla" backend).
- ``tropical``: the Pallas/Triton kernel for tropical-semiring mxm on the
  GPU.
- ``permute`` / ``fastspmv`` / ``segscan``: the permutation-network SpMV
  (``mxv_strategy="plan"``).
- ``edgewise``: segment-reduce SpMV over padded COO edges.
"""
