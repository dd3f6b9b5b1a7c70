"""Descriptor: the per-call option bundle.

The reference maps 5 bool flags onto 32 pre-built C descriptor objects
(/root/reference/graphblas/core/descriptor.py:51-89) and routes SuiteSparse
extras (nthreads, axb_method, ...) through a descriptor factory (:92-156).
Here a descriptor is a plain dataclass consumed by the engine dispatch; the
Engine extras are lowering hints (mxm strategy, target sharding).
"""

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Descriptor:
    output_replace: bool = False
    mask_complement: bool = False
    mask_structure: bool = False
    transpose_first: bool = False
    transpose_second: bool = False
    # engine hints (analogue of SuiteSparse descriptor extras,
    # reference: core/ss/descriptor.py:19-233)
    opts: dict = field(default_factory=dict, compare=False, hash=False)

    @property
    def _name(self):
        parts = []
        if self.output_replace:
            parts.append("replace")
        if self.mask_complement:
            parts.append("comp_mask")
        if self.mask_structure:
            parts.append("structural_mask")
        if self.transpose_first:
            parts.append("transpose_first")
        if self.transpose_second:
            parts.append("transpose_second")
        return "+".join(parts) if parts else "default"


_VALID_OPTS = {
    "mxm_strategy",  # "auto" | "mxu" | "generic" | "pallas"
    "nthreads",  # accepted for compatibility; ignored (XLA owns threading)
    "chunk",
    "axb_method",  # accepted for compatibility with SuiteSparse descriptors
    "sort",
    "compression",
    "compression_level",
    "secure_import",
}


def descriptor_lookup(
    *,
    transpose_first=False,
    transpose_second=False,
    mask_complement=False,
    mask_structure=False,
    output_replace=False,
    **opts,
):
    """Build a Descriptor; unknown opts raise (reference: core/descriptor.py:92-156)."""
    bad = set(opts) - _VALID_OPTS
    if bad:
        raise ValueError(f"Descriptor option(s) not supported: {sorted(bad)}")
    return Descriptor(
        output_replace=output_replace,
        mask_complement=mask_complement,
        mask_structure=mask_structure,
        transpose_first=transpose_first,
        transpose_second=transpose_second,
        opts=opts,
    )
