"""Distributed masked SpGEMM: C(M) = A (+).(x) B over multiple devices.

Reference shape: the masked ``plus_pair`` triangle-counting product
C(L.S) = L plus_pair U (notebooks/Louvain.ipynb, reference
core/matrix.py:2264-2331 GrB_mxm with mask).  The reference itself has no
distribution (SURVEY §2.2); the design here:

- **Partition by mask-row blocks.**  Output entries are disjoint across
  blocks, so the product is embarrassingly parallel: device d computes the
  mask entries whose row lies in its block.  No collectives are needed —
  unlike SpMV (one ``psum``/apply), distributed masked SpGEMM's natural
  cut is the output, and the eq-join task shapes differ per block, so
  lock-step SPMD would pad every device to the worst-case bucket set.
  Each device instead runs its own analyzed plan (placed on that device;
  dispatches are async, so the devices run concurrently).
- **Operands replicate.**  A's rows outside the block are never touched by
  the block's tasks; B is consumed column-wise by every block.  At GAP
  scale the operand COO is ~100 MB — replication is the right trade (an
  all-gather of B would cost more than holding it).
- The per-device execution is the single-chip engine unchanged
  (core/sparse.sparse_spgemm_analyze/execute): pattern analysis once per
  (A, B, M, partition), values re-executable.
"""

import numpy as np


def _row_blocks(m_rows, nrows, ndev):
    """Balanced mask-row partition: split row space so each block holds
    ~equal mask ENTRIES (the work is per-entry, not per-row)."""
    m_rows = np.asarray(m_rows)
    if len(m_rows) == 0:
        step = -(-nrows // ndev)
        return [(d * step, min((d + 1) * step, nrows)) for d in range(ndev)]
    counts = np.bincount(m_rows, minlength=nrows)
    csum = np.concatenate([[0], np.cumsum(counts)])
    total = csum[-1]
    bounds = [0]
    for d in range(1, ndev):
        target = total * d // ndev
        bounds.append(int(np.searchsorted(csum, target)))
    bounds.append(nrows)
    return [(bounds[d], bounds[d + 1]) for d in range(ndev)]


def _put_plan(plan, device):
    """Place every device-array leaf of a SpgemmPlan on ``device``."""
    import jax

    def put(x):
        return None if x is None else jax.device_put(x, device)

    plan.buckets = [
        (b[0], put(b[1]), put(b[2]), put(b[3]), put(b[4]), put(b[5]), put(b[6]), *b[7:])
        for b in plan.buckets
    ]
    if plan.brick is not None:
        br = plan.brick
        br.a_bricks = put(br.a_bricks)
        br.b_bricks = put(br.b_bricks)
        br.a_idx = put(br.a_idx)
        br.b_idx = put(br.b_idx)
        br.entry_cell = put(br.entry_cell)
    if plan.reduce_net is not None:
        net1, net2, seg_start, has_task = plan.reduce_net
        plan.reduce_net = (
            jax.device_put(net1, device),  # PermutePlan is a registered pytree
            jax.device_put(net2, device),
            put(seg_start),
            put(has_task),
        )
    return plan


class ShardedSpgemmPlan:
    """Per-device analyzed plans for one (A, B, M, partition) pattern."""

    __slots__ = ("blocks", "n_entries", "out_order")

    def __init__(self, blocks, n_entries, out_order):
        self.blocks = blocks  # [(device, plan | None, entry_idx)]
        self.n_entries = n_entries
        self.out_order = out_order  # block-concat position -> entry id


def sharded_spgemm_analyze(a_sp, b_sp, m_rows, m_cols, devices, **opts):
    """Analyze C(M) = A (.) B into per-device mask-row-block plans."""
    from ..core.sparse import sparse_spgemm_analyze

    m_rows = np.asarray(m_rows, np.int64)
    m_cols = np.asarray(m_cols, np.int64)
    ndev = len(devices)
    blocks = []
    order_parts = []
    for d, (lo, hi) in enumerate(_row_blocks(m_rows, a_sp.nrows, ndev)):
        sel = np.flatnonzero((m_rows >= lo) & (m_rows < hi))
        if len(sel) == 0:
            blocks.append((devices[d], None, sel))
            continue
        plan = sparse_spgemm_analyze(a_sp, b_sp, m_rows[sel], m_cols[sel], **opts)
        blocks.append((devices[d], _put_plan(plan, devices[d]), sel))
        order_parts.append(sel)
    out_order = (
        np.concatenate(order_parts) if order_parts else np.empty(0, np.int64)
    )
    return ShardedSpgemmPlan(blocks, len(m_rows), out_order)


def sharded_spgemm_execute(splan, sr, out_dtype):
    """Run every device's block (async dispatches overlap across devices);
    returns (values, hit, total flops), each in mask-entry order."""
    from ..core.sparse import sparse_spgemm_execute

    out_np = np.dtype(out_dtype.np_type)
    vals = np.zeros(splan.n_entries, out_np)
    hits = np.zeros(splan.n_entries, bool)
    pending = []
    for device, plan, sel in splan.blocks:
        if plan is None:
            continue
        acc, hit, flops = sparse_spgemm_execute(plan, sr, out_dtype, keep_on_device=True)
        pending.append((sel, acc, hit, flops))
    total_flops = 0
    for sel, acc, hit, flops in pending:
        vals[sel] = np.asarray(acc)[: len(sel)]
        hits[sel] = np.asarray(hit)[: len(sel)]
        total_flops += int(flops)
    return vals, hits, total_flops


def sharded_masked_mxm_arrays(a_sp, b_sp, m_rows, m_cols, sr, out_dtype, context):
    """One-shot distributed masked mxm.  Same contract as
    core/sparse.sparse_mxm_masked: (rows, cols, values, flops) restricted to
    mask entries whose intersection is non-empty."""
    m_rows = np.asarray(m_rows, np.int64)
    m_cols = np.asarray(m_cols, np.int64)
    devices = list(context.mesh.devices.flat)
    use_bricks = (
        sr.monoid.parent.name == "plus"
        and sr.binaryop.parent.name in ("pair", "times")
        and np.dtype(out_dtype.np_type) == np.float32
    )
    splan = sharded_spgemm_analyze(
        a_sp, b_sp, m_rows, m_cols, devices, bricks=use_bricks
    )
    vals, hits, flops = sharded_spgemm_execute(splan, sr, out_dtype)
    return m_rows[hits], m_cols[hits], vals[hits], flops
