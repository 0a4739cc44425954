"""Sorted-segment reductions and stable compaction.

Device replacement for the reference's MapReduceEngine reduce phase
(lib/assembly/src/MapReduceEngine.h) — after a device sort, groups are
contiguous runs, and reductions become segment ops with sorted indices.

All functions are static-shape: num_segments is always the (padded) input
length N — every row could be unique — and callers track the true count
with scalars.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def run_starts(*key_arrays):
    """Boolean mask marking the first row of each run of equal keys.

    Each key array is (N,) (or (N,W), compared row-wise).  Row 0 is a start.
    """
    n = key_arrays[0].shape[0]
    neq = jnp.zeros((n,), bool)
    for k in key_arrays:
        k = jnp.asarray(k)
        if k.ndim == 1:
            k = k[:, None]
        d = jnp.any(k[1:] != k[:-1], axis=-1)
        neq = neq.at[1:].set(neq[1:] | d)
    return neq.at[0].set(True)


def segment_ids_from_starts(starts):
    """starts bool (N,) -> contiguous segment ids (N,) int32 (0-based)."""
    return jnp.cumsum(starts.astype(jnp.int32)) - 1


def seg_sum(values, seg_ids, num_segments: int):
    return jax.ops.segment_sum(
        values, seg_ids, num_segments=num_segments, indices_are_sorted=True
    )


def seg_max(values, seg_ids, num_segments: int):
    return jax.ops.segment_max(
        values, seg_ids, num_segments=num_segments, indices_are_sorted=True
    )


def seg_min(values, seg_ids, num_segments: int):
    return jax.ops.segment_min(
        values, seg_ids, num_segments=num_segments, indices_are_sorted=True
    )



def run_broadcast_from_start(values, starts, fill=0):
    """Per-row value of the row's run start, propagated forward without
    gathers: requires `values` to be NON-DECREASING along the array (true
    for cumsums) — then a cummax of the masked start values is exact."""
    masked = jnp.where(starts, values, fill)
    return jax.lax.cummax(masked)


def run_end_mask(starts):
    """Row is the last of its run."""
    return jnp.concatenate([starts[1:], jnp.ones((1,), bool)])


def stable_compact(valid, *arrays):
    """Stable partition: rows with valid=True first, preserving order.

    Returns (n_valid scalar int32, compacted arrays); rows past n_valid are
    zeroed.  Stream compaction: an exclusive prefix sum of `valid` gives
    each kept row its output slot, and one scatter per column with unique
    indices writes it there (dropped rows aim past the end).  Arrays may be
    (N,) or (N, W).
    """
    valid = jnp.asarray(valid)
    n = valid.shape[0]
    v = valid.astype(jnp.int32)
    slot = jnp.where(valid, jnp.cumsum(v) - v, n)
    n_valid = jnp.sum(v)
    res = tuple(
        jnp.zeros_like(a).at[slot].set(a, mode="drop", unique_indices=True)
        for a in map(jnp.asarray, arrays)
    )
    return n_valid, res

