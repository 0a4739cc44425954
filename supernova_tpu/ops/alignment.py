"""Batched affine-gap sequence alignment (SmithWatAffine analogue).

Reference: pairwise_aligners/SmithWatAffine.cc (used for bubble arm-vs-arm
comparison in the het-rate estimate, CP.cc:1486-1557, and read-stack
consensus scoring).  Device design: the DP recurrence runs as a
lax.scan over rows of the (LA+1, LB+1) matrix with the whole row as vector
state, vmapped over the batch — score-only (the pipeline consumes distances
and SNP counts, not tracebacks).

Scoring (penalties, lower=better distance):  mismatch MIS, gap open OPEN,
gap extend EXT — the reference's SmithWatAffine penalty convention.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

MIS = 3
OPEN = 12
EXT = 1
BIG = np.int32(10**9 // 2)


@partial(jax.jit, static_argnames=("mis", "open_", "ext"))
def affine_align_score(
    a,  # (B, LA) int codes, padded with -1
    b,  # (B, LB) int codes, padded with -1
    la,  # (B,) true lengths
    lb,  # (B,) true lengths
    mis: int = MIS,
    open_: int = OPEN,
    ext: int = EXT,
):
    """Global affine alignment penalty per pair; -> (B,) int32."""

    def one(a_row, b_row, n_a, n_b):
        LB = b_row.shape[0]
        j = jnp.arange(LB + 1, dtype=jnp.int32)
        bmask = j[1:] <= n_b  # valid b positions (1-based cols)
        # init row 0: gaps in a
        m0 = jnp.where(j == 0, 0, BIG)
        ins0 = jnp.where(j == 0, BIG, open_ + ext * (j - 1) + ext)  # gap in a
        ins0 = jnp.where(j <= n_b, ins0, BIG)
        del0 = jnp.full((LB + 1,), BIG, jnp.int32)
        best0 = jnp.minimum(m0, jnp.minimum(ins0, del0))

        def row(carry, ai_i):
            best_prev, del_prev, i = carry
            ai, i_valid = ai_i
            sub = jnp.where(
                (ai == b_row) & bmask, 0, mis
            )  # (LB,) match/mismatch cost
            diag = best_prev[:-1] + sub  # M[i,j] from best[i-1,j-1]
            dele = jnp.minimum(del_prev + ext, best_prev + open_ + ext)  # gap in b
            # first column: only deletions
            m_row = jnp.concatenate([jnp.array([BIG], jnp.int32), diag])
            # insertions (gap in a) need a scan along j: I[j] = min(best[j-1]+open+ext, I[j-1]+ext)
            def ins_step(acc, x):
                best_jm1 = x
                val = jnp.minimum(best_jm1 + open_ + ext, acc + ext)
                return val, val

            # best so far without insertions:
            interim = jnp.minimum(m_row, dele)
            _, ins_tail = jax.lax.scan(ins_step, BIG, interim[:-1])
            ins_row = jnp.concatenate([jnp.array([BIG], jnp.int32), ins_tail])
            best_row = jnp.minimum(interim, ins_row)
            # row i is only meaningful while i <= n_a; keep last valid row
            keep = i_valid
            best_out = jnp.where(keep, best_row, best_prev)
            del_out = jnp.where(keep, dele, del_prev)
            return (best_out, del_out, i + 1), None

        ii = jnp.arange(a_row.shape[0], dtype=jnp.int32)
        (best, _, _), _ = jax.lax.scan(
            row, (best0, del0, jnp.int32(1)), (a_row, ii < n_a)
        )
        return best[n_b]

    return jax.vmap(one)(a, b, la.astype(jnp.int32), lb.astype(jnp.int32))


def align_pairs_np(seq_pairs, mis=MIS, open_=OPEN, ext=EXT):
    """Host helper: list of (codes_a, codes_b) -> (B,) penalties."""
    if not seq_pairs:
        return np.zeros(0, np.int32)
    la = np.array([len(a) for a, _ in seq_pairs], np.int32)
    lb = np.array([len(b) for _, b in seq_pairs], np.int32)
    LA, LB = int(la.max()), int(lb.max())
    A = np.full((len(seq_pairs), LA), -1, np.int32)
    B = np.full((len(seq_pairs), LB), -1, np.int32)
    for i, (a, b) in enumerate(seq_pairs):
        A[i, : len(a)] = a
        B[i, : len(b)] = b
    return np.asarray(
        affine_align_score(
            jnp.asarray(A), jnp.asarray(B), jnp.asarray(la), jnp.asarray(lb),
            mis=mis, open_=open_, ext=ext,
        )
    )


def brute_affine_np(a, b, mis=MIS, open_=OPEN, ext=EXT):
    """O(LA*LB) reference implementation for tests."""
    la, lb = len(a), len(b)
    INF = 10**9 // 2
    M = np.full((la + 1, lb + 1), INF, np.int64)
    I = np.full((la + 1, lb + 1), INF, np.int64)  # gap in a (move along b)
    D = np.full((la + 1, lb + 1), INF, np.int64)  # gap in b
    M[0, 0] = 0
    for j in range(1, lb + 1):
        I[0, j] = open_ + ext * j
    for i in range(1, la + 1):
        D[i, 0] = open_ + ext * i
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            sub = 0 if a[i - 1] == b[j - 1] else mis
            M[i, j] = min(M[i - 1, j - 1], I[i - 1, j - 1], D[i - 1, j - 1]) + sub
            I[i, j] = min(
                M[i, j - 1] + open_ + ext,
                I[i, j - 1] + ext,
                D[i, j - 1] + open_ + ext,
            )
            D[i, j] = min(
                M[i - 1, j] + open_ + ext,
                D[i - 1, j] + ext,
                I[i - 1, j] + open_ + ext,
            )
    return int(min(M[la, lb], I[la, lb], D[la, lb]))
