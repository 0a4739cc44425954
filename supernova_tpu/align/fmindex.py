"""BWT / FM-index over graph edge sequences.

Reference: lib/tada/src/bwt.rs — Occ checkpoint table (`Occ::new/get`,
bwt.rs:34-67), `less` counts (:69), `FMIndex::backward_search` (:119),
bucketed BWT construction + merge (`compute_bwt*`, :229-317).  The
reference ships it as an experimental exact-match locator over the DBG
edge set.

Device re-design:
  * build (host): generalized suffix array over the concatenated edge
    sequences via prefix-doubling with np.lexsort (no per-suffix loops);
    edge separators use code 4 so DNA patterns (codes 0-3) can never
    match across an edge boundary.
  * query (device or host): backward search batched over MANY patterns at
    once — a lax.scan over pattern positions where every step updates all
    (lo, hi) ranges with vectorized rank (Occ) lookups.  Rank = checkpoint
    gather + in-block popcount over a packed 2-bit block, the FM analogue
    of the reference's per-query loop (bwt.rs:119-138).

The suffix array is kept whole (host RAM is ample at the debug scale this
tool serves; the reference samples it with sa_step, bwt.rs:101-113).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

SEP = 4  # edge separator code
TERM = 5  # unique terminator
SIGMA = 6  # alphabet size incl. separator + terminator
CHECK = 64  # Occ checkpoint spacing (bwt.rs uses k-spaced checkpoints)


def suffix_array(t: np.ndarray) -> np.ndarray:
    """Suffix array of uint8 text t (terminator must already be unique)."""
    n = len(t)
    rank = t.astype(np.int64)
    k = 1
    while True:
        key2 = np.full(n, -1, np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        new = np.zeros(n, np.int64)
        r_o, k_o = rank[order], key2[order]
        bump = np.ones(n, np.int64)
        bump[1:] = (r_o[1:] != r_o[:-1]) | (k_o[1:] != k_o[:-1])
        new[order] = np.cumsum(bump) - 1
        rank = new
        if rank[order[-1]] == n - 1:
            return order.astype(np.int64)
        k *= 2


@dataclass
class FMIndex:
    bwt: np.ndarray  # (n,) uint8
    sa: np.ndarray  # (n,) int64
    less: np.ndarray  # (SIGMA,) int64  (C array)
    occ_ck: np.ndarray  # (n//CHECK + 1, SIGMA) int64 checkpoints
    edge_starts: np.ndarray  # (E+1,) int64 edge offsets in the text

    @classmethod
    def from_edges(cls, edge_seqs) -> "FMIndex":
        """Build from a list/Ragged of edge base-code arrays."""
        parts, starts, pos = [], [0], 0
        for e in edge_seqs:
            e = np.asarray(e, np.uint8)
            parts.append(e)
            parts.append(np.array([SEP], np.uint8))
            pos += len(e) + 1
            starts.append(pos)
        parts.append(np.array([TERM], np.uint8))
        t = np.concatenate(parts)
        sa = suffix_array(t)
        bwt = t[sa - 1]  # t[-1] (the terminator) for sa == 0
        counts = np.bincount(t, minlength=SIGMA).astype(np.int64)
        less = np.concatenate([[0], np.cumsum(counts)[:-1]])
        nck = len(t) // CHECK + 1
        occ_ck = np.zeros((nck, SIGMA), np.int64)
        onehot = np.zeros((len(t), SIGMA), np.int64)
        onehot[np.arange(len(t)), bwt] = 1
        cum = np.cumsum(onehot, axis=0)
        occ_ck[1:] = cum[CHECK - 1 :: CHECK][: nck - 1]
        return cls(bwt, sa, less, occ_ck,
                   np.asarray(starts, np.int64))

    # ----------------------------------------------------------- host query
    def occ(self, r, a):
        """#occurrences of symbol a in bwt[:r] (vectorized over r)."""
        r = np.asarray(r, np.int64)
        ck = self.occ_ck[r // CHECK, a]
        base = (r // CHECK) * CHECK
        # in-block scan, vectorized: positions base..r-1
        width = int(np.max(r - base, initial=0))
        if width == 0:
            return ck
        idx = base[..., None] + np.arange(width)
        inb = idx < r[..., None]
        sym = self.bwt[np.minimum(idx, len(self.bwt) - 1)]
        return ck + np.sum((sym == a) & inb, axis=-1)

    def backward_search(self, pattern: np.ndarray):
        """(lo, hi) suffix-array range of exact matches of pattern."""
        lo, hi = np.int64(0), np.int64(len(self.bwt))
        for c in np.asarray(pattern, np.uint8)[::-1]:
            lo = self.less[c] + self.occ(np.array([lo]), c)[0]
            hi = self.less[c] + self.occ(np.array([hi]), c)[0]
            if lo >= hi:
                return np.int64(0), np.int64(0)
        return lo, hi

    def count(self, pattern) -> int:
        lo, hi = self.backward_search(pattern)
        return int(hi - lo)

    def locate(self, pattern):
        """Sorted (edge, offset) pairs of every exact occurrence."""
        lo, hi = self.backward_search(pattern)
        pos = np.sort(self.sa[lo:hi])
        edge = np.searchsorted(self.edge_starts, pos, "right") - 1
        off = pos - self.edge_starts[edge]
        return np.stack([edge, off], axis=1)

    # --------------------------------------------------------- device query
    def count_batch_device(self, patterns: np.ndarray, lengths: np.ndarray):
        """Batched exact-match counts on the accelerator.

        patterns (Q, L) uint8 right-padded, lengths (Q,).  One lax.scan
        over the L positions; each step is a vectorized rank lookup for
        all Q live ranges (the batched form of bwt.rs:119-138)."""
        import jax
        import jax.numpy as jnp

        q, l = patterns.shape
        bwt = jnp.asarray(self.bwt.astype(np.int32))
        less = jnp.asarray(self.less.astype(np.int32))
        occ_ck = jnp.asarray(self.occ_ck.astype(np.int32))
        # in-block symbols as one gathered (CHECK,) window per query/step
        pat = jnp.asarray(patterns.astype(np.int32))
        lens = jnp.asarray(lengths.astype(np.int32))

        def rank(r, c):
            ck = occ_ck[r // CHECK, c]
            base = (r // CHECK) * CHECK
            win = bwt[base[:, None] + jnp.arange(CHECK)]
            inb = (base[:, None] + jnp.arange(CHECK)) < r[:, None]
            return ck + jnp.sum((win == c[:, None]) & inb, axis=1)

        def step(carry, i):
            lo, hi = carry
            # process pattern position len-1-i (right to left), live while
            # i < len
            j = lens - 1 - i
            live = (j >= 0) & (hi > lo)
            c = pat[jnp.arange(q), jnp.maximum(j, 0)]
            nlo = less[c] + rank(lo, c)
            nhi = less[c] + rank(hi, c)
            lo = jnp.where(live, nlo, lo)
            hi = jnp.where(live, nhi, hi)
            return (lo, hi), None

        lo0 = jnp.zeros((q,), jnp.int32)
        hi0 = jnp.full((q,), len(self.bwt), jnp.int32)
        (lo, hi), _ = jax.lax.scan(step, (lo0, hi0), jnp.arange(l))
        return jnp.maximum(hi - lo, 0)
