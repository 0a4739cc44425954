"""48-mer codec: pack / reverse-complement / canonicalize / lex-sort / search.

Device-side analogue of the reference's Kmer/Lmer primitives
(lib/tada/src/kmer/mod.rs:27-52 — K=48, 2-bit packed) and KMer<K>
(lib/assembly/src/kmers/KMer.h).  A 48-mer is 96 bits, stored as 3 uint32
words of 16 bases each, base-big-endian within each word so that
lexicographic (a,b,c) order == lexicographic base order with A<C<G<T.

LAYOUT IS STRUCTURE-OF-ARRAYS: a batch of N kmers is W3(a,b,c) — three
separate (N,) uint32 arrays, NOT an (N,3) array: each word column is a
contiguous vector that sorts, compares and moves on its own.

Everything here is jnp, static-shape, jit-friendly.  Invalid slots use the
all-ones sentinel, which can never be a *canonical* kmer (its rc would be
all-zeros, strictly smaller), so sentinels sort after all real kmers.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

K = 48
BASES_PER_WORD = 16
KWORDS = K // BASES_PER_WORD  # 3
U32 = jnp.uint32
SENTINEL = np.uint32(0xFFFFFFFF)


class W3(NamedTuple):
    """A batch of packed 48-mers as three parallel uint32 vectors."""

    a: jax.Array  # bases 0..15
    b: jax.Array  # bases 16..31
    c: jax.Array  # bases 32..47

    def gather(self, idx):
        return W3(self.a[idx], self.b[idx], self.c[idx])

    def where(self, cond, other):
        """elementwise select: cond ? self : other (other may be scalar)."""
        if isinstance(other, W3):
            return W3(
                jnp.where(cond, self.a, other.a),
                jnp.where(cond, self.b, other.b),
                jnp.where(cond, self.c, other.c),
            )
        o = jnp.asarray(other, U32)
        return W3(
            jnp.where(cond, self.a, o),
            jnp.where(cond, self.b, o),
            jnp.where(cond, self.c, o),
        )

    @property
    def shape(self):
        return self.a.shape


def w3_full(n: int, fill=SENTINEL) -> W3:
    f = jnp.full((n,), fill, U32)
    return W3(f, f, f)


def soa_to_np(w: W3) -> np.ndarray:
    """W3 -> host (N,3) uint32 (stage-boundary serialization layout)."""
    return np.stack([np.asarray(w.a), np.asarray(w.b), np.asarray(w.c)], axis=-1)


def np_to_soa(arr: np.ndarray) -> W3:
    """(N,3) uint32 host array -> W3 of device arrays."""
    arr = np.asarray(arr, dtype=np.uint32)
    return W3(jnp.asarray(arr[:, 0]), jnp.asarray(arr[:, 1]), jnp.asarray(arr[:, 2]))


# ------------------------------------------------------------------ packing

def sliding_words(codes, n: int) -> W3:
    """Packed kmer words at every start position.

    codes: (M,) integer array of base codes 0..3, M >= n + K - 1 (pad with
    zeros on the host; validity of positions is the caller's concern).

    Built from 48 static shifted slices (shift-or), which XLA fuses into a
    single elementwise loop.
    """
    c = jnp.asarray(codes).astype(U32)
    words = []
    for w in range(KWORDS):
        acc = jnp.zeros((n,), U32)
        for i in range(BASES_PER_WORD):
            off = w * BASES_PER_WORD + i
            acc = (acc << np.uint32(2)) | jax.lax.dynamic_slice(c, (off,), (n,))
        words.append(acc)
    return W3(*words)


def _rev16(w):
    """Reverse the 16 2-bit base fields within each uint32 word."""
    w = ((w & np.uint32(0x33333333)) << np.uint32(2)) | (
        (w >> np.uint32(2)) & np.uint32(0x33333333)
    )
    w = ((w & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | (
        (w >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
    )
    w = ((w & np.uint32(0x00FF00FF)) << np.uint32(8)) | (
        (w >> np.uint32(8)) & np.uint32(0x00FF00FF)
    )
    w = (w << np.uint32(16)) | (w >> np.uint32(16))
    return w


def rc_words(w: W3) -> W3:
    """Reverse complement (complement is bitwise NOT; order reverses)."""
    return W3(_rev16(~w.c), _rev16(~w.b), _rev16(~w.a))


def lex_lt(x: W3, y: W3):
    """x < y lexicographically; -> (N,) bool."""
    return (x.a < y.a) | (
        (x.a == y.a) & ((x.b < y.b) | ((x.b == y.b) & (x.c < y.c)))
    )


def lex_eq(x: W3, y: W3):
    return (x.a == y.a) & (x.b == y.b) & (x.c == y.c)


def is_sentinel(x: W3):
    s = jnp.asarray(SENTINEL)
    return (x.a == s) & (x.b == s) & (x.c == s)


def canonicalize(w: W3):
    """Canonical = min(fwd, rc).  Returns (canon W3, flipped (N,) bool)."""
    rc = rc_words(w)
    flipped = lex_lt(rc, w)
    return rc.where(flipped, w), flipped


def successor_words(w: W3, base) -> W3:
    """Shift one base left, append `base` (0..3) at the 3' end."""
    bb = jnp.asarray(base).astype(U32)
    return W3(
        (w.a << np.uint32(2)) | (w.b >> np.uint32(30)),
        (w.b << np.uint32(2)) | (w.c >> np.uint32(30)),
        (w.c << np.uint32(2)) | bb,
    )


def predecessor_words(w: W3, base) -> W3:
    """Shift one base right, prepend `base` (0..3) at the 5' end."""
    bb = jnp.asarray(base).astype(U32)
    return W3(
        (w.a >> np.uint32(2)) | (bb << np.uint32(30)),
        (w.b >> np.uint32(2)) | ((w.a & np.uint32(3)) << np.uint32(30)),
        (w.c >> np.uint32(2)) | ((w.b & np.uint32(3)) << np.uint32(30)),
    )


def first_base(w: W3):
    return (w.a >> np.uint32(30)).astype(jnp.int32)


def last_base(w: W3):
    return (w.c & np.uint32(3)).astype(jnp.int32)


def unpack_bases(w: W3):
    """W3 -> (N, 48) int32 base codes (16x the bytes of the packed words —
    use only where a dense base matrix is genuinely needed)."""
    shifts = (np.uint32(2) * (15 - np.arange(16, dtype=np.uint32))).astype(np.uint32)
    cols = [
        ((word[:, None] >> shifts[None, :]) & np.uint32(3)).astype(jnp.int32)
        for word in (w.a, w.b, w.c)
    ]
    return jnp.concatenate(cols, axis=1)


def sort_by_words(w: W3, extra_keys=(), payloads=(), stable: bool = True):
    """Lexicographic sort by the 3 kmer words (+ extra key arrays).

    Returns (W3 sorted, extra_keys_sorted tuple, payloads_sorted tuple).
    Pass stable=False when rows with fully-equal keys are interchangeable
    (e.g. occurrence rows with all attributes packed into the keys) — the
    sort is then free to skip stability.
    """
    ops = [w.a, w.b, w.c, *extra_keys, *payloads]
    num_keys = 3 + len(extra_keys)
    out = jax.lax.sort(tuple(ops), num_keys=num_keys, is_stable=stable)
    nk = len(extra_keys)
    return W3(*out[:3]), tuple(out[3 : 3 + nk]), tuple(out[3 + nk :])


def searchsorted_words(table: W3, query: W3, table_size: int | None = None):
    """First index i in sorted `table` with table[i] >= query row.

    Vectorized branchless binary search (log2(M) gather rounds).  M is the
    static padded table length; pad rows must be SENTINEL so they sort last.
    Returns (idx (N,) int32, found (N,) bool) where found means exact match.
    """
    m = table.a.shape[0] if table_size is None else table_size
    n = query.a.shape[0]
    lo = jnp.zeros((n,), jnp.int32)
    hi = jnp.full((n,), m, jnp.int32)
    steps = max(1, int(np.ceil(np.log2(max(m, 2)))) + 1)

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) >> 1
        t = table.gather(mid)
        less = lex_lt(t, query)
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

    lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    idx = lo
    hit = lex_eq(table.gather(jnp.minimum(idx, m - 1)), query) & (idx < m)
    return idx, hit


def lookup_words_merge(table: W3, query: W3):
    """Bulk dictionary lookup as a sort-merge join (the device hash-map
    replacement at large N: one sort instead of a vectorized binary search;
    chosen on an earlier device, not yet re-measured on the H100 —
    ROADMAP speed item 2).

    table must be lexicographically sorted (sentinel-padded).  Returns
    (row (N,) int32 = matching table row (undefined when not found),
     found (N,) bool).
    """
    m = table.a.shape[0]
    n = query.a.shape[0]
    ka = jnp.concatenate([table.a, query.a])
    kb = jnp.concatenate([table.b, query.b])
    kc_ = jnp.concatenate([table.c, query.c])
    tag = jnp.concatenate(
        [jnp.zeros((m,), U32), jnp.ones((n,), U32)]
    )
    idx = jnp.concatenate(
        [jnp.arange(m, dtype=jnp.int32), jnp.arange(n, dtype=jnp.int32)]
    )
    sa, sb, sc, stag, sidx = jax.lax.sort(
        (ka, kb, kc_, tag, idx), num_keys=4, is_stable=True
    )
    pos = jnp.arange(m + n, dtype=jnp.int32)
    is_table = stag == 0
    # table rows arrive pre-sorted, so their row ids are increasing in the
    # merged order and cummax propagates the latest table row exactly
    last_tpos = jax.lax.cummax(jnp.where(is_table, pos, -1))
    last_trow = jax.lax.cummax(jnp.where(is_table, sidx, -1))
    sw = W3(sa, sb, sc)
    wstarts = jnp.zeros((m + n,), bool).at[0].set(True)
    neq = (sa[1:] != sa[:-1]) | (sb[1:] != sb[:-1]) | (sc[1:] != sc[:-1])
    wstarts = wstarts.at[1:].set(neq)
    last_run_start = jax.lax.cummax(jnp.where(wstarts, pos, 0))
    found_here = last_tpos >= last_run_start
    # scatter results back into query order
    qslot = jnp.where(is_table, n, sidx)
    row = jnp.zeros((n + 1,), jnp.int32).at[qslot].set(
        jnp.maximum(last_trow, 0), mode="drop"
    )[:n]
    found = jnp.zeros((n + 1,), bool).at[qslot].set(found_here, mode="drop")[:n]
    return row, found


# ------------------------------------------------------------- host helpers

def words_from_codes_np(codes: np.ndarray) -> np.ndarray:
    """Reference numpy packing of a single K-length code array -> (3,) uint32."""
    codes = np.asarray(codes, dtype=np.uint64)
    assert codes.shape[0] == K
    out = np.zeros(KWORDS, dtype=np.uint32)
    for w in range(KWORDS):
        acc = np.uint64(0)
        for i in range(BASES_PER_WORD):
            acc = (acc << np.uint64(2)) | codes[w * BASES_PER_WORD + i]
        out[w] = np.uint32(acc)
    return out


def codes_from_words_np(words: np.ndarray) -> np.ndarray:
    """(3,) uint32 -> (48,) uint8 base codes."""
    words = np.asarray(words, dtype=np.uint32)
    out = np.zeros(K, dtype=np.uint8)
    for w in range(KWORDS):
        v = int(words[w])
        for i in range(BASES_PER_WORD):
            out[w * BASES_PER_WORD + i] = (v >> (2 * (BASES_PER_WORD - 1 - i))) & 3
    return out
