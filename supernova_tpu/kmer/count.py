"""48-mer counting: the MSP/SHARD_ASM/Kmerizer analogue, as one device program.

Reference behavior being reproduced (SURVEY.md §2.1, §7 step 3):
  * qual trim: longest prefix whose final K bases all have qual >= MIN_QUAL=7
    (lib/tada/src/cmd_msp.rs:127-146, BuildReadQGraph48.cc:65-89
    GoodLenTailFinder); reads with good length < K+1 contribute no kmers
    (Kmerizer::map, BuildReadQGraph48.cc:158-161).
  * canonical 48-mers with observed left/right extension contexts, rc-flipped
    together with the kmer (Kmerizer::map, BuildReadQGraph48.cc:160-174).
  * filter: count >= min_freq AND (some occurrence from a barcode-ignored
    read OR >= min_bc distinct barcodes>0)  (Kmerizer::reduce +
    areEnoughBarcodes/areIgnoredBarcodes, BuildReadQGraph48.cc:108-183).
  * adjacency recompute after filtering: observed contexts intersected with
    table membership (KmerDict::recomputeAdjacencies, kmers/ReadPather.h:346).

Device design: no hash maps — one big lexicographic sort of all (kmer,
barcode) occurrence rows, then sorted-segment reductions.  All shapes
static; invalid rows ride along as all-ones sentinels.  Kmer batches are
W3 structure-of-arrays (see core/kmer_codec.py) — three flat uint32
vectors, never (N,3).
"""
from __future__ import annotations

import logging
import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import kmer_codec as kc
from ..core.kmer_codec import K, W3
from ..ops import segments as seg

MIN_QUAL = 7  # DF.cc:138-141
MIN_FREQ = 3  # mro/_assembler.mro:44 min_kmer_obs
MIN_BC = 2  # DF.cc MIN_BC default
BC_IGNORED = -1  # occurrences whose barcode is untracked (block-0 reads)
BC_FIELD_IGNORED = 0x3FFFFF  # 22-bit barcode field; all-ones = "ignored"
U32 = jnp.uint32


class KmerTable(NamedTuple):
    """Sorted canonical kmer table, sentinel-padded to static size M."""

    words: W3  # (M,) x3 uint32, canonical, ascending; sentinel pad
    count: jax.Array  # (M,) int32 occurrence count
    nbc: jax.Array  # (M,) int32 distinct barcodes > 0
    left_mask: jax.Array  # (M,) uint32 4-bit predecessor-base mask
    right_mask: jax.Array  # (M,) uint32 4-bit successor-base mask
    n_valid: jax.Array  # scalar int32


def rev4(mask):
    """Reverse a 4-bit base mask (bit b -> bit 3-b): rc of an extension set."""
    mask = jnp.asarray(mask)
    return (
        ((mask & 1) << 3) | ((mask & 2) << 1) | ((mask & 4) >> 1) | ((mask & 8) >> 3)
    )


def good_lengths(quals, read_offsets, pos_read, min_qual: int = MIN_QUAL):
    """Per-read good length: the qual-trim rule (cmd_msp.rs:127-146).

    quals: (NB,) flat phred scores; read_offsets: (R+1,); pos_read: (NB,)
    read id per flat position.  Vectorized as a cummax over 'blocker'
    positions (bad qual or read start) -> consecutive-good streak length.
    """
    nb = quals.shape[0]
    n_reads = read_offsets.shape[0] - 1
    p = jnp.arange(nb, dtype=jnp.int32)
    bad = quals < min_qual
    # read start per position: broadcast p forward from read-first rows
    # (cheaper than a 48M gather from read_offsets)
    read_first = jnp.concatenate(
        [jnp.ones((1,), bool), pos_read[1:] != pos_read[:-1]]
    )
    read_start = jax.lax.cummax(jnp.where(read_first, p, 0))
    blocker = jnp.where(bad, p + 1, 0)
    last_bad = jax.lax.cummax(blocker)
    bound = jnp.maximum(last_bad, read_start)
    streak = p + 1 - bound  # consecutive good quals ending at p, within read
    ok_end = streak >= K
    # per-read LAST ok_end position, scatter-free: reads are contiguous, so
    # binary-search the cumulative ok_end count at each read's boundaries
    cs = jnp.cumsum(ok_end.astype(jnp.int32))
    cs_ext = jnp.concatenate([jnp.zeros((1,), jnp.int32), cs])
    s_r = read_offsets[:-1].astype(jnp.int32)
    e_r = read_offsets[1:].astype(jnp.int32)
    t_e = cs_ext[e_r]
    t_s = cs_ext[s_r]
    has = t_e > t_s
    p_star = jnp.searchsorted(cs, t_e, side="left").astype(jnp.int32)
    return jnp.where(has, p_star + 1 - s_r, 0).astype(jnp.int32)


def extract_occurrences(
    codes_ext,  # (NB + K,) int32/uint8 flat base codes, zero-padded tail
    pos_read,  # (NB,) int32 read id per flat position (nondecreasing)
    glen_pos,  # (NB,) int32 qual-trimmed good length of the row's read
    bc_pos,  # (NB,) int32 barcode of the row's read (BC_IGNORED or > 0)
    min_read_len: int = K + 1,
):
    """Per-position canonical kmer occurrences (the Kmerizer::map phase).
    Per-read attributes arrive pre-broadcast to positions (host np.repeat
    or a device broadcast; no position-scale gathers).
    -> (canon W3 sentinel-for-invalid, bc (NB,), lm (NB,), rm (NB,),
        valid (NB,) bool)."""
    nb = pos_read.shape[0]
    codes_ext = jnp.asarray(codes_ext).astype(jnp.int32)
    p = jnp.arange(nb, dtype=jnp.int32)

    words = kc.sliding_words(codes_ext, nb)
    canon, flipped = kc.canonicalize(words)

    read_first = jnp.concatenate(
        [jnp.ones((1,), bool), pos_read[1:] != pos_read[:-1]]
    )
    start = jax.lax.cummax(jnp.where(read_first, p, 0))
    pir = p - start  # position in read
    glen = glen_pos
    # reads below K+1 good bases contribute nothing (Kmerizer,
    # BuildReadQGraph48.cc:160); rebuild-from-edges callers pass
    # min_read_len=K so single-kmer edges survive (edge re-kmerization
    # uses size-K+1 with no minimum, BuildReadQGraph48.cc:742)
    valid = (pir + K <= glen) & (glen >= min_read_len)

    has_pred = pir > 0
    # neighbor bases as STATIC slices of codes_ext (p-1 and p+K), not as
    # position-scale gathers
    pred = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jax.lax.dynamic_slice(codes_ext, (0,), (nb - 1,))]
    )
    has_succ = pir + K < glen
    succ = jax.lax.dynamic_slice(codes_ext, (K,), (nb,))
    lmask = jnp.where(has_pred, (1 << pred).astype(U32), U32(0))
    rmask = jnp.where(has_succ, (1 << succ).astype(U32), U32(0))
    lm = jnp.where(flipped, rev4(rmask), lmask)
    rm = jnp.where(flipped, rev4(lmask), rmask)

    canon = canon.where(valid, kc.SENTINEL)
    return canon, bc_pos, lm, rm, valid


def uniform_tail_cut(uniform_rl: int, *arrays):
    """Static reshape+slice dropping the last K-1 positions of every
    uniform-length read block — those positions can never start a kmer.
    The ONE implementation shared by count_kmers, count_block_raw, the
    sharded count, and the pather (keep them provably identical)."""
    cols = uniform_rl - K + 1

    def cut(x):
        x = jnp.asarray(x)
        return x.reshape(-1, uniform_rl)[:, :cols].reshape(-1)

    return tuple(cut(x) for x in arrays)


def pack_occurrence_attrs(bc, lm, rm, valid):
    """Pack the non-kmer occurrence attributes into ONE uint32 sort key:
    [31:10]=barcode (22 bits; caps ids at ~4.19M — covers the 4M whitelist),
    [9:6]=left mask, [5:2]=right mask, [1]=valid."""
    bcf = jnp.where(bc == BC_IGNORED, U32(BC_FIELD_IGNORED), bc.astype(U32))
    return (
        (bcf << np.uint32(10))
        | (lm << np.uint32(6))
        | (rm << np.uint32(2))
        | (valid.astype(U32) << np.uint32(1))
    )


def unpack_occurrence_attrs(pk):
    field = pk >> np.uint32(10)
    bc = jnp.where(field == BC_FIELD_IGNORED, BC_IGNORED, field.astype(jnp.int32))
    lm = (pk >> np.uint32(6)) & np.uint32(15)
    rm = (pk >> np.uint32(2)) & np.uint32(15)
    valid = ((pk >> np.uint32(1)) & np.uint32(1)) == 1
    return bc, lm, rm, valid


def cut_occurrence_tails(uniform_rl: int, canon: W3, bc, lm, rm, valid):
    """uniform_tail_cut over one occurrence stream (the attributes ride
    through the cut as their packed word)."""
    pk = pack_occurrence_attrs(bc, lm, rm, valid)
    a_, b_, c_, pk = uniform_tail_cut(uniform_rl, canon.a, canon.b, canon.c, pk)
    bc, lm, rm, valid = unpack_occurrence_attrs(pk)
    return W3(a_, b_, c_).where(valid, kc.SENTINEL), bc, lm, rm, valid


def run_stats(ws: W3, pk):
    """Per-run statistics of an occurrence stream sorted by (words, packed
    attrs), read off at run-END rows:
    -> (ends, count, nbc, has_ign, left_mask, right_mask).

    No gathers or scatters: every count is a cumsum, and the run-relative
    value at row p is cs[p] minus the cs at the run start, which a cummax
    of start-masked (non-decreasing) cs values broadcasts forward; ANY-in-
    run is one cummax of the last indicator position against the run
    start."""
    nb = ws.a.shape[0]
    bc_s = pk >> np.uint32(10)
    lm_s = (pk >> np.uint32(6)) & np.uint32(15)
    rm_s = (pk >> np.uint32(2)) & np.uint32(15)
    valid_s = ((pk >> np.uint32(1)) & np.uint32(1)).astype(jnp.int32)
    starts = seg.run_starts(ws.a, ws.b, ws.c)
    ends = seg.run_end_mask(starts)
    p = jnp.arange(nb, dtype=jnp.int32)
    run_start_pos = jax.lax.cummax(jnp.where(starts, p, 0))

    def run_total(indicator):
        ind = indicator.astype(jnp.int32)
        cs = jnp.cumsum(ind)
        base = seg.run_broadcast_from_start(cs - ind, starts)
        return cs - base  # run-relative count; total valid at end rows

    def run_any(indicator):
        last = jax.lax.cummax(jnp.where(indicator, p, -1))
        return last >= run_start_pos

    count = run_total(valid_s)
    new_pair = starts | (bc_s != jnp.roll(bc_s, 1))
    counted_bc = (
        (valid_s == 1) & (bc_s > 0) & (bc_s != BC_FIELD_IGNORED) & new_pair
    )
    nbc = run_total(counted_bc)
    has_ign = run_any((valid_s == 1) & (bc_s == BC_FIELD_IGNORED))
    lmask_u = jnp.zeros((nb,), U32)
    rmask_u = jnp.zeros((nb,), U32)
    for b in range(4):
        lbit = run_any((valid_s == 1) & (((lm_s >> b) & 1) == 1))
        rbit = run_any((valid_s == 1) & (((rm_s >> b) & 1) == 1))
        lmask_u = lmask_u | (lbit.astype(U32) << b)
        rmask_u = rmask_u | (rbit.astype(U32) << b)
    return ends, count, nbc, has_ign, lmask_u, rmask_u


def sort_occurrences(canon: W3, bc, lm, rm, valid):
    """The count's one big sort: occurrence rows by (3 kmer words, packed
    attribute word).  Unstable: rows with equal keys are identical records.
    -> (sorted words W3, sorted packed attrs)."""
    packed = pack_occurrence_attrs(bc, lm, rm, valid)
    ws, (pk,), _ = kc.sort_by_words(canon, extra_keys=(packed,), stable=False)
    return ws, pk


def reduce_occurrences(
    canon: W3, bc, lm, rm, valid, min_freq: int = MIN_FREQ, min_bc: int = MIN_BC
) -> KmerTable:
    """Sort occurrence rows and segment-reduce into a filtered KmerTable
    (the Kmerizer::reduce phase)."""
    nb = canon.a.shape[0]
    ws, pk = sort_occurrences(canon, bc, lm, rm, valid)
    ends, count, nbc, has_ign, lmask_u, rmask_u = run_stats(ws, pk)
    keep = (
        ends & ~kc.is_sentinel(ws) & (count >= min_freq)
        & (has_ign | (nbc >= min_bc))
    )
    n_valid, (wa, wb, wc, c2, b2, l2, r2) = seg.stable_compact(
        keep, ws.a, ws.b, ws.c, count, nbc, lmask_u, rmask_u
    )
    m = jnp.arange(nb) < n_valid
    w2 = W3(wa, wb, wc).where(m, kc.SENTINEL)
    return KmerTable(
        w2, c2 * m, b2 * m, l2 * m.astype(U32), r2 * m.astype(U32), n_valid
    )


@partial(
    jax.jit, static_argnames=("min_freq", "min_bc", "min_read_len", "uniform_rl")
)
def count_kmers(
    codes_ext,
    pos_read,
    glen_pos,
    bc_pos,
    min_freq: int = MIN_FREQ,
    min_bc: int = MIN_BC,
    min_read_len: int = K + 1,
    uniform_rl: int | None = None,
) -> KmerTable:
    """Count + filter canonical 48-mers over all reads.  Fully on device.

    uniform_rl: if every read (including host padding) is laid out in
    blocks of exactly this length, the last K-1 positions of each block can
    never start a kmer — a static reshape+slice drops them BEFORE the big
    sort, cutting ~(K-1)/rl (~30% at rl=150) of the sort/reduce/compaction
    work.  prepare_reads pads reads in multiples of 128 so sibling
    inputs share compiled shapes."""
    canon, bc, lm, rm, valid = extract_occurrences(
        codes_ext, pos_read, glen_pos, bc_pos, min_read_len
    )
    if uniform_rl is not None:
        canon, bc, lm, rm, valid = cut_occurrence_tails(
            uniform_rl, canon, bc, lm, rm, valid
        )
    return reduce_occurrences(canon, bc, lm, rm, valid, min_freq, min_bc)


@jax.jit
def recompute_adjacencies(table: KmerTable) -> KmerTable:
    """Intersect observed context masks with table membership
    (KmerDict::recomputeAdjacencies, kmers/ReadPather.h:346-380)."""
    words = table.words
    lmask, rmask = table.left_mask, table.right_mask
    new_r = jnp.zeros_like(rmask)
    new_l = jnp.zeros_like(lmask)
    for b in range(4):
        succ, _ = kc.canonicalize(kc.successor_words(words, jnp.int32(b)))
        _, found = kc.lookup_words_merge(words, succ)
        new_r = new_r | jnp.where(found, U32(1 << b), U32(0))
        pred, _ = kc.canonicalize(kc.predecessor_words(words, jnp.int32(b)))
        _, found = kc.lookup_words_merge(words, pred)
        new_l = new_l | jnp.where(found, U32(1 << b), U32(0))
    return table._replace(left_mask=lmask & new_l, right_mask=rmask & new_r)


# ------------------------------------------- host adjacency twin (numpy)
# The 100 Mb count endgame OOM'd at 130 GB anon RSS inside the one jitted
# recompute_adjacencies program over the full ~100M-row table on the CPU
# backend (XLA holds the intermediates of all 8 sort-merge lookups live).
# The numpy twin below runs the same intersection chunked with bounded
# workspace; bit-identity with the jit version is tested
# (tests/test_kmer_count.py::test_recompute_adjacencies_host_twin).

def _rev16_np(w):
    w = ((w & np.uint32(0x33333333)) << np.uint32(2)) | (
        (w >> np.uint32(2)) & np.uint32(0x33333333)
    )
    w = ((w & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | (
        (w >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
    )
    w = ((w & np.uint32(0x00FF00FF)) << np.uint32(8)) | (
        (w >> np.uint32(8)) & np.uint32(0x00FF00FF)
    )
    return (w << np.uint32(16)) | (w >> np.uint32(16))


def _canon_np(a, b, c):
    """Numpy twin of kc.canonicalize on (a, b, c) uint32 columns."""
    ra, rb, rcw = _rev16_np(~c), _rev16_np(~b), _rev16_np(~a)
    flip = (ra < a) | ((ra == a) & ((rb < b) | ((rb == b) & (rcw < c))))
    return (
        np.where(flip, ra, a), np.where(flip, rb, b), np.where(flip, rcw, c)
    )


def _succ_np(a, b, c, base: int):
    bb = np.uint32(base)
    return (
        (a << np.uint32(2)) | (b >> np.uint32(30)),
        (b << np.uint32(2)) | (c >> np.uint32(30)),
        (c << np.uint32(2)) | bb,
    )


def _pred_np(a, b, c, base: int):
    hi = np.uint32(np.uint32(base) << np.uint32(30))
    return (
        (a >> np.uint32(2)) | hi,
        (b >> np.uint32(2)) | ((a & np.uint32(3)) << np.uint32(30)),
        (c >> np.uint32(2)) | ((b & np.uint32(3)) << np.uint32(30)),
    )


def _member_sorted_np(t1, tc, q1, qc):
    """Exact membership of query kmers in a lexicographically sorted table.

    t1 = (a<<32)|b of the table (ascending; ties sorted by ascending tc=c).
    Spans of equal t1 are walked in lockstep (64-bit prefix collisions are
    rare, so the walk is ~1 step)."""
    lo = np.searchsorted(t1, q1, side="left")
    hi = np.searchsorted(t1, q1, side="right")
    found = np.zeros(len(q1), bool)
    cur = lo
    active = np.flatnonzero(cur < hi)
    while len(active):
        cv = tc[cur[active]]
        qv = qc[active]
        hit = cv == qv
        found[active[hit]] = True
        step = active[(~hit) & (cv < qv)]
        cur[step] += 1
        active = step[cur[step] < hi[step]]
    return found


def recompute_adjacencies_host(
    wa, wb, wc, lmask, rmask, chunk: int = 16_000_000
):
    """Numpy twin of recompute_adjacencies over host columns.

    wa/wb/wc: sorted canonical kmer words (REAL rows only, no sentinel
    padding).  Returns (new_left_mask, new_right_mask) = observed context
    masks intersected with table membership
    (KmerDict::recomputeAdjacencies, kmers/ReadPather.h:346-380)."""
    t1 = (wa.astype(np.uint64) << np.uint64(32)) | wb
    new_l = np.zeros_like(lmask)
    new_r = np.zeros_like(rmask)
    for s in range(0, len(wa), chunk):
        e = min(s + chunk, len(wa))
        ca, cb, cc = wa[s:e], wb[s:e], wc[s:e]
        for base in range(4):
            for into, neigh in (
                (new_r, _succ_np(ca, cb, cc, base)),
                (new_l, _pred_np(ca, cb, cc, base)),
            ):
                qa, qb, qc_ = _canon_np(*neigh)
                q1 = (qa.astype(np.uint64) << np.uint64(32)) | qb
                f = _member_sorted_np(t1, wc, q1, qc_)
                into[s:e] |= f.astype(np.uint32) << np.uint32(base)
    return lmask & new_l, rmask & new_r


def _rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except Exception:
        pass
    return -1.0


def _finalize_table_host(cols, pad_multiple: int = 1024) -> KmerTable:
    """Host columns (7-tuple from the partitioned merge) -> final KmerTable:
    adjacency recompute + geometric-ladder padding, all in numpy — the
    bounded-memory twin of recompute_adjacencies(trim_table(...)).  The
    returned table is numpy-backed (the count checkpoint serializes it
    host-side; downstream jnp ops lift lazily, same as a --resume load)."""
    from ..dbg.build import geom_bucket

    wa, wb, wc, cnt, nbc, lm, rm = (np.ascontiguousarray(x) for x in cols)
    log = logging.getLogger("supernova_tpu")
    log.info("blocked count: host adjacency recompute — rss=%.1f GB", _rss_gb())
    lm2, rm2 = recompute_adjacencies_host(wa, wb, wc, lm, rm)
    n = len(wa)
    m = geom_bucket(max(n, 1), pad_multiple)

    def pad(x, fill, dt):
        buf = np.full(m, fill, dt)
        buf[:n] = x
        return buf

    log.info("blocked count: finalized %d kmers — rss=%.1f GB", n, _rss_gb())
    return KmerTable(
        W3(
            pad(wa, kc.SENTINEL, np.uint32),
            pad(wb, kc.SENTINEL, np.uint32),
            pad(wc, kc.SENTINEL, np.uint32),
        ),
        pad(cnt, 0, np.int32),
        pad(nbc, 0, np.int32),
        pad(lm2, 0, np.uint32),
        pad(rm2, 0, np.uint32),
        np.int32(n),
    )


# ------------------------------------------------------- blocked counting

class RawBlockTable(NamedTuple):
    """Per-block UNFILTERED reduced table: one row per distinct canonical
    kmer of the block, stats packed as nbc(12b)|lm(4b)|rm(4b)|has_ign(1b)
    (the run_reduce stats word).  Blocks are split at barcode boundaries so
    per-block nbc values sum exactly across blocks."""

    words: W3
    count: jax.Array  # (M,) int32
    stats: jax.Array  # (M,) uint32
    n_valid: jax.Array


def _reduce_occurrences_raw(canon: W3, bc, lm, rm, valid) -> RawBlockTable:
    """Sort + segment-reduce WITHOUT the (min_freq, min_bc) filter."""
    nb = canon.a.shape[0]
    ws, pk = sort_occurrences(canon, bc, lm, rm, valid)
    ends, count, nbc, ign, lmask_u, rmask_u = run_stats(ws, pk)
    stats = (
        (jnp.minimum(nbc, 4095).astype(U32) << np.uint32(9))
        | (lmask_u << np.uint32(5))
        | (rmask_u << np.uint32(1))
        | ign.astype(U32)
    )
    keep = ends & ~kc.is_sentinel(ws) & (count >= 1)
    n_valid, (wa, wb, wc, c2, st2) = seg.stable_compact(
        keep, ws.a, ws.b, ws.c, count, stats
    )
    m = jnp.arange(nb) < n_valid
    w2 = W3(wa, wb, wc).where(m, kc.SENTINEL)
    return RawBlockTable(w2, c2 * m, st2 * m.astype(U32), n_valid)


@partial(jax.jit, static_argnames=("min_read_len", "uniform_rl"))
def count_block_raw(
    codes_ext, pos_read, glen_pos, bc_pos,
    min_read_len: int = K + 1, uniform_rl: int | None = None,
) -> RawBlockTable:
    """One block of the blocked count: extract + reduce, no filter."""
    canon, bc, lm, rm, valid = extract_occurrences(
        codes_ext, pos_read, glen_pos, bc_pos, min_read_len
    )
    if uniform_rl is not None:
        canon, bc, lm, rm, valid = cut_occurrence_tails(
            uniform_rl, canon, bc, lm, rm, valid
        )
    return _reduce_occurrences_raw(canon, bc, lm, rm, valid)


def _unpack_codes_dev(packed, nbp: int, ext: int):
    """Device-side 2-bit unpack (inverse of feudal.pack_codes), gather-free:
    (nbp//4,) uint8 -> (nbp + ext,) int32 with a zero tail."""
    x = packed.reshape(-1, 32).astype(jnp.int32)  # (rows, 32 bytes)
    x = jnp.broadcast_to(x[:, :, None], (*x.shape, 4))  # (rows, 32, 4)
    sh = (jnp.arange(4, dtype=jnp.int32) * 2)[None, None, :]
    codes = ((x >> sh) & 3).reshape(-1)[:nbp]
    return jnp.concatenate([codes, jnp.zeros((ext,), jnp.int32)])


def prepare_reads_packed(rs, pad_to_positions: int | None = None):
    """Compact host prep for one uniform-length block: 2-bit packed codes +
    per-READ attributes; the per-POSITION arrays are rebuilt on device by
    count_block_raw_packed.

    Shrinks the host->device transfer ~80x (27 MB vs 2.3 GB per 96M-position
    block), and keeps the per-position arrays out of the block ReadSet's
    prep cache, so device memory does not grow with the block count.
    Returns None for non-uniform reads (callers fall back to
    prepare_reads)."""
    key = ("packed", pad_to_positions)
    cached = getattr(rs, "_prep_cache_packed", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    n_reads = rs.n_reads
    lens_all = np.diff(rs.offsets)
    if n_reads == 0 or not (lens_all == lens_all[0]).all() or lens_all[0] <= K:
        return None
    rl = int(lens_all[0])
    nb = int(rs.offsets[-1])
    nbp = _round_up(max(nb, 1, pad_to_positions or 1), rl * 128)
    grid = nbp // rl
    from ..ingest.feudal import pack_codes

    codes = np.zeros(nbp, np.uint8)
    codes[:nb] = rs.codes
    glen = np.zeros(grid, np.int32)
    glen[:n_reads] = good_lengths_np(rs.quals, rs.offsets)
    read_bc = np.full(grid, BC_IGNORED, np.int32)
    if rs.barcoded:
        read_bc[:n_reads] = np.where(rs.bc > 0, rs.bc, BC_IGNORED)
    out = dict(
        codes_packed=pack_codes(codes),
        glen=glen,
        read_bc=read_bc,
        n_reads=n_reads,
        uniform_rl=rl,
        nbp=nbp,
    )
    try:
        rs._prep_cache_packed = (key, out)
    except Exception:
        pass
    return out


@partial(jax.jit, static_argnames=("min_read_len", "uniform_rl", "nbp"))
def count_block_raw_packed(
    codes_packed, glen_r, bc_r, n_reads,
    min_read_len: int = K + 1, uniform_rl: int = 150, nbp: int = 0,
) -> RawBlockTable:
    """count_block_raw from compact inputs: expands the per-position arrays
    on device (broadcasts, no gathers), bit-identical to the host-expanded
    path (same pos_read/glen_pos/bc_pos values by construction)."""
    rl = uniform_rl
    grid = nbp // rl
    codes_ext = _unpack_codes_dev(codes_packed, nbp, max(K, 128))
    pos = jnp.arange(nbp, dtype=jnp.int32) // rl
    pos_read = jnp.minimum(pos, n_reads.astype(jnp.int32))
    glen_pos = jnp.broadcast_to(glen_r[:, None], (grid, rl)).reshape(-1)
    bc_pos = jnp.broadcast_to(bc_r[:, None], (grid, rl)).reshape(-1)
    canon, bc, lm, rm, valid = extract_occurrences(
        codes_ext, pos_read, glen_pos, bc_pos, min_read_len
    )
    return _reduce_occurrences_raw(
        *cut_occurrence_tails(rl, canon, bc, lm, rm, valid)
    )


# host-side partition merge by default: block tables are host-resident and
# the device round trip is transfer-bound (see merge_block_tables)
MERGE_ON_HOST = True


def _merge_partition_host(wa, wb, wc, count, stats, min_freq: int,
                          min_bc: int):
    """Numpy twin of merge_raw_blocks for one kmer-disjoint partition:
    same per-kmer semantics (count=sum, nbc=clamped sum, masks=OR,
    has_ign=OR, then the reference (min_freq, min_bc) filter).  Returns
    the 7 kept host columns sorted lexicographically."""
    order = np.lexsort((wc, wb, wa))
    a, b, c = wa[order], wb[order], wc[order]
    cnt = count[order].astype(np.int64)
    st = stats[order]
    n = len(a)
    if n == 0:
        z = np.zeros(0, np.uint32)
        return (z, z, z, z.astype(np.int32), z.astype(np.int32), z, z)
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1]) | (c[1:] != c[:-1])
    starts = np.flatnonzero(new)
    total = np.add.reduceat(cnt, starts)
    nbc = np.minimum(
        np.add.reduceat(((st >> np.uint32(9)) & np.uint32(4095)).astype(np.int64), starts),
        4095,
    )
    ign = np.bitwise_or.reduceat((st & np.uint32(1)).astype(np.uint32), starts) > 0
    lm = np.bitwise_or.reduceat(((st >> np.uint32(5)) & np.uint32(15)).astype(np.uint32), starts)
    rm = np.bitwise_or.reduceat(((st >> np.uint32(1)) & np.uint32(15)).astype(np.uint32), starts)
    keep = (total >= min_freq) & (ign | (nbc >= min_bc))
    ks = starts[keep]
    return (
        a[ks], b[ks], c[ks],
        total[keep].astype(np.int32), nbc[keep].astype(np.int32),
        lm[keep], rm[keep],
    )


@partial(jax.jit, static_argnames=("min_freq", "min_bc"))
def merge_raw_blocks(wa, wb, wc, count, stats, min_freq: int, min_bc: int
                     ) -> KmerTable:
    """Concat of per-block raw rows -> final filtered KmerTable.

    Blocks are barcode-disjoint, so per-kmer: count=sum, nbc=sum,
    masks=OR, has_ign=OR; then the reference filter applies."""
    n = wa.shape[0]
    ws = W3(wa, wb, wc)
    o = jax.lax.sort((wa, wb, wc, count, stats), num_keys=3, is_stable=False)
    ws = W3(o[0], o[1], o[2])
    count, stats = o[3], o[4]
    starts = seg.run_starts(ws.a, ws.b, ws.c)
    ends = seg.run_end_mask(starts)
    p = jnp.arange(n, dtype=jnp.int32)
    run_start_pos = jax.lax.cummax(jnp.where(starts, p, 0))

    def run_total(vals):
        cs = jnp.cumsum(vals.astype(jnp.int32))
        base = seg.run_broadcast_from_start(cs - vals.astype(jnp.int32), starts)
        return cs - base

    def run_any(ind):
        last = jax.lax.cummax(jnp.where(ind, p, -1))
        return last >= run_start_pos

    total = run_total(count)
    # per-block nbc values are clamped to 4095 (the stats field width);
    # clamping the merged sum reproduces the single-program clamp exactly:
    # if no block clamped, sum == true total (then clamped identically);
    # if any block clamped, both paths saturate at 4095
    nbc = jnp.minimum(
        run_total((stats >> np.uint32(9)) & np.uint32(4095)), 4095
    )
    ign = run_any((stats & np.uint32(1)) == 1)
    lm = jnp.zeros((n,), U32)
    rm = jnp.zeros((n,), U32)
    for b in range(4):
        lb = run_any(((stats >> np.uint32(5 + b)) & 1) == 1)
        rb = run_any(((stats >> np.uint32(1 + b)) & 1) == 1)
        lm = lm | (lb.astype(U32) << b)
        rm = rm | (rb.astype(U32) << b)
    keep = (
        ends & ~kc.is_sentinel(ws) & (total >= min_freq)
        & (ign | (nbc >= min_bc))
    )
    n_valid, (a2, b2, c2, t2, n2, l2, r2) = seg.stable_compact(
        keep, ws.a, ws.b, ws.c, total, nbc, lm, rm
    )
    m = jnp.arange(n) < n_valid
    w2 = W3(a2, b2, c2).where(m, kc.SENTINEL)
    return KmerTable(
        w2, t2 * m, n2 * m, l2 * m.astype(U32), r2 * m.astype(U32), n_valid
    )


# positions per device block for the blocked count: each block's post-cut
# sort must fit device memory alongside its buffers (~4 ops x rows x 4 B
# x ~2) AND the next block's staged inputs (host-prep/device-compute
# overlap).  Sized for a 16 GB device; not yet re-sized for the H100's
# 80 GB (PERF.md gives the measured peak of one block).  count_readset
# halves the block size and retries on a device ResourceExhausted, so
# this is a starting point, not a hard ceiling.
BLOCK_POSITIONS = 96_000_000
MIN_BLOCK_POSITIONS = 24_000_000


def _is_oom(e: Exception) -> bool:
    return "RESOURCE_EXHAUSTED" in str(e) or "ResourceExhausted" in str(e)


def _free_failed_attempt(e: Exception) -> None:
    """Release the failed attempt's device buffers before retrying.

    The exception's traceback pins the raising frames (traceback <-> frame
    reference cycles), and those frames hold the attempt's device arrays —
    without clearing + a gc pass, a halved retry allocates ON TOP of the
    dead attempt's device memory and runs out at once (96M -> 48M -> 24M
    all failing within seconds)."""
    import gc

    # clear the WHOLE exception chain — __context__/__cause__ carry their
    # own tracebacks whose frames also pin device arrays
    seen = set()
    x: BaseException | None = e
    while x is not None and id(x) not in seen:
        seen.add(id(x))
        x.__traceback__ = None
        nxt = x.__cause__ or x.__context__
        x = nxt
    gc.collect()


def _hbm_in_use() -> str:
    """Device memory stats one-liner for OOM forensics ('' if unavailable)."""
    try:
        import jax

        st = jax.local_devices()[0].memory_stats()
        if not st:
            return ""
        gib = 1 << 30
        return (
            f"HBM {st.get('bytes_in_use', 0) / gib:.2f} GiB in use / "
            f"{st.get('bytes_limit', 0) / gib:.2f} limit, "
            f"peak {st.get('peak_bytes_in_use', 0) / gib:.2f}"
        )
    except Exception:
        return ""


def split_readset_blocks(rs, max_positions: int):
    """Split a barcode-sorted ReadSet into blocks at barcode boundaries
    (and pair boundaries for the unbarcoded prefix), each <= max_positions
    flat bases — so no barcode spans two blocks and per-block nbc values
    sum exactly.  Returns a list of ReadSets (views)."""
    from ..ingest.reads import ReadSet

    nb = int(rs.offsets[-1])
    if nb <= max_positions:
        return [rs]
    cached = getattr(rs, "_block_cache", None)
    if cached is not None and cached[0] == max_positions:
        return cached[1]
    # candidate cut points (read indices): barcode starts from bci; the
    # unbarcoded block [bci[0], bci[1]) may be cut at any pair boundary
    cuts = set(int(x) for x in rs.bci[1:-1])
    for r in range(0, int(rs.bci[1]) + 1, 2):
        cuts.add(r)
    cuts.add(rs.n_reads)
    cuts = sorted(c for c in cuts if 0 < c <= rs.n_reads)
    blocks = []
    start = 0
    prev = 0
    for c in cuts:
        if int(rs.offsets[c] - rs.offsets[start]) > max_positions and prev > start:
            blocks.append((start, prev))
            start = prev
        prev = c
    blocks.append((start, rs.n_reads))

    out = []
    for lo, hi in blocks:
        o0, o1 = int(rs.offsets[lo]), int(rs.offsets[hi])
        # barcode ids stay global; only the read ranges are re-based
        bci = np.clip(rs.bci - lo, 0, hi - lo)
        out.append(
            ReadSet(
                codes=rs.codes[o0:o1],
                offsets=(rs.offsets[lo : hi + 1] - o0),
                quals=rs.quals[o0:o1],
                bc=rs.bc[lo:hi],
                bci=bci,
                barcoded=rs.barcoded,
            )
        )
    try:  # reuse the same block views (and their prep caches) across stages
        rs._block_cache = (max_positions, out)
    except Exception:
        pass
    return out


def count_readset_blocked(
    rs, min_freq: int | None = None, min_bc: int | None = None,
    min_read_len: int = K + 1, max_positions: int = BLOCK_POSITIONS,
    spill_dir: str | None = None,
) -> KmerTable:
    """Blocked count for readsets whose occurrence arrays exceed HBM:
    per-block unfiltered reduced tables (distinct-kmer scale), one device
    merge + filter.  Bit-identical to the single-program count.
    min_freq/min_bc=None read MIN_FREQ/MIN_BC at call time (--addin).

    spill_dir: when given, block results spill THERE with per-block done
    markers and a meta guard — a killed run resumes at block granularity
    instead of recounting everything (the 100 Mb rung lost 2x ~75-minute
    block phases to OOM kills before this).  The caller owns cleanup."""
    from ..dbg.build import trim_table

    if min_freq is None:
        min_freq = MIN_FREQ
    if min_bc is None:
        min_bc = MIN_BC
    blocks = split_readset_blocks(rs, max_positions)
    # all blocks share one compiled shape (pad to the largest block)
    pad_pos = max(int(b.offsets[-1]) for b in blocks)
    pad_rd = max(b.n_reads for b in blocks)
    log = logging.getLogger("supernova_tpu")
    log.info(
        "blocked count: %d blocks at <=%d positions (pad %d) — %s",
        len(blocks), max_positions, pad_pos, _hbm_in_use(),
    )
    was, wbs, wcs, cnts, sts = [], [], [], [], []

    def dispatch_packed(p):
        return count_block_raw_packed(
            jnp.asarray(p["codes_packed"]), jnp.asarray(p["glen"]),
            jnp.asarray(p["read_bc"]), jnp.asarray(np.int32(p["n_reads"])),
            min_read_len=min_read_len, uniform_rl=p["uniform_rl"],
            nbp=p["nbp"],
        )

    def dispatch_full(p):
        return count_block_raw(
            p["codes_ext"], p["pos_read"], p["glen_pos"], p["bc_pos"],
            min_read_len=min_read_len, uniform_rl=p["uniform_rl"],
        )

    # compact transfers (2-bit codes + per-read attrs, expanded on device)
    # whenever reads are uniform-length; the full per-position path moves
    # ~80x the bytes per block and is the fallback only.  Uniformity is
    # decided on the PARENT readset: a uniform first block does not imply
    # uniform later blocks.
    lens_all = np.diff(rs.offsets)
    packed = (
        rs.n_reads > 0
        and bool((lens_all == lens_all[0]).all())
        and int(lens_all[0]) > K
    )
    prep = (
        (lambda b: prepare_reads_packed(b, pad_to_positions=pad_pos))
        if packed
        else (
            lambda b: prepare_reads(
                b, pad_to_positions=pad_pos, pad_to_reads=pad_rd
            )
        )
    )
    dispatch = dispatch_packed if packed else dispatch_full
    # Spill block results to disk and memory-map them for the merge: at
    # 100 Mb the 50 blocks hold ~2.5G raw rows (~50 GB) and keeping them
    # host-resident OOM-killed the run at the merge endgame (130 GB RSS).
    # Small runs pay trivial I/O; the OS page cache keeps hot slices warm.
    import json as _json
    import shutil
    import tempfile

    persistent = spill_dir is not None
    if persistent:
        meta = {
            "n_blocks": len(blocks), "pad_pos": pad_pos, "pad_rd": pad_rd,
            "n_reads": int(rs.n_reads), "min_freq": int(min_freq),
            "min_bc": int(min_bc), "packed": bool(packed),
        }
        meta_path = os.path.join(spill_dir, "meta.json")
        os.makedirs(spill_dir, exist_ok=True)
        stale = True
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    stale = _json.load(f) != meta
            except Exception:
                stale = True
        if stale:
            shutil.rmtree(spill_dir, ignore_errors=True)
            os.makedirs(spill_dir, exist_ok=True)
            with open(meta_path, "w") as f:
                _json.dump(meta, f)
    else:
        spill_dir = tempfile.mkdtemp(prefix="snb_spill_")

    def _bpath(i, j):
        return os.path.join(spill_dir, f"b{i}_{j}.npy")

    def _ok(i):
        return os.path.join(spill_dir, f"b{i}.ok")

    def _spill(i, j, arr):
        np.save(_bpath(i, j), arr)
        return np.load(_bpath(i, j), mmap_mode="r")

    slots: dict = {}
    pending = []
    for i in range(len(blocks)):
        if persistent and os.path.exists(_ok(i)):
            slots[i] = tuple(
                np.load(_bpath(i, j), mmap_mode="r") for j in range(5)
            )
        else:
            pending.append(i)
    if len(pending) < len(blocks):
        log.info(
            "blocked count: resume — %d/%d blocks already spilled",
            len(blocks) - len(pending), len(blocks),
        )
    if pending:
        inp = prep(blocks[pending[0]])
        for k, i in enumerate(pending):
            raw = dispatch(inp)  # async dispatch
            if k + 1 < len(pending):
                # overlap the next block's host prep with this device program
                inp = prep(blocks[pending[k + 1]])
            nv = int(raw.n_valid)  # sync point
            # slice on DEVICE before pulling: the padded arrays are ~2.5x the
            # kept rows and the device->host link is the per-block bottleneck.
            # Bucket the slice length so the tiny slice programs get reused
            # across blocks (one compile per distinct shape).
            nv_b = min(_round_up(max(nv, 1), 4 << 20), raw.words.a.shape[0])
            slots[i] = (
                _spill(i, 0, np.asarray(raw.words.a[:nv_b])[:nv]),
                _spill(i, 1, np.asarray(raw.words.b[:nv_b])[:nv]),
                _spill(i, 2, np.asarray(raw.words.c[:nv_b])[:nv]),
                _spill(i, 3, np.asarray(raw.count[:nv_b])[:nv]),
                _spill(i, 4, np.asarray(raw.stats[:nv_b])[:nv]),
            )
            if persistent:
                with open(_ok(i), "w") as f:
                    f.write(str(nv))
            log.info(
                "blocked count: block %d/%d -> %d rows — rss=%.1f GB",
                i + 1, len(blocks), nv, _rss_gb(),
            )
        del raw, inp  # drop the last block's device buffers before the merge
    for i in range(len(blocks)):
        wa_, wb_, wc_, cn_, st_ = slots[i]
        was.append(wa_); wbs.append(wb_); wcs.append(wc_)
        cnts.append(cn_); sts.append(st_)
    del slots
    tot = sum(len(x) for x in was)
    log.info(
        "blocked count: merging %d raw rows (%s) — %s, rss=%.1f GB",
        tot, "one-shot" if tot <= MERGE_ROWS else "partitioned",
        _hbm_in_use(), _rss_gb(),
    )
    try:
        if tot <= MERGE_ROWS:
            m = _round_up(tot, 8192)

            def cat(parts, fill, dt):
                out = np.full(m, fill, dt)
                out[:tot] = np.concatenate(parts)
                return jnp.asarray(out)

            table = merge_raw_blocks(
                cat(was, kc.SENTINEL, np.uint32),
                cat(wbs, kc.SENTINEL, np.uint32),
                cat(wcs, kc.SENTINEL, np.uint32),
                cat(cnts, 0, np.int32),
                cat(sts, 0, np.uint32),
                min_freq=min_freq,
                min_bc=min_bc,
            )
            return recompute_adjacencies(trim_table(table))
        # Partitioned path: host columns all the way out.  The old endgame
        # built a ~100M-row device table and ran the one-program jit
        # adjacency recompute over it — 130 GB anon RSS on the CPU backend
        # (all 8 sort-merge lookups' intermediates live at once).
        cols = _merge_blocks_partitioned(
            was, wbs, wcs, cnts, sts, min_freq, min_bc
        )
        return _finalize_table_host(cols)
    finally:
        del was, wbs, wcs, cnts, sts  # release the mmap handles
        if not persistent:
            shutil.rmtree(spill_dir, ignore_errors=True)


# Rows per merge partition: the merge sorts 5 arrays of this many rows
# (~20 B/row in+out plus sort workspace), so bounding partitions at 48M
# rows caps the merge at the scale of one count block's sort regardless of
# how many raw rows the blocks produced — the 10 Mb full-coverage run
# produced hundreds of M raw rows and ran out of device memory in a
# one-shot merge.
MERGE_ROWS = 48_000_000

_MERGE_STATE: dict = {}


def _merge_part_worker(pi: int):
    was, wbs, wcs, cnts, sts, pb, mf, mb = (
        _MERGE_STATE[k] for k in (
            "was", "wbs", "wcs", "cnts", "sts", "pb", "mf", "mb"
        )
    )
    hi_word, lo, hi, _n = pb[pi]

    def cath(parts, dt):
        return np.concatenate(
            [p[l:h] for p, l, h in zip(parts, lo, hi)]
        ).astype(dt, copy=False)

    cols = _merge_partition_host(
        cath(was, np.uint32), cath(wbs, np.uint32), cath(wcs, np.uint32),
        cath(cnts, np.int32), cath(sts, np.uint32), mf, mb,
    )
    return pi, cols


def _merge_partitions_host_parallel(
    was, wbs, wcs, cnts, sts, part_bounds, min_freq: int, min_bc: int
):
    """Host partitions are independent (kmer-disjoint ranges), so run them
    in forked numpy workers — partitions dominated the 100 Mb count wall
    at ~35 s each x 68 serial (np.lexsort is single-threaded).  Fork-pool
    hangs are bounded per-partition with a serial fallback (the
    evaluate-pool pattern, ADVICE r4 #4)."""
    if not part_bounds:
        return None
    import multiprocessing as mp

    log = logging.getLogger("supernova_tpu")
    n_parts = len(part_bounds)
    results: list = [None] * n_parts

    def run_serial(idxs):
        for pi in idxs:
            _, cols = _merge_part_worker(pi)
            results[pi] = cols
            log.info(
                "blocked count: merge partition <%d: %d rows -> %d kept",
                part_bounds[pi][0], part_bounds[pi][3], len(cols[0]),
            )

    workers = min(
        int(os.environ.get("SN_MERGE_WORKERS", "6")),
        os.cpu_count() or 1, n_parts,
    )
    _MERGE_STATE.update(
        was=was, wbs=wbs, wcs=wcs, cnts=cnts, sts=sts,
        pb=part_bounds, mf=min_freq, mb=min_bc,
    )
    try:
        if workers > 1 and n_parts > 2:
            try:
                ctx = mp.get_context("fork")
                with ctx.Pool(workers) as pool:
                    it = pool.imap_unordered(_merge_part_worker, range(n_parts))
                    for _ in range(n_parts):
                        pi, cols = it.next(timeout=900)
                        results[pi] = cols
                        log.info(
                            "blocked count: merge partition <%d: %d rows -> "
                            "%d kept (parallel) — rss=%.1f GB",
                            part_bounds[pi][0], part_bounds[pi][3],
                            len(cols[0]), _rss_gb(),
                        )
            except Exception as e:  # noqa: BLE001 — pool wedge/failure
                log.warning(
                    "blocked count: parallel merge fell back to serial "
                    "(%.80s)", repr(e),
                )
                run_serial([i for i, r in enumerate(results) if r is None])
        else:
            run_serial(range(n_parts))
    finally:
        _MERGE_STATE.clear()
    return [
        [results[i][c] for i in range(n_parts)] for c in range(7)
    ]


def _merge_blocks_partitioned(
    was, wbs, wcs, cnts, sts, min_freq: int, min_bc: int
):
    """Bounded-memory merge of per-block raw tables -> 7 host columns
    (wa, wb, wc, count, nbc, left_mask, right_mask), kept rows only.

    Each block's rows are already sorted by (a, b, c), so the kmer space is
    range-partitioned on the leading word `a`: splitters are data quantiles
    sampled from the blocks, every block contributes its [lo, hi) slice per
    partition (searchsorted on its sorted `a` column), and each partition
    runs the one compiled `merge_raw_blocks` shape.  Rows of one kmer share
    `a`, so partitions are kmer-disjoint and the global (min_freq, min_bc)
    filter applied per partition is exact; partitions are ascending ranges,
    so concatenating their outputs keeps the table sorted."""
    tot = sum(len(x) for x in was)
    n_parts = max(2, -(-tot // int(MERGE_ROWS * 0.75)))
    # The raw rows live on the HOST (block results are fetched as they
    # complete); pushing every partition through the device costs a
    # row-proportional host->device round trip.  The numpy path
    # reproduces merge_raw_blocks' semantics exactly and is the default;
    # flip MERGE_ON_HOST off to use the device program (which is faster
    # on the H100 is not measured yet).
    # splitters: quantiles of a global sample of the leading words
    sample = np.concatenate([a[:: max(1, len(a) // 65536)] for a in was])
    sample.sort()
    qs = sample[
        (np.arange(1, n_parts) * (len(sample) / n_parts)).astype(np.int64)
    ]
    qs = np.unique(qs)  # degenerate quantiles merge partitions
    # final bound must exceed every uint32 word (a real kmer's leading word
    # may be 0xFFFFFFFF), so bounds are uint64
    bounds = np.concatenate([qs.astype(np.uint64), [np.uint64(2**32)]])

    # per-partition block slice bounds, computed up front (cheap
    # searchsorted) so host partitions can run in parallel workers
    part_bounds = []
    lo = [0] * len(was)
    shape_rows = _round_up(min(tot, MERGE_ROWS), 8192)
    for hi_word in bounds:
        hi = [
            int(np.searchsorted(a, hi_word, side="left")) for a in was
        ]
        n = sum(h - l for h, l in zip(hi, lo))
        if n:
            part_bounds.append((int(hi_word), list(lo), hi, n))
        lo = hi

    if MERGE_ON_HOST:
        out_parts = _merge_partitions_host_parallel(
            was, wbs, wcs, cnts, sts, part_bounds, min_freq, min_bc
        )
    else:
        out_parts = None

    for hi_word, lo, hi, n in (part_bounds if not MERGE_ON_HOST else ()):
        if n > shape_rows:
            # skew overflow (one `a` value dominating): widen this one
            # partition; the recompile is rare and correctness holds
            rows = _round_up(n, 8192)
        else:
            rows = shape_rows

        def cat(parts, fill, dt):
            buf = np.full(rows, fill, dt)
            k = 0
            for p, l, h in zip(parts, lo, hi):
                buf[k : k + h - l] = p[l:h]
                k += h - l
            return jnp.asarray(buf)

        t = merge_raw_blocks(
            cat(was, kc.SENTINEL, np.uint32),
            cat(wbs, kc.SENTINEL, np.uint32),
            cat(wcs, kc.SENTINEL, np.uint32),
            cat(cnts, 0, np.int32),
            cat(sts, 0, np.uint32),
            min_freq=min_freq,
            min_bc=min_bc,
        )
        nv = int(t.n_valid)  # sync; then fetch the filtered partition
        cols = (
            np.asarray(t.words.a)[:nv], np.asarray(t.words.b)[:nv],
            np.asarray(t.words.c)[:nv], np.asarray(t.count)[:nv],
            np.asarray(t.nbc)[:nv], np.asarray(t.left_mask)[:nv],
            np.asarray(t.right_mask)[:nv],
        )
        del t  # free this partition's device table before the next
        logging.getLogger("supernova_tpu").info(
            "blocked count: merge partition <%d: %d rows -> %d kept",
            int(hi_word), n, nv,
        )
        out_parts = (
            [[c] for c in cols]
            if out_parts is None
            else [acc + [c] for acc, c in zip(out_parts, cols)]
        )

    if out_parts is None:
        z = np.zeros(0, np.uint32)
        return (
            z, z.copy(), z.copy(),
            np.zeros(0, np.int32), np.zeros(0, np.int32), z.copy(), z.copy(),
        )
    dts = (
        np.uint32, np.uint32, np.uint32,
        np.int32, np.int32, np.uint32, np.uint32,
    )
    return tuple(
        np.concatenate(p).astype(dt, copy=False)
        for p, dt in zip(out_parts, dts)
    )


# ----------------------------------------------------------------- host prep

def good_lengths_np(quals: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Host (numpy) qual-trim rule — same semantics as good_lengths.

    The good length of a read is the largest prefix whose last K bases are
    all >= MIN_QUAL.  Sparse formulation: only BAD positions matter (rare),
    so work is O(n_reads + n_bad), not O(total bases).  Between consecutive
    bad positions (plus a virtual bad before each read start and the read
    end as a bound), a clean segment of length >= K ending at `nxt` gives
    candidate glen = nxt - start; the max such candidate is the LAST one,
    found per read with np.maximum.reduceat over the read's segments."""
    nb = len(quals)
    n_reads = len(offsets) - 1
    offsets = np.asarray(offsets, np.int64)
    if nb == 0 or n_reads == 0:
        return np.zeros(n_reads, dtype=np.int32)
    badpos = np.flatnonzero(np.asarray(quals) < MIN_QUAL)
    starts = offsets[:-1]
    # per-entry rows: virtual bad at start-1 for every read + real bads
    vb = starts - 1
    allb = np.concatenate([vb, badpos])
    rid = np.concatenate(
        [
            np.arange(n_reads, dtype=np.int64),
            np.searchsorted(offsets, badpos, side="right") - 1,
        ]
    )
    order = np.lexsort((allb, rid))
    allb = allb[order]
    rid = rid[order]
    ends = offsets[1:]
    nxt = np.concatenate([allb[1:], [0]])
    last_of_read = np.r_[rid[1:] != rid[:-1], True]
    nxt = np.where(last_of_read, ends[rid], nxt)
    seg_len = nxt - allb - 1  # clean run between this bad and the next
    cand = np.where(seg_len >= K, nxt - starts[rid], 0)
    first_of_read = np.r_[True, rid[1:] != rid[:-1]]
    # reads are contiguous in (rid-sorted) rows; every read has >= 1 row
    out = np.maximum.reduceat(cand, np.flatnonzero(first_of_read))
    return out.astype(np.int32)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def prepare_reads(rs, base_bucket: int = 16384, read_bucket: int = 1024,
                  pad_to_positions: int | None = None,
                  pad_to_reads: int | None = None) -> dict:
    """Host-side packing of a ReadSet into static-shape device inputs.

    Shapes are rounded up to buckets so different inputs share compiled
    programs; padding positions belong to a fake empty read (good_len 0).

    When every read has the same length, the dict carries `uniform_rl` and
    the base padding is a multiple of rl*128, enabling count_kmers' static
    tail cut (~30% less device work at rl=150).

    pad_to_positions/pad_to_reads force minimum padded sizes so sibling
    blocks of a blocked count share one compiled program shape.
    """
    key = (base_bucket, read_bucket, pad_to_positions, pad_to_reads,
           rs.barcoded)
    cached = getattr(rs, "_prep_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    nb = int(rs.offsets[-1])
    n_reads = rs.n_reads
    lens_all = np.diff(rs.offsets)
    uniform_rl = (
        int(lens_all[0])
        if n_reads > 0 and (lens_all == lens_all[0]).all() and lens_all[0] > K
        else None
    )
    if uniform_rl is not None:
        base_bucket = uniform_rl * 128
    nbp = _round_up(max(nb, 1, pad_to_positions or 1), base_bucket)
    rp = _round_up(max(n_reads, pad_to_reads or 0) + 1, read_bucket)

    codes_ext = np.zeros(nbp + max(K, 128), dtype=np.int32)
    codes_ext[:nb] = rs.codes
    lens = np.diff(rs.offsets).astype(np.int64)
    pos_read = np.full(nbp, n_reads, dtype=np.int32)
    pos_read[:nb] = np.repeat(np.arange(n_reads, dtype=np.int32), lens)
    offsets = np.full(rp + 1, nb, dtype=np.int32)
    offsets[: n_reads + 1] = rs.offsets
    read_bc = np.full(rp, BC_IGNORED, dtype=np.int32)
    if rs.barcoded:
        read_bc[:n_reads] = np.where(rs.bc > 0, rs.bc, BC_IGNORED)
    glen = good_lengths_np(rs.quals, rs.offsets)
    glen_pos = np.zeros(nbp, dtype=np.int32)
    glen_pos[:nb] = np.repeat(glen, lens)
    bc_pos = np.full(nbp, BC_IGNORED, dtype=np.int32)
    bc_pos[:nb] = np.repeat(read_bc[:n_reads], lens)
    rlen_pos = np.zeros(nbp, dtype=np.int32)
    rlen_pos[:nb] = np.repeat(lens.astype(np.int32), lens)
    out = dict(
        codes_ext=jnp.asarray(codes_ext),
        read_offsets=jnp.asarray(offsets),
        pos_read=jnp.asarray(pos_read),
        glen_pos=jnp.asarray(glen_pos),
        bc_pos=jnp.asarray(bc_pos),
        rlen_pos=jnp.asarray(rlen_pos),
        read_bc=jnp.asarray(read_bc),
        uniform_rl=uniform_rl,
    )
    try:  # ReadSets are immutable after ingest; reuse across count/path
        rs._prep_cache = (key, out)
    except Exception:
        pass
    return out


def estimate_coverage(table: KmerTable, read_len: float = 150.0):
    """Kmer-spectrum coverage estimate: the main peak of the multiplicity
    spectrum (past the error slope) is the kmer coverage; read coverage and
    genome size follow (the reference alarms on coverage <15 / >90,
    alarms-supernova.json:5-15, estimated the same way).
    -> (read_cov, genome_size_est) or (None, None) if no clear peak."""
    import numpy as np

    n = int(table.n_valid)
    if n == 0:
        return None, None
    counts = np.asarray(table.count)[:n]
    # homozygous canonical kmers dominate the table, so the median count is
    # a robust kmer-coverage estimate (multi-modal peak finding is fragile
    # on linked-read molecule-coverage spectra)
    kmer_cov = float(np.median(counts))
    if kmer_cov <= 0:
        return None, None
    from ..core.kmer_codec import K

    # raw coverage in the 10x convention: total bases / haploid genome size
    read_cov = kmer_cov * read_len / max(read_len - K + 1, 1.0)
    genome_est = int(counts.sum() / kmer_cov)
    return read_cov, genome_est


def count_readset(
    rs, min_freq: int | None = None, min_bc: int | None = None,
    min_read_len: int = K + 1, spill_dir: str | None = None,
) -> KmerTable:
    """End-to-end host entry: ReadSet -> filtered, adjacency-true KmerTable.

    The table is trimmed from occurrence-padded size down to ~n_valid BEFORE
    the adjacency recompute — its 8 membership joins then run (and compile)
    at distinct-kmer scale, not occurrence scale.  Readsets whose occurrence
    arrays would exceed HBM go through the blocked path (bit-identical).
    min_freq/min_bc=None read MIN_FREQ/MIN_BC at call time (--addin)."""
    from ..dbg.build import trim_table

    if min_freq is None:
        min_freq = MIN_FREQ
    if min_bc is None:
        min_bc = MIN_BC
    if int(rs.offsets[-1]) > BLOCK_POSITIONS:
        # self-healing block size: halve and retry on device OOM (the
        # runtime may surface it as RESOURCE_EXHAUSTED on the next fetch)
        max_pos = BLOCK_POSITIONS
        while True:
            try:
                return count_readset_blocked(
                    rs, min_freq=min_freq, min_bc=min_bc,
                    min_read_len=min_read_len, max_positions=max_pos,
                    spill_dir=spill_dir,
                )
            except Exception as e:  # noqa: BLE001 — OOM-retry boundary
                if not _is_oom(e) or max_pos // 2 < MIN_BLOCK_POSITIONS:
                    raise
                max_pos //= 2
                import logging

                import traceback as _tb

                frames = _tb.extract_tb(e.__traceback__)
                site = (
                    f"{frames[-1].filename.rsplit('/', 1)[-1]}:"
                    f"{frames[-1].lineno} in {frames[-1].name}"
                    if frames
                    else "?"
                )
                logging.getLogger("supernova_tpu").warning(
                    "count: device OOM at block=%d positions (at %s; %s; "
                    "%.120s); retrying with block=%d",
                    max_pos * 2, site, _hbm_in_use(), str(e), max_pos,
                )
                _free_failed_attempt(e)
    inp = prepare_reads(rs)
    table = count_kmers(
        inp["codes_ext"],
        inp["pos_read"],
        inp["glen_pos"],
        inp["bc_pos"],
        min_freq=min_freq,
        min_bc=min_bc,
        min_read_len=min_read_len,
        uniform_rl=inp["uniform_rl"],
    )
    return recompute_adjacencies(trim_table(table))
