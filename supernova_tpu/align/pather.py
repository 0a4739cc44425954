"""Read-to-graph pathing: every read becomes (offset, [edge ids]) on the
unipath graph — the ReadPath/ReadPathVecX analogue.

Reference behavior (SURVEY.md §2.1 "Read pathing"): HBVPather::algorithmTwo
seeds reads on the kmer dict, validates captured gaps (same-edge seed pairs
across a miss gap must agree on the implied read offset within jitter <= 3),
checks graph adjacency between consecutive seeds, and drops weak/chimeric
terminal seeds (BuildReadQGraph48.cc:1185-1438); paths are stored as
offset + edge list (paths/long/ReadPath.h) and bit-compressed
(10X/paths/ReadPathVecX.h).

Device design: one dictionary lookup per read position for ALL reads at
once (sort-merge join), then per-read run compression of the hit edge
sequence with cumsum/scatter — no per-read control flow.  Error kmers
simply miss the dict (they were filtered); runs on the same edge re-join
across the miss ONLY when the implied offsets agree (captured-gap jitter
rule).  After slotting, consecutive slots are validated against the graph
(to/from vertex adjacency + exact junction position within jitter) and the
longest valid run of slots is kept — the vectorized equivalent of
algorithmTwo's seed-chain validation; chimeric repeat jumps are cut here
instead of surviving into closures.

Paths are fixed-width (R, MAX_PATH) with -1 padding + overflow flag — the
static-shape stand-in for the reference's ragged ReadPathVec.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import kmer_codec as kc
from ..core.kmer_codec import K, W3

I32 = jnp.int32
MAX_PATH = 12  # max edges a 150bp read can plausibly traverse; overflow flagged
JITTER = 3  # max indel slack for captured gaps / junctions (algorithmTwo)
# uniform-length readsets route through the fused gather-free program
# (path_reads_fused_impl); flip off to fall back to the general path
FUSED = True
# Budget on the merge-join sort length (table rows + query kmer rows).
# The blocked pather sizes its read blocks so m+n stays under this; when
# the table alone exceeds JOIN_ROWS - MIN_QUERY_ROWS, the fused path joins
# against table SLICES.  Block sizes carried over from an earlier device;
# not yet measured on the H100.
JOIN_ROWS = 64_000_000
MIN_QUERY_ROWS = 8_000_000
# above this join length the dictionary values propagate by cummax+gather
# instead of the associative scan (whose log-depth lowering compiles slowly
# at large shapes); not yet measured on the H100
SCAN_PROPAGATE_MAX_ROWS = 24_000_000


def _table_slices(m: int) -> int:
    """Number of table slices the fused join needs so each slice plus a
    useful query block fits JOIN_ROWS."""
    if m <= JOIN_ROWS - MIN_QUERY_ROWS:
        return 1
    return -(-m // (JOIN_ROWS // 2))


def _join_block_positions(bg, rs) -> int:
    """Max positions per pather block so the join sort (per table slice +
    post-tail-cut query rows) stays within JOIN_ROWS."""
    m = 0 if bg.kmer_words is None else int(bg.kmer_words.shape[0])
    m_s = -(-m // _table_slices(m))
    q_budget = max(MIN_QUERY_ROWS, JOIN_ROWS - m_s)
    lens = np.diff(rs.offsets)
    frac = 1.0
    if rs.n_reads > 0 and (lens == lens[0]).all() and int(lens[0]) > K:
        rl = int(lens[0])
        frac = (rl - K + 1) / rl
    from ..kmer.count import BLOCK_POSITIONS

    return min(BLOCK_POSITIONS, int(q_budget / frac))


class ReadPaths(NamedTuple):
    edges: jax.Array  # (R, MAX_PATH) int32 edge ids, -1 pad
    path_len: jax.Array  # (R,) int32
    offset: jax.Array  # (R,) int32 read start in first-edge coordinates
    first_skip: jax.Array  # (R,) int32 read position of first kmer hit
    overflow: jax.Array  # (R,) bool


def _resolve_local(kmer_words, node_edge, node_pos, canon, flipped):
    """Local dictionary resolve: sort-merge join against the full table.
    -> (edge, epos, found) per query row.  The value-sharded resolve
    (parallel/sharded_path._dist_resolve) is a drop-in replacement that
    routes queries to hash-owner shards instead."""
    row, found = kc.lookup_words_merge(kmer_words, canon)
    node = 2 * row + flipped.astype(I32)
    edge = jnp.where(found, node_edge[node], -1)
    epos = jnp.where(found, node_pos[node], 0)
    return edge, epos, found


@partial(jax.jit, static_argnames=("max_path", "uniform_rl"))
def path_reads(
    kmer_words: W3,  # sorted canonical table (sentinel-padded), SoA
    node_edge,  # (2M,) int32
    node_pos,  # (2M,) int32
    from_v,  # (E,) int32 edge source vertex
    to_v,  # (E,) int32 edge target vertex
    edge_kmers,  # (E,) int32 kmers per edge (len - K + 1)
    codes_ext,  # (NB+K,) int32
    read_offsets,  # (RP+1,) int32 (read-boundary lookups only; RP-scale)
    pos_read,  # (NB,) int32
    rlen_pos,  # (NB,) int32 read length of the row's read (host-broadcast)
    max_path: int = MAX_PATH,
    uniform_rl: int | None = None,
) -> ReadPaths:
    if uniform_rl is not None and FUSED:
        return path_reads_fused_impl(
            kmer_words, node_edge, node_pos, from_v, to_v, edge_kmers,
            codes_ext, rlen_pos, pos_read.shape[0],
            read_offsets.shape[0] - 1, max_path, uniform_rl,
            n_slices=_table_slices(kmer_words.a.shape[0]),
        )
    resolve = partial(_resolve_local, kmer_words, node_edge, node_pos)
    return path_reads_impl(
        resolve, from_v, to_v, edge_kmers, codes_ext, read_offsets,
        pos_read, rlen_pos, max_path=max_path, uniform_rl=uniform_rl,
    )


def path_reads_impl(
    resolve,  # (canon W3, flipped) -> (edge, epos, found)
    from_v,
    to_v,
    edge_kmers,
    codes_ext,
    read_offsets,
    pos_read,
    rlen_pos,
    max_path: int = MAX_PATH,
    uniform_rl: int | None = None,
) -> ReadPaths:
    nb = pos_read.shape[0]
    rp = read_offsets.shape[0] - 1

    words = kc.sliding_words(codes_ext, nb)
    canon, flipped = kc.canonicalize(words)

    if uniform_rl is not None:
        # static tail cut (kmer/count.uniform_tail_cut): the last K-1
        # positions of each uniform-length read block never hold a kmer —
        # the join and all per-position sorts below shrink by (K-1)/rl
        from ..kmer.count import uniform_tail_cut

        cols = uniform_rl - K + 1
        a_, b_, c_, flipped, pos_read, rlen_pos = uniform_tail_cut(
            uniform_rl, canon.a, canon.b, canon.c, flipped, pos_read,
            rlen_pos,
        )
        canon = W3(a_, b_, c_)
        nb = canon.a.shape[0]
        p = jnp.arange(nb, dtype=I32)
        pir = p % cols
    else:
        p = jnp.arange(nb, dtype=I32)
        read_first0 = jnp.concatenate(
            [jnp.ones((1,), bool), pos_read[1:] != pos_read[:-1]]
        )
        start = jax.lax.cummax(jnp.where(read_first0, p, 0))
        pir = p - start
    edge, epos, found = resolve(canon, flipped)
    inb = pir + K <= rlen_pos
    hit = found & inb & (edge >= 0)
    edge = jnp.where(hit, edge, -1)
    epos = jnp.where(hit, epos, 0)

    # run compression: a hit opens a new path slot unless the previous hit
    # in the same read (across any miss gap) was on the same edge AND the
    # implied read offset (epos - pos_in_read) agrees within JITTER — the
    # captured-gap validation of algorithmTwo.  Compact the hit rows with
    # one stable 1-key sort (order preserved), compare neighbors, and
    # scatter the flags back — avoids 48M-row gathers.
    delta = epos - pir  # edge coord of read start, constant along a run
    nh, pe, pr, pp, pd, pq = jax.lax.sort(
        ((~hit).astype(jnp.uint32), edge, pos_read, p, delta, pir),
        num_keys=1,
        is_stable=True,
    )
    n_hits = jnp.sum(hit.astype(I32))
    live = jnp.arange(nb) < n_hits
    prev_same = jnp.concatenate(
        [
            jnp.zeros((1,), bool),
            (pe[1:] == pe[:-1])
            & (pr[1:] == pr[:-1])
            & (jnp.abs(pd[1:] - pd[:-1]) <= JITTER),
        ]
    )
    new_for_hit = live & ~prev_same
    scat = jnp.where(live, pp, nb)
    new_slot = (
        jnp.zeros((nb + 1,), bool)
        .at[scat]
        .set(new_for_hit, mode="drop")[:nb]
    )

    # slot index of each marker within its read: cumsum minus the cumsum at
    # the read's first position, broadcast forward with a cummax (reads are
    # contiguous, cumsums are non-decreasing — no gathers needed)
    mk = new_slot.astype(I32)
    cs = jnp.cumsum(mk)
    cs_excl = cs - mk
    if uniform_rl is not None:
        read_first = pir == 0
    else:
        read_first = jnp.concatenate(
            [jnp.ones((1,), bool), pos_read[1:] != pos_read[:-1]]
        )
    base = jax.lax.cummax(jnp.where(read_first, cs_excl, 0))
    slot = cs_excl - base  # valid at marker rows

    # place markers into fixed-width per-read matrices with one scatter per
    # field: the edge id plus the marker's read/edge positions (the seed
    # coordinates the junction validation below needs)
    ok = new_slot & (slot < max_path)
    flat_idx = jnp.where(ok, pos_read * max_path + slot, rp * max_path)

    def place(vals, fill):
        return (
            jnp.full((rp * max_path + 1,), fill, I32)
            .at[flat_idx]
            .set(vals, mode="drop")[: rp * max_path]
            .reshape(rp, max_path)
        )

    paths = place(edge, -1)
    entry_p = place(pir, 0)  # read position of the slot's first hit
    entry_e = place(epos, 0)  # edge position of the slot's first hit

    # per-read totals from the cumsum at read boundaries (RP-scale gathers)
    cs_ext = jnp.concatenate([jnp.zeros((1,), I32), cs])
    if uniform_rl is not None:
        cols_ = uniform_rl - K + 1
        s_r = jnp.minimum(jnp.arange(rp, dtype=I32) * cols_, nb)
        e_r = jnp.minimum(s_r + cols_, nb)
    else:
        s_r = read_offsets[:-1].astype(I32)[:rp]
        e_r = read_offsets[1:].astype(I32)[:rp]
    n_slots = cs_ext[e_r] - cs_ext[s_r]
    overflow = n_slots > max_path
    raw_len = jnp.minimum(n_slots, max_path)

    # per-slot kmer support (scatter-add over hit rows): the run with the
    # most supporting kmers wins, the vectorized version of dropping weak
    # terminal seeds in favor of the well-supported chain
    slot_row = cs - 1 - base  # slot index of every hit row
    flat_hit = jnp.where(
        hit & (slot_row >= 0) & (slot_row < max_path),
        pos_read * max_path + slot_row,
        rp * max_path,
    )
    slot_hits = (
        jnp.zeros((rp * max_path + 1,), I32)
        .at[flat_hit]
        .add(1, mode="drop")[: rp * max_path]
        .reshape(rp, max_path)
    )

    return _select_best_run(
        paths, entry_p, entry_e, slot_hits, raw_len, n_slots, overflow,
        from_v, to_v, edge_kmers, max_path, rp,
    )


def _select_best_run(
    paths, entry_p, entry_e, slot_hits, raw_len, n_slots, overflow,
    from_v, to_v, edge_kmers, max_path: int, rp: int,
) -> ReadPaths:
    """Seed-chain validation (algorithmTwo junction checks): consecutive
    slots must be graph-adjacent AND the implied read coord of the next
    edge's start must equal this edge's start + its kmer count (edges
    overlap by K-1) within JITTER; keep the best-supported valid run of
    slots per read (drops chimeric/weak terminal seeds)."""
    slot_i = jnp.arange(max_path, dtype=I32)[None, :]
    exists = slot_i < raw_len[:, None]
    e_safe = jnp.maximum(paths, 0)
    o = entry_p - entry_e  # read coord where each slot's edge starts
    km = edge_kmers[e_safe]
    adj = to_v[e_safe][:, :-1] == from_v[e_safe][:, 1:]
    pos_ok = jnp.abs(o[:, 1:] - (o[:, :-1] + km[:, :-1])) <= JITTER
    valid_j = adj & pos_ok & exists[:, 1:] & exists[:, :-1]

    # best-supported valid run via a static unrolled scan over the slots
    sup = jnp.where(exists, slot_hits, 0)
    run_sup = [sup[:, 0]]
    run_st = [jnp.zeros((rp,), I32)]
    for i in range(1, max_path):
        cont = valid_j[:, i - 1]
        run_sup.append(
            jnp.where(cont, run_sup[-1] + sup[:, i], sup[:, i])
            * exists[:, i].astype(I32)
        )
        run_st.append(jnp.where(cont, run_st[-1], i).astype(I32))
    run_sup = jnp.stack(run_sup, axis=1)  # (R, max_path)
    run_st = jnp.stack(run_st, axis=1)
    end = jnp.argmax(run_sup, axis=1).astype(I32)  # earliest best run
    seg_start = jnp.take_along_axis(run_st, end[:, None], axis=1)[:, 0]
    best_len = end - seg_start + 1

    idx = jnp.clip(seg_start[:, None] + slot_i, 0, max_path - 1)
    keep = slot_i < best_len[:, None]
    paths = jnp.where(keep, jnp.take_along_axis(paths, idx, axis=1), -1)
    st = jnp.clip(seg_start, 0, max_path - 1)[:, None]
    p0 = jnp.take_along_axis(entry_p, st, axis=1)[:, 0]
    e0 = jnp.take_along_axis(entry_e, st, axis=1)[:, 0]

    has_hit = n_slots > 0
    path_len = jnp.where(has_hit, best_len, 0)
    first_skip = jnp.where(has_hit, p0, 0)
    offset = jnp.where(has_hit, e0 - p0, 0)

    return ReadPaths(paths, path_len, offset, first_skip, overflow)


def _last_valid_scan(has, *vals):
    """Inclusive 'last valid wins' scan: row i receives each val from the
    nearest row j <= i with has[j] set (its own if set).  The associative
    combine is the standard last-write-wins monoid — O(n) elementwise work,
    no gathers."""
    has_u = has.astype(jnp.uint32)

    def comb(a, b):
        sel = b[0] > 0
        return (a[0] | b[0],) + tuple(
            jnp.where(sel, bv, av) for av, bv in zip(a[1:], b[1:])
        )

    out = jax.lax.associative_scan(comb, (has_u,) + tuple(vals))
    return out[1:]


# fused-path pkidx bit layout: [31]=rc-flipped, [30]=invalid row, [29:0]=row
_F_FLIP = np.uint32(1 << 31)
_F_INV = np.uint32(1 << 30)
_F_POS = np.uint32((1 << 30) - 1)


def path_reads_fused_impl(
    kmer_words: W3,
    node_edge,
    node_pos,
    from_v,
    to_v,
    edge_kmers,
    codes_ext,
    rlen_pos,
    nbp: int,
    rp: int,
    max_path: int,
    uniform_rl: int,
    n_slices: int = 1,
) -> ReadPaths:
    """Gather-free pather for uniform-length reads.

    Same contract as path_reads_impl with a local dictionary, built around
    a cost model in which sorts and cumsums are cheap and position-scale
    gathers and scatters are expensive (derived on an earlier device; not
    yet re-measured on the H100 — ROADMAP speed item 2):

      1. ONE unstable merge sort joins queries against the table, with the
         oriented (edge, pos) dictionary values riding as sort payloads on
         the table rows (node_edge/node_pos are strided slices at table
         scale, never queried by gather at query scale).
      2. A last-valid associative scan broadcasts each table row's values
         down its run of matching query rows.
      3. ONE more unstable sort (keys: miss flag, query position) compacts
         hit rows back into read order — replacing the old scatter-back +
         per-position stable sort + nb-scale scatters; everything after it
         runs at hit scale (~placed kmers), not position scale.

    The captured-gap rejoin rule, slot accounting, and seed-chain
    validation are semantically identical to path_reads_impl (equality is
    tested in tests/test_pather.py::test_fused_matches_general).
    """
    nb0 = nbp  # position rows before the tail cut (padded)
    rl = uniform_rl
    cols = rl - K + 1

    words = kc.sliding_words(codes_ext, nb0)
    canon, flipped = kc.canonicalize(words)
    from ..kmer.count import uniform_tail_cut

    a_, b_, c_, flipped, rlen_q = uniform_tail_cut(
        rl, canon.a, canon.b, canon.c, flipped, rlen_pos
    )
    n = a_.shape[0]
    q = jnp.arange(n, dtype=jnp.uint32)
    pirq = (q % np.uint32(cols)).astype(I32)
    invalid = pirq + K > rlen_q  # padding reads (uniform real reads pass)

    m = kmer_words.a.shape[0]
    # oriented dictionary values at table scale (strided slices, no gather)
    ef, er = node_edge[0::2].astype(jnp.uint32), node_edge[1::2].astype(jnp.uint32)
    pf, pr_ = node_pos[0::2].astype(jnp.uint32), node_pos[1::2].astype(jnp.uint32)
    zq = jnp.zeros((n,), jnp.uint32)
    pkidx = (
        q
        | jnp.where(flipped, _F_FLIP, np.uint32(0))
        | jnp.where(invalid, _F_INV, np.uint32(0))
    )

    def join_once(twa, twb, twc, tef, ter, tpf, tpr, tnode_edge, tnode_pos):
        """Merge-join the queries against ONE table slice; returns per-row
        (hit, qpos, edge, epos) in that slice's merged order.

        Two propagation variants for the dictionary values:
          * scan: (edge,pos) ride the sort as 4 payload columns and a
            last-valid associative scan broadcasts them — zero gathers,
            but the scan's log-depth lowering is compile-heavy at large
            shapes.
          * gather: 5-operand sort only; the matching table ROW id is
            propagated by a cummax (table sidx is monotone in merged
            order) and (edge,pos) come from two node-array gathers.
            Slightly slower per row, compiles at any size.
        """
        ms = twa.shape[0]
        scan_prop = (ms + n) <= SCAN_PROPAGATE_MAX_ROWS
        ka = jnp.concatenate([twa, a_])
        kb = jnp.concatenate([twb, b_])
        kc_ = jnp.concatenate([twc, c_])
        tag = jnp.concatenate(
            [jnp.zeros((ms,), jnp.uint32), jnp.ones((n,), jnp.uint32)]
        )
        pk = jnp.concatenate([jnp.arange(ms, dtype=jnp.uint32), pkidx])
        ops = [ka, kb, kc_, tag, pk]
        if scan_prop:
            ops += [
                jnp.concatenate([tef, zq]),
                jnp.concatenate([ter, zq]),
                jnp.concatenate([tpf, zq]),
                jnp.concatenate([tpr, zq]),
            ]

        # rows with equal (kmer, tag) are interchangeable: table rows are
        # unique, and equal-kmer query rows receive identical values
        out = jax.lax.sort(tuple(ops), num_keys=4, is_stable=False)
        sa, sb, sc, stag, spk = out[:5]
        pos = jnp.arange(ms + n, dtype=I32)
        is_table = stag == 0
        last_tpos = jax.lax.cummax(jnp.where(is_table, pos, -1))
        neq = (sa[1:] != sa[:-1]) | (sb[1:] != sb[:-1]) | (sc[1:] != sc[:-1])
        wstarts = jnp.concatenate([jnp.ones((1,), bool), neq])
        last_run_start = jax.lax.cummax(jnp.where(wstarts, pos, 0))
        found = (~is_table) & (last_tpos >= last_run_start)

        flip = (spk & _F_FLIP) != 0
        inv = (spk & _F_INV) != 0
        qpos = (spk & _F_POS).astype(I32)
        hit = found & ~inv
        if scan_prop:
            efp, erp, pfp, prp = _last_valid_scan(is_table, *out[5:])
            edge = jnp.where(flip, erp, efp).astype(I32)
            epos = jnp.where(flip, prp, pfp).astype(I32)
        else:
            # last table row id above each row (monotone -> cummax); the
            # node arrays are table-scale, so the gathers stay small
            lt = jax.lax.cummax(
                jnp.where(is_table, spk.astype(I32), -1)
            )
            node = 2 * jnp.maximum(lt, 0) + flip.astype(I32)
            edge = jnp.where(hit, tnode_edge[node], -1)
            epos = jnp.where(hit, tnode_pos[node], 0)
        return hit, qpos, edge, epos

    S = max(1, n_slices)
    if S == 1:
        hit, qpos, edge, epos = join_once(
            kmer_words.a, kmer_words.b, kmer_words.c, ef, er, pf, pr_,
            node_edge.astype(I32), node_pos.astype(I32),
        )
        return _compact_and_place(
            hit, qpos, edge, epos, cols, rp, max_path,
            from_v, to_v, edge_kmers,
        )

    # sliced-table join: when the dictionary alone approaches JOIN_ROWS
    # (100 Mb: ~104M rows), join the queries against S contiguous slices
    # of the sorted table — a query matches in exactly one slice, so the
    # per-slice results combine by first-found.  All S sorts share one
    # compiled shape (Ls + n rows).
    Ls = -(-m // S)
    padn = S * Ls - m
    twa, twb, twc = kmer_words.a, kmer_words.b, kmer_words.c
    ne_i, np_i = node_edge.astype(I32), node_pos.astype(I32)
    if padn:
        sen = jnp.full((padn,), kc.SENTINEL, jnp.uint32)
        zpad = jnp.zeros((padn,), jnp.uint32)
        twa = jnp.concatenate([twa, sen])
        twb = jnp.concatenate([twb, sen])
        twc = jnp.concatenate([twc, sen])
        ef = jnp.concatenate([ef, zpad])
        er = jnp.concatenate([er, zpad])
        pf = jnp.concatenate([pf, zpad])
        pr_ = jnp.concatenate([pr_, zpad])
        znode = jnp.zeros((2 * padn,), I32)
        ne_i = jnp.concatenate([ne_i, znode])
        np_i = jnp.concatenate([np_i, znode])
    found_q = jnp.zeros((n,), bool)
    edge_q = jnp.full((n,), -1, I32)
    epos_q = jnp.zeros((n,), I32)
    for s in range(S):
        sl = slice(s * Ls, (s + 1) * Ls)
        sl2 = slice(2 * s * Ls, 2 * (s + 1) * Ls)
        hit, qpos, edge, epos = join_once(
            twa[sl], twb[sl], twc[sl], ef[sl], er[sl], pf[sl], pr_[sl],
            ne_i[sl2], np_i[sl2],
        )
        qslot = jnp.where(hit, qpos, n)
        f = jnp.zeros((n + 1,), bool).at[qslot].set(True, mode="drop")[:n]
        e = jnp.full((n + 1,), -1, I32).at[qslot].set(edge, mode="drop")[:n]
        p = jnp.zeros((n + 1,), I32).at[qslot].set(epos, mode="drop")[:n]
        found_q = found_q | f
        edge_q = jnp.where(f, e, edge_q)
        epos_q = jnp.where(f, p, epos_q)
    return _compact_and_place(
        found_q, q.astype(I32), edge_q, epos_q, cols, rp, max_path,
        from_v, to_v, edge_kmers,
    )


def _compact_and_place(
    hit, qpos, edge, epos, cols: int, rp: int, max_path: int,
    from_v, to_v, edge_kmers,
) -> ReadPaths:
    """Shared tail of the fused pather: one unstable 2-key sort compacts
    hit rows into read order, then slot/support accounting and seed-chain
    validation run at hit scale.  Inputs may be in merged order (single
    table) or query order (sliced table) — only (hit, qpos, edge, epos)
    per row matter."""
    mn = hit.shape[0]
    # compact hit rows into read order: keys (miss, query position)
    misskey = (~hit).astype(jnp.uint32)
    _, cq, ce, cp = jax.lax.sort(
        (misskey, qpos.astype(jnp.uint32), edge, epos),
        num_keys=2,
        is_stable=False,
    )
    n_hits = jnp.sum(hit.astype(I32))
    live = jnp.arange(mn, dtype=I32) < n_hits
    cq = cq.astype(I32)
    cread = cq // cols
    cpir = cq % cols
    cdelta = cp - cpir

    # captured-gap rejoin: a hit opens a new slot unless the previous hit
    # in the same read (across any miss gap) is on the same edge AND the
    # implied read offset agrees within JITTER
    prev_same = jnp.concatenate(
        [
            jnp.zeros((1,), bool),
            (ce[1:] == ce[:-1])
            & (cread[1:] == cread[:-1])
            & (jnp.abs(cdelta[1:] - cdelta[:-1]) <= JITTER),
        ]
    )
    new_for_hit = live & ~prev_same
    mk = new_for_hit.astype(I32)
    g = jnp.cumsum(mk) - 1  # global slot counter at each live row
    read_first = live & jnp.concatenate(
        [jnp.ones((1,), bool), cread[1:] != cread[:-1]]
    )
    base = jax.lax.cummax(jnp.where(read_first, g, -1))
    slot = g - base

    ok = new_for_hit & (slot < max_path)
    flat_idx = jnp.where(ok, cread * max_path + slot, rp * max_path)

    def place(vals, fill):
        return (
            jnp.full((rp * max_path + 1,), fill, I32)
            .at[flat_idx]
            .set(vals, mode="drop")[: rp * max_path]
            .reshape(rp, max_path)
        )

    paths = place(ce, -1)
    entry_p = place(cpir, 0)
    entry_e = place(cp, 0)

    flat_hit = jnp.where(
        live & (slot < max_path), cread * max_path + slot, rp * max_path
    )
    slot_hits = (
        jnp.zeros((rp * max_path + 1,), I32)
        .at[flat_hit]
        .add(1, mode="drop")[: rp * max_path]
        .reshape(rp, max_path)
    )

    n_slots = (
        jnp.zeros((rp + 1,), I32)
        .at[jnp.where(new_for_hit, cread, rp)]
        .add(1, mode="drop")[:rp]
    )
    overflow = n_slots > max_path
    raw_len = jnp.minimum(n_slots, max_path)

    return _select_best_run(
        paths, entry_p, entry_e, slot_hits, raw_len, n_slots, overflow,
        from_v, to_v, edge_kmers, max_path, rp,
    )


# --------------------------------------------------------------- host layer

def path_readset(bg, rs, max_path: int = MAX_PATH) -> ReadPaths:
    """BaseGraph + ReadSet -> ReadPaths (host entry).

    Readsets whose flat positions exceed the device budget are pathed in
    pair-aligned blocks sharing one program shape (reads are independent,
    results concatenate; same dispatch rule as the blocked count)."""
    from ..kmer.count import (
        MIN_BLOCK_POSITIONS,
        _is_oom,
        prepare_reads,
    )

    block_budget = _join_block_positions(bg, rs)
    if int(rs.offsets[-1]) > block_budget:
        # self-healing block size on device OOM (same rule as count_readset)
        max_pos = block_budget
        while True:
            try:
                return _path_readset_blocked(
                    bg, rs, max_path, max_positions=max_pos
                )
            except Exception as e:  # noqa: BLE001 — OOM-retry boundary
                if not _is_oom(e) or max_pos // 2 < MIN_BLOCK_POSITIONS:
                    raise
                max_pos //= 2
                import logging

                logging.getLogger("supernova_tpu").warning(
                    "paths: device OOM at block=%d positions; retrying "
                    "with block=%d", max_pos * 2, max_pos,
                )
                from ..kmer.count import _free_failed_attempt

                _free_failed_attempt(e)
    # compact transfer for uniform-length reads: 2-bit packed codes with
    # device-side expansion (16x less host->device traffic than the
    # expanded per-position arrays; the values are identical by
    # construction — same rule as the blocked dispatch below)
    from ..kmer.count import _round_up, prepare_reads_packed

    pk = prepare_reads_packed(rs)
    if pk is not None:
        rp_pad = _round_up(rs.n_reads + 1, 1024)
        return _path_prepared_packed(bg, pk, max_path, rp_pad)
    inp = prepare_reads(rs)
    return _path_prepared(bg, inp, max_path)


def _path_prepared(bg, inp, max_path: int) -> ReadPaths:
    da = bg.device_arrays()
    return path_reads(
        da["words"],
        da["node_edge"],
        da["node_pos"],
        da["from_v"],
        da["to_v"],
        da["edge_kmers"],
        inp["codes_ext"],
        inp["read_offsets"],
        inp["pos_read"],
        inp["rlen_pos"],
        max_path=max_path,
        uniform_rl=inp["uniform_rl"],
    )


@partial(jax.jit, static_argnames=("max_path", "uniform_rl", "nbp", "rp_pad"))
def path_reads_packed(
    kmer_words: W3, node_edge, node_pos, from_v, to_v, edge_kmers,
    codes_packed, n_reads,
    max_path: int, uniform_rl: int, nbp: int, rp_pad: int,
) -> ReadPaths:
    """path_reads from compact inputs (2-bit packed codes + read count):
    the per-position arrays are rebuilt on device — same values as
    prepare_reads' host-expanded ones by construction (uniform reads only).
    Cuts the per-block host->device transfer ~16x for the blocked pather."""
    from ..kmer.count import _unpack_codes_dev

    rl = uniform_rl
    codes_ext = _unpack_codes_dev(codes_packed, nbp, max(K, 128))
    nr = n_reads.astype(I32)
    pos = jnp.arange(nbp, dtype=I32) // rl
    pos_read = jnp.minimum(pos, nr)
    rlen_pos = jnp.where(pos < nr, I32(rl), I32(0)).astype(I32)
    if FUSED:
        return path_reads_fused_impl(
            kmer_words, node_edge, node_pos, from_v, to_v, edge_kmers,
            codes_ext, rlen_pos, nbp, rp_pad, max_path, rl,
            n_slices=_table_slices(kmer_words.a.shape[0]),
        )
    read_offsets = jnp.minimum(
        jnp.arange(rp_pad + 1, dtype=I32) * rl, nr * rl
    )
    resolve = partial(_resolve_local, kmer_words, node_edge, node_pos)
    return path_reads_impl(
        resolve, from_v, to_v, edge_kmers, codes_ext, read_offsets,
        pos_read, rlen_pos, max_path=max_path, uniform_rl=rl,
    )


def _path_prepared_packed(bg, pk, max_path: int, rp_pad: int) -> ReadPaths:
    da = bg.device_arrays()
    return path_reads_packed(
        da["words"],
        da["node_edge"],
        da["node_pos"],
        da["from_v"],
        da["to_v"],
        da["edge_kmers"],
        jnp.asarray(pk["codes_packed"]),
        jnp.asarray(np.int32(pk["n_reads"])),
        max_path=max_path,
        uniform_rl=pk["uniform_rl"],
        nbp=pk["nbp"],
        rp_pad=rp_pad,
    )


def _path_readset_blocked(bg, rs, max_path: int,
                          max_positions: int | None = None) -> ReadPaths:
    from ..kmer.count import (
        BLOCK_POSITIONS,
        prepare_reads,
        split_readset_blocks,
    )

    blocks = split_readset_blocks(rs, max_positions or BLOCK_POSITIONS)
    pad_pos = max(int(b.offsets[-1]) for b in blocks)
    pad_rd = max(b.n_reads for b in blocks)

    # compact transfers when reads are uniform length (same rule and same
    # parent-level decision as the blocked count)
    from ..kmer.count import _round_up, prepare_reads_packed

    lens_all = np.diff(rs.offsets)
    packed = (
        rs.n_reads > 0
        and bool((lens_all == lens_all[0]).all())
        and int(lens_all[0]) > K
    )
    if packed:
        rp_pad = _round_up(pad_rd + 1, 1024)
        prep = lambda b: prepare_reads_packed(b, pad_to_positions=pad_pos)
        dispatch = lambda p: _path_prepared_packed(bg, p, max_path, rp_pad)
    else:
        prep = lambda b: prepare_reads(
            b, pad_to_positions=pad_pos, pad_to_reads=pad_rd
        )
        dispatch = lambda p: _path_prepared(bg, p, max_path)
    parts = []
    inp = prep(blocks[0])
    for i in range(len(blocks)):
        rp = dispatch(inp)  # async dispatch
        if i + 1 < len(blocks):
            # overlap the next block's host prep with this device program
            inp = prep(blocks[i + 1])
        n = blocks[i].n_reads
        parts.append(
            tuple(np.asarray(x)[:n] for x in rp)
        )
    return ReadPaths(*(
        jnp.asarray(np.concatenate([p[i] for p in parts]))
        for i in range(5)
    ))
