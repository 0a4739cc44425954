"""De Bruijn graph construction + unipath compaction, device-side.

Reference behavior (SURVEY.md §7 step 4): EdgeBuilder walks the filtered
48-mer dict by extension context and emits maximal unbranched edges including
circles (BuildReadQGraph48.cc:327-515 buildEdges), then buildHBVFromEdges
canonicalizes fwd+rc with an involution (paths/long/HBVFromEdges.cc).

Device re-design: no pointer-walking.  The 2M oriented kmer nodes
(canonical row k x direction d) get a functional successor map next[u]
(unique out-extension whose target has unique in-extension), cycles are
broken at their minimum node id, and maximal chains are ranked by
pointer-doubling (log-depth gathers) — the classic list-ranking formulation
of unipath compaction.  Edge sequences, vertices (47-mer junctions), and the
rc involution are then materialized with sorts/scans/scatters.

Two host-coordinated phases keep shapes static: phase A computes links and
ranks on padded tables; the host reads back two scalars (n_edges, flat base
total) and calls phase B with bucketed static output sizes + the dynamic
true edge count.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import kmer_codec as kc
from ..core.kmer_codec import K, W3
from ..kmer.count import KmerTable, rev4
from ..ops import segments as seg

I32 = jnp.int32
U32 = jnp.uint32


def popcount4(mask):
    mask = jnp.asarray(mask)
    return ((mask & 1) + ((mask >> 1) & 1) + ((mask >> 2) & 1) + ((mask >> 3) & 1)).astype(I32)


def single_bit_index(mask):
    """bit index of a one-hot 4-bit mask (undefined otherwise)."""
    mask = jnp.asarray(mask).astype(I32)
    return (mask == 2) * 1 + (mask == 4) * 2 + (mask == 8) * 3


class Links(NamedTuple):
    next: jax.Array  # (2M,) int32 successor node or -1
    prev: jax.Array  # (2M,) int32 predecessor node or -1 (cycles broken)
    head: jax.Array  # (2M,) int32 chain head node
    dist: jax.Array  # (2M,) int32 rank within chain (head = 0)


def oriented_words(table_words: W3, node_ids) -> W3:
    """Node id u = 2*row + d  ->  kmer words in the node's orientation."""
    row = node_ids >> 1
    d = node_ids & 1
    w = table_words.gather(row)
    return kc.rc_words(w).where(d == 1, w)


# Oriented-node block size for successor resolution.  build_links as one
# program holds ~10 n2-scale arrays live through a 5-operand (m + n2)-row
# sort — at 30 Mb (62M nodes) that exhausted a 16 GB device's memory;
# blocking the resolve bounds the peak at table + O(block) regardless of
# genome size.  Addin: dbg.build.LINK_BLOCK_NODES.
LINK_BLOCK_NODES = 8_388_608


@jax.jit
def _indeg8(table: KmerTable):
    """(2M,) uint8 in-degree of every oriented node."""
    m = table.words.a.shape[0]
    u = jnp.arange(2 * m, dtype=I32)
    row = u >> 1
    d = u & 1
    lmask = table.left_mask[row]
    rmask = table.right_mask[row]
    in_mask = jnp.where(d == 0, lmask, rev4(rmask))
    return popcount4(in_mask).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("blk",))
def _links_block(table: KmerTable, indeg8, lo, blk: int):
    """Successor of each oriented node in [lo, lo+blk): unique
    out-extension whose target has unique in-extension.  -1 otherwise."""
    m = table.words.a.shape[0]
    n2 = 2 * m
    u = lo + jnp.arange(blk, dtype=I32)
    uc = jnp.minimum(u, n2 - 1)  # clamp pad rows; u < n2 guards link_ok
    row = uc >> 1
    d = uc & 1
    lmask = table.left_mask[row]
    rmask = table.right_mask[row]
    out_mask = jnp.where(d == 0, rmask, rev4(lmask))
    outdeg = popcount4(out_mask)

    ow = oriented_words(table.words, uc)
    b = single_bit_index(out_mask)
    succ = kc.successor_words(ow, b)
    canon, flip = kc.canonicalize(succ)
    srow, found = kc.lookup_words_merge(table.words, canon)
    v = (2 * srow + flip.astype(I32)).astype(I32)

    link_ok = (
        (outdeg == 1) & found
        & (indeg8[jnp.where(found, v, 0)] == 1)
        & (v != uc) & (u < n2)
    )
    return jnp.where(link_ok, v, -1)


@jax.jit
def _rank_links(nxt) -> Links:
    """Cycle-broken list ranking over the full successor map (lean: only
    pointer/rank arrays are live — no word or mask arrays)."""
    n2 = nxt.shape[0]
    u = jnp.arange(n2, dtype=I32)
    link_ok = nxt >= 0
    prv = jnp.full((n2,), -1, I32)
    prv = prv.at[jnp.where(link_ok, nxt, n2)].set(u, mode="drop")

    steps = int(np.ceil(np.log2(max(n2, 2)))) + 1

    # cycle detection + break at cycle-min node
    ptr = jnp.where(prv >= 0, prv, u)
    mn = u

    def cyc_body(_, st):
        ptr, mn = st
        return ptr[ptr], jnp.minimum(mn, mn[ptr])

    ptr, mn = jax.lax.fori_loop(0, steps, cyc_body, (ptr, mn))
    in_cycle = prv[ptr] >= 0
    prv = jnp.where(in_cycle & (u == mn), -1, prv)

    # list ranking (distance to head) by pointer doubling
    ptr = jnp.where(prv >= 0, prv, u)
    dist = (prv >= 0).astype(I32)

    def rank_body(_, st):
        ptr, dist = st
        return ptr[ptr], dist + dist[ptr]

    ptr, dist = jax.lax.fori_loop(0, steps, rank_body, (ptr, dist))
    return Links(nxt, prv, ptr, dist)


# Above this node count the pointer-doubling ranking runs HOST-side: the
# device fori_loop program (27 iterations of 2 n2-sized gathers) crashed an
# earlier device runtime at 62M nodes (30 Mb genome) while every other graph
# program at that size ran fine; not yet tried on the H100.  The host ranking is exact, numpy, and
# ~tens of seconds at 100 Mb scale.  Addin: dbg.build.RANK_DEVICE_MAX_NODES.
RANK_DEVICE_MAX_NODES = 25_000_000


def _rank_links_host(nxt: np.ndarray) -> Links:
    """Numpy twin of _rank_links (cycle break at min node + list ranking)."""
    n2 = nxt.shape[0]
    u = np.arange(n2, dtype=np.int32)
    link_ok = nxt >= 0
    prv = np.full(n2, -1, np.int32)
    prv[nxt[link_ok]] = u[link_ok]

    steps = int(np.ceil(np.log2(max(n2, 2)))) + 1
    ptr = np.where(prv >= 0, prv, u)
    mn = u.copy()
    for _ in range(steps):
        ptr, mn = ptr[ptr], np.minimum(mn, mn[ptr])
    in_cycle = prv[ptr] >= 0
    prv = np.where(in_cycle & (u == mn), -1, prv)

    ptr = np.where(prv >= 0, prv, u)
    dist = (prv >= 0).astype(np.int32)
    for _ in range(steps):
        ptr, dist = ptr[ptr], dist + dist[ptr]
    return Links(
        jnp.asarray(nxt), jnp.asarray(prv), jnp.asarray(ptr),
        jnp.asarray(dist),
    )


def build_links(table: KmerTable) -> Links:
    """Phase A: successor/predecessor maps + cycle-broken list ranking.

    Host-blocked: the successor resolve (the HBM-heavy part — a 5-operand
    sort-merge join per block) runs LINK_BLOCK_NODES nodes at a time; the
    pointer-doubling ranking runs on device below RANK_DEVICE_MAX_NODES and
    host-side above it (see the constant's note)."""
    m = table.words.a.shape[0]
    n2 = 2 * m
    blk = min(LINK_BLOCK_NODES, _round_up(n2, 1024))
    ind = _indeg8(table)
    if n2 <= blk and n2 <= RANK_DEVICE_MAX_NODES:
        nxt = _links_block(table, ind, jnp.asarray(0, I32), blk)[:n2]
        return _rank_links(nxt)
    parts = []
    for lo in range(0, n2, blk):
        b = _links_block(table, ind, jnp.asarray(lo, I32), blk)
        parts.append(np.asarray(b[: min(n2 - lo, blk)]))
    nxt = np.concatenate(parts)
    if n2 <= RANK_DEVICE_MAX_NODES:
        return _rank_links(jnp.asarray(nxt))
    return _rank_links_host(nxt)


def _edge_shape(links: Links, n_valid_rows: int):
    """Host-side scalars for phase B static shapes."""
    head = np.asarray(links.head)
    prev = np.asarray(links.prev)
    n2 = head.shape[0]
    u = np.arange(n2)
    valid = (u >> 1) < n_valid_rows
    heads = (prev == -1) & valid
    n_edges = int(heads.sum())
    n_nodes = int(valid.sum())
    flat = n_nodes + n_edges * (K - 1)
    return n_edges, flat


class DeviceGraph(NamedTuple):
    """Phase-B output: the unipath graph as device arrays (HBV analogue)."""

    edge_codes: jax.Array  # (FLAT,) int32 flat edge base codes
    edge_offsets: jax.Array  # (E+1,) int32 CSR
    inv: jax.Array  # (E,) int32 rc-twin edge
    is_circle: jax.Array  # (E,) bool
    from_v: jax.Array  # (E,) int32
    to_v: jax.Array  # (E,) int32
    n_vertices: jax.Array  # scalar int32
    node_edge: jax.Array  # (2M,) int32 edge containing oriented node
    node_pos: jax.Array  # (2M,) int32 kmer offset of node within edge
    n_edges: jax.Array  # scalar int32 true edge count (arrays are padded)


@partial(jax.jit, static_argnames=("e_pad", "flat_pad"))
def materialize_edges(
    table: KmerTable, links: Links, n_edges, e_pad: int, flat_pad: int
) -> DeviceGraph:
    """Phase B: build edge sequences, involution, vertices, node->edge map.

    n_edges is a traced scalar; e_pad/flat_pad are bucketed static shapes so
    different inputs share one compiled program.
    """
    m = table.words.a.shape[0]
    n2 = 2 * m
    u = jnp.arange(n2, dtype=I32)
    n_edges = jnp.asarray(n_edges, I32)

    # sort nodes by (head, dist): chains contiguous, valid chains first
    # (invalid rows sit at table tail, so their node/head ids are larger)
    hs, ds, us = jax.lax.sort(
        (links.head, links.dist, u), num_keys=2, is_stable=True
    )
    starts = ds == 0
    eid = jnp.cumsum(starts.astype(I32)) - 1  # edge id per sorted node
    in_edge = eid < n_edges

    w = jnp.where(starts, K, 1) * in_edge.astype(I32)
    out_pos = jnp.cumsum(w) - w
    flat_true = jnp.sum(w)

    ow = oriented_words(table.words, us)
    last = kc.last_base(ow)

    codes = jnp.zeros((flat_pad + 1,), I32)
    lb_pos = out_pos + (K - 1) * starts.astype(I32)
    codes = codes.at[jnp.where(in_edge, lb_pos, flat_pad)].set(last, mode="drop")
    # head prefixes: bases 0..K-2 of each CHAIN-START kmer.  Compact the
    # start rows first and unpack only those: a dense (2m, 47) base matrix
    # is node-scale and ran out of device memory in the 10 Mb run; the
    # compacted (e_pad, 47) matrix is edge-scale, not occurrence-scale.
    is_head = starts & in_edge
    ck, us_c, pos_c = jax.lax.sort(
        ((~is_head).astype(jnp.uint32), us, out_pos), num_keys=1,
        is_stable=True,
    )
    us_h, pos_h = us_c[:e_pad], pos_c[:e_pad]
    head_valid = jnp.arange(e_pad, dtype=I32) < n_edges
    bases48 = kc.unpack_bases(oriented_words(table.words, us_h))
    pj = pos_h[:, None] + jnp.arange(K - 1, dtype=I32)[None, :]
    idxm = jnp.where(head_valid[:, None], pj, flat_pad)
    codes = codes.at[idxm.reshape(-1)].set(
        bases48[:, : K - 1].reshape(-1), mode="drop"
    )
    codes = codes[:flat_pad]

    # per-edge offsets (edges are contiguous in the flat code array)
    eidc = jnp.minimum(eid, e_pad)  # clamp overflow chains into a dump slot
    e_start = seg.seg_min(
        jnp.where(in_edge, out_pos, flat_pad), eidc, e_pad + 1
    )[:e_pad]
    edge_offsets = jnp.where(
        jnp.arange(e_pad + 1) < n_edges,
        jnp.concatenate([e_start, jnp.zeros((1,), I32)]),
        flat_true,
    ).astype(I32)

    # head/tail node per edge
    last_in_seg = jnp.concatenate([starts[1:], jnp.array([True])])
    head_node = jnp.zeros((e_pad + 1,), I32).at[
        jnp.where(starts & in_edge, eidc, e_pad)
    ].set(us, mode="drop")[:e_pad]
    tail_node = jnp.zeros((e_pad + 1,), I32).at[
        jnp.where(last_in_seg & in_edge, eidc, e_pad)
    ].set(us, mode="drop")[:e_pad]

    # node -> (edge, pos) map
    node_edge = jnp.full((n2,), -1, I32).at[us].set(jnp.where(in_edge, eid, -1))
    node_pos = jnp.zeros((n2,), I32).at[us].set(ds)

    # involution: edge of the rc twin of our head node
    inv = node_edge[head_node ^ 1]
    is_circle = links.next[tail_node] >= 0

    # vertices: 47-mer junction keys ("47 bases + trailing 0" word format);
    # rows past n_edges get sentinel keys and sort to the tail
    erow = jnp.arange(e_pad, dtype=I32)
    evalid = erow < n_edges
    hw = oriented_words(table.words, head_node)
    tw = oriented_words(table.words, tail_node)
    from_key = W3(hw.a, hw.b, hw.c & np.uint32(0xFFFFFFFC))
    to_key = kc.successor_words(tw, jnp.zeros((e_pad,), I32))
    from_key = from_key.where(evalid, kc.SENTINEL)
    to_key = to_key.where(evalid, kc.SENTINEL)
    both = W3(
        jnp.concatenate([from_key.a, to_key.a]),
        jnp.concatenate([from_key.b, to_key.b]),
        jnp.concatenate([from_key.c, to_key.c]),
    )
    vsort, _, _ = kc.sort_by_words(both)
    vstarts = seg.run_starts(vsort.a, vsort.b, vsort.c)
    real = ~kc.is_sentinel(vsort)
    n_vertices = jnp.sum((vstarts & real).astype(I32))
    # unique vertex table = first row of each run; ids by sorted order
    vid_of_sorted = jnp.cumsum(vstarts.astype(I32)) - 1
    fpos, _ = kc.searchsorted_words(vsort, from_key)
    tpos, _ = kc.searchsorted_words(vsort, to_key)
    from_v = vid_of_sorted[fpos]
    to_v = vid_of_sorted[tpos]

    return DeviceGraph(
        codes,
        edge_offsets,
        inv,
        is_circle,
        from_v,
        to_v,
        n_vertices,
        node_edge,
        node_pos,
        n_edges,
    )


def geom_bucket(n: int, quantum: int = 1024, ratio: float = 1.25) -> int:
    """Round n up to a value from a fixed geometric ladder (quantum,
    ~quantum*ratio^k).  Downstream programs are compiled per padded shape
    and each fresh shape costs a compile, so nearby sizes (e.g. the main kmer table at 31.1M rows and the
    patch-rebuild table at 30.4M) must land on the SAME padded shape to
    share every compiled program (build, dictionary pathing).  Worst-case
    padding overhead is ratio-1 (~25%) of cheap table rows."""
    m = quantum
    while m < n:
        m = -(-int(m * ratio) // quantum) * quantum
    return m


def trim_table(table: KmerTable, pad_multiple: int = 1024) -> KmerTable:
    """Host-side stage-boundary repack: shrink the padded table to a
    geometric-ladder row count (the count stage pads to #positions)."""
    n = int(table.n_valid)
    m = geom_bucket(max(n, 1), pad_multiple)
    words = np.full((m, 3), kc.SENTINEL, dtype=np.uint32)
    words[:n] = kc.soa_to_np(table.words)[:n]

    def sl(a):
        a = np.asarray(a)[:m]
        if len(a) < m:  # incoming table may be padded coarser OR finer
            a = np.concatenate([a, np.zeros(m - len(a), a.dtype)])
        return jnp.asarray(a)
    return KmerTable(
        kc.np_to_soa(words),
        sl(table.count),
        sl(table.nbc),
        sl(table.left_mask),
        sl(table.right_mask),
        jnp.asarray(n, I32),
    )


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def build_graph(table: KmerTable) -> DeviceGraph:
    """Host entry: trimmed KmerTable -> DeviceGraph (two-phase)."""
    links = build_links(table)
    n_edges, flat = _edge_shape(links, int(table.n_valid))
    e_pad = geom_bucket(n_edges + 1, 512)
    flat_pad = geom_bucket(flat + 1, 16384)
    return materialize_edges(table, links, n_edges, e_pad, flat_pad)
