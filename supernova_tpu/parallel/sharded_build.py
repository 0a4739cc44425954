"""Multi-chip unipath graph build over the hash-sharded kmer table.

Mesh re-expression of SURVEY.md §5.7: the kmer table stays sharded by
kmer hash (as produced by sharded_count); the unipath link structure and the
list ranking run distributed:

  1. successor/predecessor resolution — each oriented node's neighbor kmer
     is owned by hash; queries travel to the owner shard with all_to_all,
     the owner answers with the neighbor's global node id and its degree
     check, so links form without any shard ever holding the full table;
  2. pointer-doubling list ranking — ptr/dist/min arrays live sharded by
     node id; each doubling step is a distributed gather (index exchange to
     the owner, value exchange back).  log2(N) rounds, each two all_to_alls
     — this is the sedge-gluing neighbor exchange of the reference's shard
     design (cmd_shard_asm.rs) expressed as mesh collectives.

Every exchange runs in one of two modes (picked by backend, like
parallel/sharded_count.py): ragged_all_to_all on the GPU (only real rows
move; only the TOTAL per receiver must fit the buffer) or the dense
fixed-capacity all_to_all on XLA:CPU, which lacks the ragged-all-to-all
thunk.

After the distributed phase, compact_links() drops the per-shard padding,
re-sorts rows lexicographically, and remaps node ids — yielding the SAME
table + Links the single-device build produces (materialize_edges then runs
unchanged), which is the bit-exactness hook the tests use.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..core import kmer_codec as kc
from ..core.jaxconfig import on_accelerator
from ..core.kmer_codec import W3
from ..dbg.build import Links, popcount4, single_bit_index
from ..kmer.count import KmerTable, rev4
from .mesh import AXIS
from .sharded_count import kmer_shard_hash

I32 = jnp.int32
U32 = jnp.uint32


def _exchange(cols, owner, n_dev: int, cap_per: int, fills, use_ragged: bool = False):
    """Route rows to their owner shard: sort by owner, exchange.  Returns
    (received cols, ctx) where ctx drives the return trip.

    Dense mode pads every destination block to cap_per and always moves
    n_dev*cap_per rows (XLA:CPU fallback — no ragged-all-to-all thunk).
    Ragged mode (GPU) moves only the real rows with ragged_all_to_all into
    the same n_dev*cap_per receive buffer: no padding traffic, and only the
    TOTAL (not per-destination) has to fit — strictly fewer drops."""
    n = owner.shape[0]
    perm0 = jnp.arange(n, dtype=I32)
    owner_s, perm = jax.lax.sort((owner.astype(I32), perm0), num_keys=1, is_stable=True)
    counts = jax.ops.segment_sum(
        jnp.ones((n,), I32), owner_s, num_segments=n_dev + 1,
        indices_are_sorted=True,
    )[:n_dev]
    offs = jnp.cumsum(counts) - counts

    if use_ragged:
        capacity = n_dev * cap_per
        S = jax.lax.all_gather(counts, AXIS)  # (sender, dest)
        me = jax.lax.axis_index(AXIS)
        recv_sizes = S[:, me]  # from each sender
        col_excl = jnp.cumsum(S, axis=0) - S  # my block's remote offset
        out_offs = col_excl[me, :]
        received = [
            jax.lax.ragged_all_to_all(
                col[perm],
                jnp.full((capacity,), fill, col.dtype),
                offs.astype(I32), counts.astype(I32),
                out_offs.astype(I32), recv_sizes.astype(I32),
                axis_name=AXIS,
            )
            for col, fill in zip(cols, fills)
        ]
        return received, ("ragged", perm, offs, counts, S, n)

    rank = jnp.arange(n, dtype=I32) - offs[jnp.minimum(owner_s, n_dev - 1)]
    ok = (owner_s < n_dev) & (rank < cap_per)
    slot = jnp.where(ok, jnp.minimum(owner_s, n_dev - 1) * cap_per + rank, n_dev * cap_per)

    received = []
    for col, fill in zip(cols, fills):
        buf = jnp.full((n_dev * cap_per,), fill, col.dtype)
        buf = buf.at[slot].set(col[perm], mode="drop")
        received.append(
            jax.lax.all_to_all(
                buf.reshape(n_dev, cap_per), AXIS, 0, 0, tiled=False
            ).reshape(n_dev * cap_per)
        )
    return received, ("dense", slot, perm, n, cap_per)


def _return(resp, ctx, n_dev: int, fill):
    """Send per-row responses back to the requesting shard and restore the
    original row order (inverse of _exchange)."""
    if ctx[0] == "ragged":
        _, perm, offs, counts, S, n = ctx
        me = jax.lax.axis_index(AXIS)
        col_excl = jnp.cumsum(S, axis=0) - S
        row_excl = jnp.cumsum(S, axis=1) - S
        # I (owner) send sender s's response block back: it sits at
        # col_excl[s, me] in my buffer, sized S[s, me], and lands at
        # row_excl[s, me] in s's owner-sorted query order.
        back = jax.lax.ragged_all_to_all(
            resp,
            jnp.full((n,), fill, resp.dtype),
            col_excl[:, me].astype(I32), S[:, me].astype(I32),
            row_excl[:, me].astype(I32), counts.astype(I32),
            axis_name=AXIS,
        )
        return jnp.full((n,), fill, resp.dtype).at[perm].set(back)

    _, slot, perm, n, cap_per = ctx
    back = jax.lax.all_to_all(
        resp.reshape(n_dev, cap_per), AXIS, 0, 0, tiled=False
    ).reshape(n_dev * cap_per)
    safe = jnp.minimum(slot, n_dev * cap_per - 1)
    vals = back[safe]
    vals = jnp.where(slot < n_dev * cap_per, vals, fill)
    return jnp.full((n,), fill, resp.dtype).at[perm].set(vals)


def _neighbor_query(words: W3, flip, degree_mask_pick, table: KmerTable, n_dev, cap, cap_per, use_ragged=False):
    """Resolve neighbor kmers on their owner shard -> global oriented node
    id, or -1 (absent / wrong degree).  degree_mask_pick chooses which mask
    bounds the neighbor's degree ('in' for successor links, 'out' for
    predecessor links)."""
    owner = kmer_shard_hash(words) % np.uint32(n_dev)
    cols = (words.a, words.b, words.c, flip.astype(U32))
    fills = (kc.SENTINEL, kc.SENTINEL, kc.SENTINEL, np.uint32(0))
    (qa, qb, qc, qf), ctx = _exchange(cols, owner, n_dev, cap_per, fills, use_ragged)

    qw = W3(qa, qb, qc)
    srow, found = kc.lookup_words_merge(table.words, qw)
    qflip = qf.astype(I32) & 1
    if degree_mask_pick is None:  # membership only (adjacency recompute)
        deg_ok = True
    else:
        lm = table.left_mask[srow]
        rm = table.right_mask[srow]
        if degree_mask_pick == "in":
            mask = jnp.where(qflip == 0, lm, rev4(rm))
        else:
            mask = jnp.where(qflip == 0, rm, rev4(lm))
        deg_ok = popcount4(mask) == 1
    me = jax.lax.axis_index(AXIS)
    grow = (me.astype(I32) * cap + srow).astype(I32)
    v = jnp.where(found & deg_ok, 2 * grow + qflip, -1)
    return _return(v, ctx, n_dev, jnp.asarray(-1, I32))


def _dist_gather(vals, idx, n_dev: int, cap: int, cap_per: int, use_ragged=False):
    """Distributed vals[idx]: idx are global node ids; vals is the local
    shard's slice (2*cap,).  Owner of node u = (u>>1)//cap."""
    owner = ((idx >> 1) // cap).astype(U32)
    cols = (idx.astype(U32),)
    (qi,), ctx = _exchange(cols, owner, n_dev, cap_per, (np.uint32(0),), use_ragged)
    me = jax.lax.axis_index(AXIS).astype(I32)
    local = qi.astype(I32) - me * 2 * cap
    safe = jnp.clip(local, 0, 2 * cap - 1)
    resp = vals[safe]
    return _return(resp, ctx, n_dev, jnp.asarray(0, I32))


def _links_local(
    wa, wb, wc, count, nbc, lmask, rmask, nvalid, n_dev: int, cap: int,
    steps: int, use_ragged: bool = False,
):
    """Per-shard body: distributed adjacency recompute + build_links
    (kmer/count.py recompute_adjacencies + dbg/build.py:66-117)."""
    n2 = 2 * cap
    me = jax.lax.axis_index(AXIS).astype(I32)
    u_local = jnp.arange(n2, dtype=I32)
    u = me * n2 + u_local  # global oriented node id
    row = u_local >> 1
    d = u_local & 1
    valid = row < nvalid[0]
    cap_per_m = -(-cap // n_dev) * 2

    # adjacency recompute, distributed: keep a context bit only if the
    # neighbor kmer survives in (some shard of) the table
    rw = W3(wa, wb, wc)
    table0 = KmerTable(rw, count, nbc, lmask, rmask, nvalid)
    new_r = jnp.zeros_like(rmask)
    new_l = jnp.zeros_like(lmask)
    for x in range(4):
        xs = jnp.full((cap,), x, I32)
        sc, sf = kc.canonicalize(kc.successor_words(rw, xs))
        sm = _neighbor_query(sc, sf, None, table0, n_dev, cap, cap_per_m, use_ragged) >= 0
        new_r = new_r | jnp.where(
            sm & (((rmask >> x) & 1) == 1), 1 << x, 0
        ).astype(rmask.dtype)
        pc, pf = kc.canonicalize(kc.predecessor_words(rw, xs))
        pm = _neighbor_query(pc, pf, None, table0, n_dev, cap, cap_per_m, use_ragged) >= 0
        new_l = new_l | jnp.where(
            pm & (((lmask >> x) & 1) == 1), 1 << x, 0
        ).astype(lmask.dtype)
    lmask, rmask = new_l, new_r
    table = KmerTable(rw, count, nbc, lmask, rmask, nvalid)

    lm = lmask[row]
    rm = rmask[row]
    out_mask = jnp.where(d == 0, rm, rev4(lm))
    in_mask = jnp.where(d == 0, lm, rev4(rm))
    outdeg = popcount4(out_mask)
    indeg = popcount4(in_mask)

    w = table.words.gather(row)
    ow = kc.rc_words(w).where(d == 1, w)

    # hash routing is uniform for neighbor queries (2x slack); pointer
    # gathers can concentrate on chain-head owners, so they use the
    # drop-free full capacity (the ragged path replaces both with
    # ragged_all_to_all)
    cap_per_q = -(-n2 // n_dev) * 2
    cap_per = n2
    # successor link: succ kmer exists, its indeg == 1
    b = single_bit_index(out_mask)
    succ = kc.successor_words(ow, b)
    canon, flip = kc.canonicalize(succ)
    v = _neighbor_query(canon, flip, "in", table, n_dev, cap, cap_per_q, use_ragged)
    link_ok = (outdeg == 1) & valid & (v >= 0) & (v != u)
    nxt = jnp.where(link_ok, v, -1)

    # predecessor link: pred kmer exists, its outdeg == 1
    pb = single_bit_index(in_mask)
    pred = kc.predecessor_words(ow, pb)
    pcanon, pflip = kc.canonicalize(pred)
    pw = _neighbor_query(pcanon, pflip, "out", table, n_dev, cap, cap_per_q, use_ragged)
    prv_ok = (indeg == 1) & valid & (pw >= 0) & (pw != u)
    prv = jnp.where(prv_ok, pw, -1)

    # cycle detection + break at cycle-min node (global ids)
    ptr = jnp.where(prv >= 0, prv, u)
    mn = u

    def cyc_body(_, st):
        ptr, mn = st
        ptr2 = _dist_gather(ptr, ptr, n_dev, cap, cap_per, use_ragged)
        mnp = _dist_gather(mn, ptr, n_dev, cap, cap_per, use_ragged)
        return ptr2, jnp.minimum(mn, mnp)

    ptr, mn = jax.lax.fori_loop(0, steps, cyc_body, (ptr, mn))
    prv_at_ptr = _dist_gather(prv, ptr, n_dev, cap, cap_per, use_ragged)
    in_cycle = prv_at_ptr >= 0
    prv = jnp.where(in_cycle & (u == mn), -1, prv)

    # list ranking by pointer doubling
    ptr = jnp.where(prv >= 0, prv, u)
    dist = (prv >= 0).astype(I32)

    def rank_body(_, st):
        ptr, dist = st
        dp = _dist_gather(dist, ptr, n_dev, cap, cap_per, use_ragged)
        ptr2 = _dist_gather(ptr, ptr, n_dev, cap, cap_per, use_ragged)
        return ptr2, dist + dp

    ptr, dist = jax.lax.fori_loop(0, steps, rank_body, (ptr, dist))
    return nxt, prv, ptr, dist, lmask, rmask


@partial(jax.jit, static_argnames=("mesh", "n_dev", "cap", "steps", "use_ragged"))
def sharded_links(mesh, tables_stacked: KmerTable, n_dev: int, cap: int,
                  steps: int, use_ragged: bool | None = None):
    """Distributed Links over the sharded table (global node ids)."""
    if use_ragged is None:
        use_ragged = on_accelerator()
    fn = partial(_links_local, n_dev=n_dev, cap=cap, steps=steps,
                 use_ragged=use_ragged)
    return jax.shard_map(
        fn,
        mesh=mesh,
        check_vma=False,
        in_specs=(P(AXIS),) * 8,
        out_specs=(P(AXIS),) * 6,
    )(
        tables_stacked.words.a,
        tables_stacked.words.b,
        tables_stacked.words.c,
        tables_stacked.count,
        tables_stacked.nbc,
        tables_stacked.left_mask,
        tables_stacked.right_mask,
        tables_stacked.n_valid,
    )


def compact_links(tables_stacked: KmerTable, links6, pad_multiple: int = 256):
    """Host: drop per-shard padding, lex-sort rows, remap node ids.
    Returns (merged KmerTable, Links) identical to the single-device pair
    (the masks are the recomputed ones from the distributed phase)."""
    from .dist import host_fetch

    nxt, prv, head, dist, new_l, new_r = (host_fetch(x) for x in links6)
    nv = host_fetch(tables_stacked.n_valid)
    n_dev = len(nv)
    cap = tables_stacked.count.shape[0] // n_dev  # global shape

    wa = host_fetch(tables_stacked.words.a).reshape(n_dev, cap)
    wb = host_fetch(tables_stacked.words.b).reshape(n_dev, cap)
    wc = host_fetch(tables_stacked.words.c).reshape(n_dev, cap)
    count = host_fetch(tables_stacked.count).reshape(n_dev, cap)
    nbc = host_fetch(tables_stacked.nbc).reshape(n_dev, cap)
    lmk = new_l.reshape(n_dev, cap)
    rmk = new_r.reshape(n_dev, cap)

    valid_rows = [(s, r) for s in range(n_dev) for r in range(int(nv[s]))]
    n = len(valid_rows)
    a = np.array([wa[s, r] for s, r in valid_rows], np.uint32)
    b = np.array([wb[s, r] for s, r in valid_rows], np.uint32)
    c = np.array([wc[s, r] for s, r in valid_rows], np.uint32)
    order = np.lexsort((c, b, a))
    m = max(pad_multiple, -(-n // pad_multiple) * pad_multiple)

    # old global row (s*cap+r) -> new row (sorted position)
    old_rows = np.array([s * cap + r for s, r in valid_rows], np.int64)[order]
    new_of_old = np.full(n_dev * cap, -1, np.int64)
    new_of_old[old_rows] = np.arange(n)

    def remap_nodes(arr2):
        """old global node id array (per old node slots) -> new ids."""
        out = np.full(2 * m, -1, np.int32)
        old_u = 2 * old_rows[:, None] + np.array([0, 1])[None, :]
        vals = arr2.reshape(-1)[old_u.reshape(-1)]
        node_ok = vals >= 0
        vrow = new_of_old[np.clip(vals >> 1, 0, n_dev * cap - 1)]
        mapped = np.where(node_ok & (vrow >= 0), 2 * vrow + (vals & 1), -1)
        out[: 2 * n] = mapped
        return out

    words = np.full((m, 3), kc.SENTINEL, np.uint32)
    words[:n, 0] = a[order]
    words[:n, 1] = b[order]
    words[:n, 2] = c[order]
    pick = lambda g: np.concatenate(
        [g.reshape(-1)[old_rows], np.zeros(m - n, g.dtype)]
    )
    table = KmerTable(
        kc.np_to_soa(words),
        jnp.asarray(pick(count)),
        jnp.asarray(pick(nbc)),
        jnp.asarray(pick(lmk)),
        jnp.asarray(pick(rmk)),
        jnp.asarray(n, I32),
    )

    new_next = remap_nodes(nxt)
    new_prv = remap_nodes(prv)
    # head: every node has a head (itself if chain head) — remap via rows;
    # heads of valid nodes are always valid nodes
    hd = head.reshape(-1)
    old_u = (2 * old_rows[:, None] + np.array([0, 1])[None, :]).reshape(-1)
    hvals = hd[old_u]
    hrow = new_of_old[np.clip(hvals >> 1, 0, n_dev * cap - 1)]
    new_head = np.full(2 * m, 0, np.int32)
    new_head[: 2 * n] = 2 * hrow + (hvals & 1)
    # invalid tail nodes head to themselves (as in single-device build)
    tailu = np.arange(2 * n, 2 * m, dtype=np.int32)
    new_head[2 * n :] = tailu
    new_dist = np.zeros(2 * m, np.int32)
    new_dist[: 2 * n] = dist.reshape(-1)[old_u]
    return table, Links(
        jnp.asarray(new_next),
        jnp.asarray(new_prv),
        jnp.asarray(new_head),
        jnp.asarray(new_dist),
    )


def trim_shard_tables(tables_stacked: KmerTable, n_dev: int,
                      pad_multiple: int = 1024) -> KmerTable:
    """Host-side stage-boundary repack of the STACKED shard tables: slice
    every shard from the count stage's occurrence-scale capacity (4x
    positions/device) down to a shared distinct-kmer-scale row count.

    Without this, the distributed links phase inherits the count
    capacity: its drop-free pointer gathers materialize n_dev*cap receive
    rows per device per column, which on an 8-virtual-device shared-RAM
    CPU mesh was the Mb-scale pipeline memory pathology (77 GB RSS at a
    300 kb genome whose shards hold ~40k real kmers in 7.2M-row pads)."""
    from ..dbg.build import geom_bucket
    from .dist import host_fetch

    nv = host_fetch(tables_stacked.n_valid)
    cap = host_fetch(tables_stacked.count).shape[0] // n_dev
    m = geom_bucket(max(1, int(np.max(nv))), pad_multiple)
    if m >= cap:
        return tables_stacked

    def sl(x):
        return np.ascontiguousarray(
            host_fetch(x).reshape(n_dev, cap)[:, :m]
        ).reshape(-1)

    return KmerTable(
        W3(
            sl(tables_stacked.words.a),
            sl(tables_stacked.words.b),
            sl(tables_stacked.words.c),
        ),
        sl(tables_stacked.count),
        sl(tables_stacked.nbc),
        sl(tables_stacked.left_mask),
        sl(tables_stacked.right_mask),
        np.asarray(nv),
    )


def sharded_build_graph(mesh, tables_stacked: KmerTable, n_dev: int,
                        use_ragged: bool | None = None):
    """Host entry: sharded tables -> BaseGraph via distributed links +
    single-device materialization (edges are an output artifact)."""
    from ..dbg import graph as dgraph
    from ..dbg.build import _edge_shape, _round_up, materialize_edges

    tables_stacked = trim_shard_tables(tables_stacked, n_dev)
    cap = tables_stacked.count.shape[0] // n_dev  # global shape
    n2g = 2 * n_dev * cap
    steps = int(np.ceil(np.log2(max(n2g, 2)))) + 1
    links6 = sharded_links(mesh, tables_stacked, n_dev, cap, steps,
                           use_ragged=use_ragged)
    table, links = compact_links(tables_stacked, links6)
    n_edges, flat = _edge_shape(links, int(table.n_valid))
    e_pad = _round_up(n_edges + 1, 512)
    flat_pad = _round_up(flat + 1, 16384)
    dg = materialize_edges(table, links, n_edges, e_pad, flat_pad)
    return dgraph.from_device(dg, table)
