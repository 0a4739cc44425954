"""Multi-chip read pathing: data-parallel reads, replicated graph dictionary.

The pathing workload (align/pather.py) is embarrassingly parallel over
reads; the kmer->(edge,pos) dictionary is replicated (it is ~100x smaller
than the occurrence stream).  Under shard_map each device paths its read
block; outputs stay sharded by read block.  For dictionaries too large to
replicate, sharded_path_vs shards it by kmer hash and routes each lookup
to its owner shard with an all_to_all.
"""
from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import PartitionSpec as P

from ..align.pather import MAX_PATH, ReadPaths, path_reads
from ..core.kmer_codec import W3
from .mesh import AXIS


@partial(jax.jit, static_argnames=("mesh", "max_path"))
def sharded_path(
    mesh,
    kmer_words: W3,  # replicated dictionary
    node_edge,
    node_pos,
    from_v,  # replicated graph adjacency (junction validation)
    to_v,
    edge_kmers,
    codes_ext,  # (n_dev * (NBL+pad),) sharded
    read_offsets,  # (n_dev * (RL+1),) sharded (block-local offsets)
    pos_read,  # (n_dev * NBL,) sharded (block-local read ids)
    rlen_pos,  # (n_dev * NBL,) sharded
    max_path: int = MAX_PATH,
) -> ReadPaths:
    fn = partial(path_reads, max_path=max_path)
    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(
            W3(P(), P(), P()),  # dictionary replicated
            P(),
            P(),
            P(),
            P(),
            P(),
            P(AXIS),
            P(AXIS),
            P(AXIS),
            P(AXIS),
        ),
        out_specs=ReadPaths(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
    )(
        kmer_words,
        node_edge,
        node_pos,
        from_v,
        to_v,
        edge_kmers,
        codes_ext,
        read_offsets,
        pos_read,
        rlen_pos,
    )


def split_for_pathing(rs, n_dev: int, base_bucket: int = 16384, read_bucket: int = 1024):
    """Per-device blocks for pathing (same split as counting, plus block
    read lengths and block-local offsets)."""
    from ..core.kmer_codec import K
    from ..kmer.count import _round_up

    pairs = rs.n_pairs
    per = -(-pairs // n_dev)
    blocks = []
    max_nb, max_r = 1, 1
    for dvc in range(n_dev):
        lo, hi = dvc * per * 2, min((dvc + 1) * per * 2, rs.n_reads)
        lo = min(lo, rs.n_reads)
        idx = np.arange(lo, hi)
        lens = np.diff(rs.offsets)[idx] if len(idx) else np.zeros(0, np.int64)
        blocks.append((idx, lens))
        max_nb = max(max_nb, int(lens.sum()))
        max_r = max(max_r, len(idx))
    nbl = _round_up(max_nb, base_bucket)
    rl = _round_up(max_r + 1, read_bucket)

    def pack(idx, lens):
        nb = int(lens.sum())
        codes = np.zeros(nbl + max(K, 128), np.int32)
        pr = np.full(nbl, len(idx), np.int32)
        off = np.full(rl + 1, nb, np.int32)
        rlen = np.zeros(nbl, np.int32)
        if len(idx):
            starts = rs.offsets[idx]
            codes[:nb] = np.concatenate(
                [rs.codes[s : s + l] for s, l in zip(starts, lens)]
            )
            pr[:nb] = np.repeat(np.arange(len(idx), dtype=np.int32), lens)
            off[: len(idx) + 1] = np.concatenate([[0], np.cumsum(lens)])
            rlen[:nb] = np.repeat(lens.astype(np.int32), lens)
        return codes, off, pr, rlen

    packed = [pack(i, l) for i, l in blocks]
    cat = lambda k: np.concatenate([p[k] for p in packed])
    return cat(0), cat(1), cat(2), cat(3), nbl, rl, [b[0] for b in blocks]


# ----------------------------------- value-sharded dictionary (pod scale)

def shard_dictionary(kmer_words: W3, node_edge, node_pos, n_dev: int):
    """Partition the sorted kmer dictionary by kmer_shard_hash % n_dev —
    the pod-scale layout where no device holds the whole table (at 3 Gb
    the kmer->(edge,pos) dict is tens of GB; sharding it is what the
    replicated sharded_path above cannot do).

    Host-side prep.  Returns (words (n_dev*L,) W3 columns, node_edge
    (n_dev*2L,), node_pos (n_dev*2L,), L) where each device's L-row slice
    is sorted with SENTINEL padding, and node ids are shard-local
    (node = 2*local_row + flip)."""
    import jax.numpy as jnp

    from ..core import kmer_codec as kc
    from .sharded_count import kmer_shard_hash

    wa = np.asarray(kmer_words.a)
    wb = np.asarray(kmer_words.b)
    wc = np.asarray(kmer_words.c)
    ne = np.asarray(node_edge)
    npo = np.asarray(node_pos)
    real = wa != np.uint32(kc.SENTINEL)
    h = np.asarray(
        kmer_shard_hash(W3(jnp.asarray(wa), jnp.asarray(wb), jnp.asarray(wc)))
    )
    shard = np.where(real, h % np.uint32(n_dev), np.uint32(n_dev))
    sizes = [int((shard == s).sum()) for s in range(n_dev)]
    L = -(-max(max(sizes), 1) // 1024) * 1024
    was = np.full((n_dev, L), kc.SENTINEL, np.uint32)
    wbs = np.full((n_dev, L), kc.SENTINEL, np.uint32)
    wcs = np.full((n_dev, L), kc.SENTINEL, np.uint32)
    nes = np.full((n_dev, 2 * L), -1, np.int32)
    nps = np.zeros((n_dev, 2 * L), np.int32)
    for s in range(n_dev):
        gidx = np.nonzero(shard == s)[0]  # increasing -> slice stays sorted
        k = len(gidx)
        was[s, :k] = wa[gidx]
        wbs[s, :k] = wb[gidx]
        wcs[s, :k] = wc[gidx]
        nes[s, 0 : 2 * k : 2] = ne[2 * gidx]
        nes[s, 1 : 2 * k : 2] = ne[2 * gidx + 1]
        nps[s, 0 : 2 * k : 2] = npo[2 * gidx]
        nps[s, 1 : 2 * k : 2] = npo[2 * gidx + 1]
    return (
        W3(was.reshape(-1), wbs.reshape(-1), wcs.reshape(-1)),
        nes.reshape(-1),
        nps.reshape(-1),
        L,
    )


def _dist_resolve(words_sh, ne_sh, np_sh, n_dev: int, cap: int, canon, flipped):
    """Distributed dictionary resolve under shard_map: route each query
    kmer to its hash-owner shard (dense fixed-capacity all_to_all, the
    XLA:CPU-compatible layout), answer with a shard-local sort-merge join,
    and return answers to the querying device through the inverse
    all_to_all.  -> (edge, epos, found) in the caller's row order.

    Lost queries (per-owner capacity overflow) resolve as not-found —
    harmless for pathing (a missed kmer behaves like an error kmer) but
    capacity should be sized ~2x the balanced load.  A ragged_all_to_all
    round trip is a follow-up; the dense exchange is correct on both
    backends."""
    import jax.numpy as jnp

    from ..core import kmer_codec as kc
    from .sharded_count import kmer_shard_hash

    U32 = jnp.uint32
    I32 = jnp.int32
    nbl = canon.a.shape[0]
    cap_per = -(-cap // n_dev)

    shard = kmer_shard_hash(canon) % np.uint32(n_dev)
    pp0 = jnp.arange(nbl, dtype=U32)
    sh_s, w0, w1, w2, fl_s, pp = jax.lax.sort(
        (shard, canon.a, canon.b, canon.c,
         flipped.astype(U32), pp0),
        num_keys=1, is_stable=True,
    )
    counts = jax.ops.segment_sum(
        jnp.ones((nbl,), I32), sh_s.astype(I32), num_segments=n_dev,
        indices_are_sorted=True,
    )
    input_offsets = jnp.cumsum(counts) - counts
    rank = jnp.arange(nbl, dtype=I32) - input_offsets[sh_s.astype(I32)]
    ok = rank < cap_per
    idx = jnp.where(ok, sh_s.astype(I32) * cap_per + rank, n_dev * cap_per)

    def fwd(col, fill):
        buf = jnp.full((n_dev * cap_per,), fill, col.dtype)
        buf = buf.at[idx].set(col, mode="drop")
        return jax.lax.all_to_all(
            buf.reshape(n_dev, cap_per), AXIS, 0, 0, tiled=False
        ).reshape(n_dev * cap_per)

    qa = fwd(w0, np.uint32(kc.SENTINEL))
    qb = fwd(w1, np.uint32(kc.SENTINEL))
    qc = fwd(w2, np.uint32(kc.SENTINEL))
    qf = fwd(fl_s, np.uint32(0))

    # owner-side answer
    row, found = kc.lookup_words_merge(W3(words_sh.a, words_sh.b, words_sh.c),
                                       W3(qa, qb, qc))
    node = 2 * row + qf.astype(I32)
    edge = jnp.where(found, ne_sh[node], -1)
    epos = jnp.where(found, np_sh[node], 0)

    def back(col):
        return jax.lax.all_to_all(
            col.reshape(n_dev, cap_per), AXIS, 0, 0, tiled=False
        ).reshape(n_dev * cap_per)

    ans_e = back((edge + 1).astype(U32))  # not-found/pad -> 0
    ans_p = back(epos.astype(U32))

    # unpack: sorted-row j's answer sits at slot idx[j]; un-sort via pp
    e_sorted = jnp.where(ok, ans_e[jnp.minimum(idx, n_dev * cap_per - 1)], 0)
    p_sorted = jnp.where(ok, ans_p[jnp.minimum(idx, n_dev * cap_per - 1)], 0)
    out_e = jnp.zeros((nbl,), U32).at[pp].set(e_sorted, mode="drop")
    out_p = jnp.zeros((nbl,), U32).at[pp].set(p_sorted, mode="drop")
    edge_q = out_e.astype(I32) - 1
    return edge_q, out_p.astype(I32), edge_q >= 0


@partial(jax.jit, static_argnames=("mesh", "n_dev", "shard_rows", "capacity",
                                   "max_path", "uniform_rl"))
def sharded_path_vs(
    mesh,
    dict_words: W3,  # (n_dev * L,) hash-sharded sorted dictionary
    dict_node_edge,  # (n_dev * 2L,)
    dict_node_pos,  # (n_dev * 2L,)
    from_v,  # replicated edge-scale graph adjacency
    to_v,
    edge_kmers,
    codes_ext,  # (n_dev * (NBL+pad),) sharded read blocks
    read_offsets,
    pos_read,
    rlen_pos,
    n_dev: int,
    shard_rows: int,  # L
    capacity: int,  # per-device query exchange capacity
    max_path: int = MAX_PATH,
    uniform_rl: int | None = None,
) -> ReadPaths:
    """Value-SHARDED multi-chip pathing: reads data-parallel AND the
    kmer->(edge,pos) dictionary hash-sharded across the mesh — no device
    holds the full table (the pod-scale memory story; the replicated
    sharded_path stays the fast path for single-host meshes).  Lookup
    queries ride a dense all-to-all to their owner shard and answers ride
    the inverse exchange; results are bit-identical to path_reads."""
    from ..align.pather import path_reads_impl

    def body(words_sh, ne_sh, np_sh, fv, tv, ek, codes, offs, pr, rl):
        resolve = partial(
            _dist_resolve, words_sh, ne_sh, np_sh, n_dev, capacity
        )
        return path_reads_impl(
            resolve, fv, tv, ek, codes, offs, pr, rl,
            max_path=max_path, uniform_rl=uniform_rl,
        )

    return jax.shard_map(
        body,
        mesh=mesh,
        check_vma=False,
        in_specs=(
            W3(P(AXIS), P(AXIS), P(AXIS)),
            P(AXIS),
            P(AXIS),
            P(),
            P(),
            P(),
            P(AXIS),
            P(AXIS),
            P(AXIS),
            P(AXIS),
        ),
        out_specs=ReadPaths(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
    )(
        dict_words,
        dict_node_edge,
        dict_node_pos,
        from_v,
        to_v,
        edge_kmers,
        codes_ext,
        read_offsets,
        pos_read,
        rlen_pos,
    )
