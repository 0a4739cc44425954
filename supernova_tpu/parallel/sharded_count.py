"""Multi-chip 48-mer counting: data-parallel reads, hash-sharded kmer space.

This is the mesh re-expression of the reference's MSP shuffle
(SURVEY.md §2.3 #2): reads are split across devices; each device extracts
canonical kmer occurrence rows; rows are exchanged with ragged_all_to_all
keyed on a kmer hash (every copy of a kmer lands on one shard, so
shard-local counting + filtering is exact — the same argument that makes
the reference's 8192 disk shards exact, cmd_msp.rs:4-9); each shard then
sorts + segment-reduces its slice of kmer space locally.

All exchanged buffers are flat 1-D uint32 vectors (kmer words as W3 columns
+ one packed attribute word) — never (N, k) matrices.

The result is a distributed KmerTable sharded by kmer hash.  merge_shard_
tables() re-sorts the (disjoint) shard tables into the single lexicographic
table the graph builder consumes.
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
from ..kmer.count import (
    BC_IGNORED,
    MIN_BC,
    MIN_FREQ,
    KmerTable,
    extract_occurrences,
    good_lengths_np,
    pack_occurrence_attrs,
    reduce_occurrences,
    unpack_occurrence_attrs,
)
from .mesh import AXIS

U32 = jnp.uint32
I32 = jnp.int32


def kmer_shard_hash(words: W3) -> jax.Array:
    """Mix the 3 kmer words into a well-distributed uint32 (murmur-style)."""
    c1, c2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)
    h = jnp.asarray(0x9E3779B9, U32)
    for wj in (words.a, words.b, words.c):
        k = wj * c1
        k = (k << np.uint32(15)) | (k >> np.uint32(17))
        k = k * c2
        h = h ^ k
        h = (h << np.uint32(13)) | (h >> np.uint32(19))
        h = h * np.uint32(5) + np.uint32(0xE6546B64)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    return h


def _sharded_count_local(
    codes_ext,
    pos_read,
    glen_pos,
    bc_pos,
    n_dev: int,
    capacity: int,
    min_freq: int,
    min_bc: int,
    use_ragged: bool,
    uniform_rl: int | None = None,
):
    """Per-device body (runs under shard_map over AXIS)."""
    canon, bc, lm, rm, valid = extract_occurrences(
        codes_ext, pos_read, glen_pos, bc_pos
    )
    packed = pack_occurrence_attrs(bc, lm, rm, valid)
    if uniform_rl is not None:
        from ..kmer.count import uniform_tail_cut

        a_, b_, c_, packed = uniform_tail_cut(
            uniform_rl, canon.a, canon.b, canon.c, packed
        )
        valid = ((packed >> np.uint32(1)) & np.uint32(1)) == 1
        canon = W3(a_, b_, c_).where(valid, kc.SENTINEL)
    nbl = canon.a.shape[0]

    shard = jnp.where(valid, kmer_shard_hash(canon) % np.uint32(n_dev), U32(n_dev))
    shard_s, w0, w1, w2, pk = jax.lax.sort(
        (shard, canon.a, canon.b, canon.c, packed), num_keys=1, is_stable=True
    )
    cols = (w0, w1, w2, pk)

    counts = jax.ops.segment_sum(
        jnp.ones((nbl,), I32), shard_s.astype(I32), num_segments=n_dev + 1,
        indices_are_sorted=True,
    )[:n_dev]
    input_offsets = jnp.cumsum(counts) - counts

    if use_ragged:
        # ragged all-to-all per column (flat vectors, no padding)
        S = jax.lax.all_gather(counts, AXIS)  # (n_dev, n_dev)
        me = jax.lax.axis_index(AXIS)
        recv_sizes = S[:, me]
        col_excl = jnp.cumsum(S, axis=0) - S  # exclusive cumsum over senders
        output_offsets = col_excl[me, :]
        received = tuple(
            jax.lax.ragged_all_to_all(
                col,
                jnp.zeros((capacity,), U32),
                input_offsets.astype(I32),
                counts.astype(I32),
                output_offsets.astype(I32),
                recv_sizes.astype(I32),
                axis_name=AXIS,
            )
            for col in cols
        )
        n_recv = jnp.sum(recv_sizes)
        row_ok = jnp.arange(capacity) < n_recv
        words = W3(received[0], received[1], received[2]).where(row_ok, kc.SENTINEL)
        rbc, rlm, rrm, rvalid = unpack_occurrence_attrs(received[3])
        rvalid = rvalid & row_ok
        overflow = jnp.maximum(n_recv - capacity, 0)
    else:
        # fallback (XLA:CPU has no ragged-all-to-all): fixed-capacity dense
        # exchange per column; padding rows carry sentinel words + valid=0,
        # which the reducer already ignores.
        cap_per = capacity // n_dev
        rank = jnp.arange(nbl, dtype=I32) - input_offsets[
            jnp.minimum(shard_s, n_dev - 1).astype(I32)
        ]
        ok = (shard_s < n_dev) & (rank < cap_per)
        flat_idx = jnp.minimum(shard_s, n_dev - 1).astype(I32) * cap_per + rank
        idx = jnp.where(ok, flat_idx, n_dev * cap_per)

        def exchange(col, fill):
            buf = jnp.full((n_dev * cap_per,), fill, U32)
            buf = buf.at[idx].set(col, mode="drop")
            return jax.lax.all_to_all(
                buf.reshape(n_dev, cap_per), AXIS, 0, 0, tiled=False
            ).reshape(n_dev * cap_per)

        ra = exchange(w0, kc.SENTINEL)
        rb = exchange(w1, kc.SENTINEL)
        rc_ = exchange(w2, kc.SENTINEL)
        rp = exchange(pk, np.uint32(0))
        words = W3(ra, rb, rc_)
        rbc, rlm, rrm, rvalid = unpack_occurrence_attrs(rp)
        dropped = jnp.sum(jnp.maximum(counts - cap_per, 0))
        overflow = jax.lax.psum(dropped, AXIS)

    table = reduce_occurrences(words, rbc, rlm, rrm, rvalid, min_freq, min_bc)
    # scalars -> (1,) so shard_map can stack them along the mesh axis
    table = table._replace(n_valid=table.n_valid.reshape(1))
    return table, overflow.reshape(1)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "n_dev", "capacity", "min_freq", "min_bc", "use_ragged",
        "uniform_rl",
    ),
)
def sharded_count(
    mesh,
    codes_ext,  # (n_dev * (NBL+pad),) sharded rows
    pos_read,  # (n_dev * NBL,)
    glen_pos,  # (n_dev * NBL,)
    bc_pos,  # (n_dev * NBL,)
    n_dev: int,
    capacity: int,
    min_freq: int = MIN_FREQ,
    min_bc: int = MIN_BC,
    use_ragged: bool | None = None,
    uniform_rl: int | None = None,
):
    """Jitted multi-device counting step: returns per-shard KmerTables
    (leading axis = shard, leaves concatenated) + per-shard overflow.

    use_ragged: ragged_all_to_all (GPU) vs fixed-capacity dense all_to_all
    (XLA:CPU lacks ragged-all-to-all); default: on an accelerator.
    uniform_rl: common read length (from split_readset) enabling the static
    tail cut before the pre-exchange sort."""
    if use_ragged is None:
        use_ragged = on_accelerator()
    capacity = -(-capacity // n_dev) * n_dev  # multiple of n_dev
    fn = partial(
        _sharded_count_local,
        n_dev=n_dev,
        capacity=capacity,
        min_freq=min_freq,
        min_bc=min_bc,
        use_ragged=use_ragged,
        uniform_rl=uniform_rl,
    )
    table_spec = KmerTable(
        W3(P(AXIS), P(AXIS), P(AXIS)), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)
    )
    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(table_spec, P(AXIS)),
    )(codes_ext, pos_read, glen_pos, bc_pos)


# ------------------------------------------- 2-D ("host","chip") mesh path

def _axis_exchange(cols, fills, key, n_groups, capacity, axis, use_ragged):
    """Regroup rows by `key` and all-to-all them over ONE mesh axis.

    `key` in [0, n_groups) routes a row to that index along `axis`; any
    key >= n_groups marks an invalid row (dropped).  Returns (cols,
    n_dropped) where cols are the exchanged flat columns of length
    `capacity` (fill rows carry `fills`).  The building block of the
    hierarchical (DCN-aware) shuffle below; same contract as the flat
    exchange in _sharded_count_local.
    """
    n = cols[0].shape[0]
    cap_per = capacity // n_groups
    ks, *scols = jax.lax.sort(
        (key.astype(U32),) + tuple(cols), num_keys=1, is_stable=True
    )
    counts = jax.ops.segment_sum(
        jnp.ones((n,), I32), ks.astype(I32), num_segments=n_groups + 1,
        indices_are_sorted=True,
    )[:n_groups]
    input_offsets = jnp.cumsum(counts) - counts

    if use_ragged:
        S = jax.lax.all_gather(counts, axis)  # (n_groups, n_groups)
        me = jax.lax.axis_index(axis)
        recv_sizes = S[:, me]
        col_excl = jnp.cumsum(S, axis=0) - S
        output_offsets = col_excl[me, :]
        out = tuple(
            jax.lax.ragged_all_to_all(
                col,
                jnp.full((capacity,), fill, U32),
                input_offsets.astype(I32),
                counts.astype(I32),
                output_offsets.astype(I32),
                recv_sizes.astype(I32),
                axis_name=axis,
            )
            for col, fill in zip(scols, fills)
        )
        n_recv = jnp.sum(recv_sizes)
        row_ok = jnp.arange(capacity) < n_recv
        out = tuple(
            jnp.where(row_ok, col, fill) for col, fill in zip(out, fills)
        )
        dropped = jnp.maximum(n_recv - capacity, 0)
        return out, dropped

    rank = jnp.arange(n, dtype=I32) - input_offsets[
        jnp.minimum(ks, n_groups - 1).astype(I32)
    ]
    ok = (ks < n_groups) & (rank < cap_per)
    idx = jnp.where(
        ok, jnp.minimum(ks, n_groups - 1).astype(I32) * cap_per + rank,
        n_groups * cap_per,
    )

    def exchange(col, fill):
        buf = jnp.full((n_groups * cap_per,), fill, U32)
        buf = buf.at[idx].set(col, mode="drop")
        return jax.lax.all_to_all(
            buf.reshape(n_groups, cap_per), axis, 0, 0, tiled=False
        ).reshape(n_groups * cap_per)

    out = tuple(exchange(col, fill) for col, fill in zip(scols, fills))
    dropped = jnp.sum(jnp.maximum(counts - cap_per, 0))
    return out, dropped


def _sharded_count_local_hier(
    codes_ext,
    pos_read,
    glen_pos,
    bc_pos,
    n_hosts: int,
    chips_per_host: int,
    capacity: int,
    min_freq: int,
    min_bc: int,
    use_ragged: bool,
    uniform_rl: int | None = None,
):
    """Per-device body on the ("host","chip") mesh: hierarchical shuffle.

    A flat all-to-all over H*C devices sends (H-1)*C small messages per
    device over DCN.  The hierarchical form sends each row over DCN exactly
    once, in C-times-larger per-host messages:
      phase 1 (ICI): regroup locally so chip j holds rows whose destination
        HOST h* satisfies h* % C == j;
      phase 2 (DCN): one all-to-all over the host axis delivers rows to
        their destination host (landing on chip j);
      phase 3 (ICI): local all-to-all delivers rows to their destination
        chip.
    Identical final shard contents to the flat exchange (the shard key is
    the same hash % (H*C)).
    """
    from .mesh import CHIP_AXIS, HOST_AXIS

    H, C = n_hosts, chips_per_host
    n_shards = H * C
    canon, bc, lm, rm, valid = extract_occurrences(
        codes_ext, pos_read, glen_pos, bc_pos
    )
    packed = pack_occurrence_attrs(bc, lm, rm, valid)
    if uniform_rl is not None:
        from ..kmer.count import uniform_tail_cut

        a_, b_, c_, packed = uniform_tail_cut(
            uniform_rl, canon.a, canon.b, canon.c, packed
        )
        valid = ((packed >> np.uint32(1)) & np.uint32(1)) == 1
        canon = W3(a_, b_, c_).where(valid, kc.SENTINEL)

    shard = kmer_shard_hash(canon) % np.uint32(n_shards)
    cols = (canon.a, canon.b, canon.c, packed, shard)
    fills = (kc.SENTINEL, kc.SENTINEL, kc.SENTINEL, np.uint32(0), np.uint32(0))

    def valid_of(pk):
        return ((pk >> np.uint32(1)) & np.uint32(1)) == 1

    # phase 1 (ICI): destination host, spread across local chips
    key = jnp.where(valid, (cols[4] // C) % C, U32(C))
    cols, d1 = _axis_exchange(cols, fills, key, C, capacity, CHIP_AXIS, use_ragged)
    # phase 2 (DCN): to the destination host
    v = valid_of(cols[3])
    key = jnp.where(v, cols[4] // C, U32(H))
    cols, d2 = _axis_exchange(cols, fills, key, H, capacity, HOST_AXIS, use_ragged)
    # phase 3 (ICI): to the destination chip
    v = valid_of(cols[3])
    key = jnp.where(v, cols[4] % C, U32(C))
    cols, d3 = _axis_exchange(cols, fills, key, C, capacity, CHIP_AXIS, use_ragged)

    words = W3(cols[0], cols[1], cols[2])
    rbc, rlm, rrm, rvalid = unpack_occurrence_attrs(cols[3])
    table = reduce_occurrences(words, rbc, rlm, rrm, rvalid, min_freq, min_bc)
    table = table._replace(n_valid=table.n_valid.reshape(1))
    overflow = jax.lax.psum(d1 + d2 + d3, (HOST_AXIS, CHIP_AXIS))
    return table, overflow.reshape(1)


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "n_hosts", "chips_per_host", "capacity", "min_freq",
        "min_bc", "use_ragged", "uniform_rl",
    ),
)
def sharded_count_hier(
    mesh,
    codes_ext,
    pos_read,
    glen_pos,
    bc_pos,
    n_hosts: int,
    chips_per_host: int,
    capacity: int,
    min_freq: int = MIN_FREQ,
    min_bc: int = MIN_BC,
    use_ragged: bool | None = None,
    uniform_rl: int | None = None,
):
    """Multi-host counting over a make_mesh2 ("host","chip") mesh with the
    DCN-aware hierarchical shuffle.  Same outputs as sharded_count with
    n_dev = n_hosts * chips_per_host (shard tables stack host-major)."""
    from .mesh import CHIP_AXIS, HOST_AXIS

    if use_ragged is None:
        use_ragged = on_accelerator()
    lcm = n_hosts * chips_per_host
    capacity = -(-capacity // lcm) * lcm
    fn = partial(
        _sharded_count_local_hier,
        n_hosts=n_hosts,
        chips_per_host=chips_per_host,
        capacity=capacity,
        min_freq=min_freq,
        min_bc=min_bc,
        use_ragged=use_ragged,
        uniform_rl=uniform_rl,
    )
    spec = P((HOST_AXIS, CHIP_AXIS))
    table_spec = KmerTable(W3(spec, spec, spec), spec, spec, spec, spec, spec)
    return jax.shard_map(
        fn,
        mesh=mesh,
        check_vma=False,
        in_specs=(spec, spec, spec, spec),
        out_specs=(table_spec, spec),
    )(codes_ext, pos_read, glen_pos, bc_pos)


# ------------------------------------------------------------------- host

def split_readset(rs, n_dev: int, base_bucket: int = 16384, read_bucket: int = 1024):
    """Split a ReadSet into n_dev equal-shape device blocks (by read pairs,
    so mates stay together), returning stacked host arrays.

    The final element of the return tuple is `uniform_rl` (the common read
    length, or None): when set, per-device blocks are padded in multiples
    of rl*128 so sharded_count can statically cut never-valid kmer starts
    (last K-1 positions of every read) before its sort + exchange."""
    from ..kmer.count import BC_IGNORED as IGN, _round_up
    from ..core.kmer_codec import K

    lens_all = np.diff(rs.offsets)
    uniform_rl = (
        int(lens_all[0])
        if rs.n_reads > 0 and (lens_all == lens_all[0]).all() and lens_all[0] > K
        else None
    )
    if uniform_rl is not None:
        base_bucket = uniform_rl * 128
    pairs = rs.n_pairs
    per = -(-pairs // n_dev)
    blocks = []
    max_nb = 1
    max_r = 1
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
        glen_pos = np.zeros(nbl, np.int32)
        bc_pos = np.full(nbl, IGN, np.int32)
        if len(idx):
            starts = rs.offsets[idx]
            flat = np.concatenate(
                [rs.codes[s : s + l] for s, l in zip(starts, lens)]
            )
            codes[:nb] = flat
            quals = np.concatenate(
                [rs.quals[s : s + l] for s, l in zip(starts, lens)]
            )
            off = np.concatenate([[0], np.cumsum(lens)])
            glen = good_lengths_np(quals, off)
            pr[:nb] = np.repeat(np.arange(len(idx), dtype=np.int32), lens)
            glen_pos[:nb] = np.repeat(glen, lens)
            bcv = (
                np.where(rs.bc[idx] > 0, rs.bc[idx], IGN)
                if rs.barcoded
                else np.full(len(idx), IGN, np.int32)
            )
            bc_pos[:nb] = np.repeat(bcv, lens)
        return codes, pr, glen_pos, bc_pos

    packed = [pack(i, l) for i, l in blocks]
    cat = lambda k: np.concatenate([p[k] for p in packed])
    return cat(0), cat(1), cat(2), cat(3), nbl, rl, uniform_rl


def merge_shard_tables(tables_stacked) -> "KmerTable":
    """Host merge: per-shard tables are disjoint in kmer space; concat valid
    rows and re-sort lexicographically into one global table."""
    nv = np.asarray(tables_stacked.n_valid)
    n_dev = len(nv)
    cap = np.asarray(tables_stacked.count).shape[0] // n_dev
    wa = np.asarray(tables_stacked.words.a).reshape(n_dev, cap)
    wb = np.asarray(tables_stacked.words.b).reshape(n_dev, cap)
    wc = np.asarray(tables_stacked.words.c).reshape(n_dev, cap)
    count = np.asarray(tables_stacked.count).reshape(n_dev, cap)
    nbc = np.asarray(tables_stacked.nbc).reshape(n_dev, cap)
    lm = np.asarray(tables_stacked.left_mask).reshape(n_dev, cap)
    rm = np.asarray(tables_stacked.right_mask).reshape(n_dev, cap)
    rows = {k: [] for k in "abc"}
    rows_c, rows_b, rows_l, rows_r = [], [], [], []
    for s in range(n_dev):
        n = int(nv[s])
        rows["a"].append(wa[s, :n])
        rows["b"].append(wb[s, :n])
        rows["c"].append(wc[s, :n])
        rows_c.append(count[s, :n])
        rows_b.append(nbc[s, :n])
        rows_l.append(lm[s, :n])
        rows_r.append(rm[s, :n])
    a = np.concatenate(rows["a"])
    b = np.concatenate(rows["b"])
    c = np.concatenate(rows["c"])
    order = np.lexsort((c, b, a))
    n = len(order)
    m = max(256, -(-n // 256) * 256)
    w = np.full((m, 3), kc.SENTINEL, np.uint32)
    w[:n, 0] = a[order]
    w[:n, 1] = b[order]
    w[:n, 2] = c[order]
    pad = lambda arrs: np.concatenate(
        [np.concatenate(arrs)[order], np.zeros(m - n, arrs[0].dtype)]
    )
    return KmerTable(
        kc.np_to_soa(w),
        jnp.asarray(pad(rows_c)),
        jnp.asarray(pad(rows_b)),
        jnp.asarray(pad(rows_l)),
        jnp.asarray(pad(rows_r)),
        jnp.asarray(n, I32),
    )
