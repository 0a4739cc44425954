"""Device formulation of the NucleateGraph glue phase.

The host path (asm/nucleate.py + native/nucleate_core.cpp) walks hash maps
and a pointer union-find — correct but serial.  This module re-expresses
the same semantics as sorts, segment reductions, ragged joins, and
min-label propagation, so closure gluing runs on the chip; every step is a
sort/join keyed on closure position or edge id, which is also the
hash-shard decomposition for a mesh version.  Reference semantics are
documented in asm/nucleate.py (ClosuresToGraph.cc GetMatches +
NucleateGraph.h; Zipper Super.cc:2297).

Scope: the non-interior ("closure") mode used for the big DF-closure glue.
The interior merge mode (MergeShortOverlaps) stays host-side — it runs at
supergraph scale (1e3-1e5 edges).

Pipeline (static shapes, int32/uint32 only — x64 stays off):
  1. per-edge distinct-closure multiplicity (sorted dedup + segment count);
  2. per-closure seed: least-multiplicity position within the tail window
     holding >= MIN_OVER kmers, ties -> closest to the end (two scatters);
  3. candidate join: rows sorted by (edge, closure, pos); every seed pairs
     with every other row of its edge run, enumerated exactly by ragged
     expansion (scatter + cummax) under a static budget;
  4. candidate dedup on (c1, c2, j1-j2) (sort + first-of-run) — mirrors the
     host's `done` set, keeping the adaptive-gate multiset identical;
  5. pairwise maximal extension: masked while_loop, one gather pair/step;
  6. end-reaching filter + adaptive overlap gate (30th percentile);
  7. long-edge matches: each row of a long-edge run pairs with its next
     <= 40 run neighbors (ragged expansion; farther pairs follow by union
     transitivity through nearer ones — host unions them plainly);
  8. boundary union pairs (match + rc image), ragged-expanded;
  9. union-find: scatter-min label hooking + pointer jumping to fixpoint;
 10. Zipper: sorted (class(head), edge-label) joins -> more unions, to a
     fixpoint.
Output: fully-compressed labels (min boundary id per class) — the same
partition as the host core; asm/nucleate._quotient consumes it unchanged.
Budget overflows are returned as diagnostics; the caller falls back to the
host core when any budget clipped real work.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import segments as seg

I32 = jnp.int32
U32 = jnp.uint32
BIG = np.int32(0x7FFFFFFF)
UBIG = np.uint32(0xFFFFFFFF)


def _seg_count_at_rows(ind, starts):
    """Per-run inclusive count of `ind` at each row (runs from `starts`)."""
    ind = ind.astype(I32)
    cs = jnp.cumsum(ind)
    base = seg.run_broadcast_from_start(cs - ind, starts)
    return cs - base


def _bcast_back(vals_at_end, fill):
    """Broadcast run-end values backward over the run (reverse cummin;
    requires fill > any real value)."""
    return jnp.flip(jax.lax.cummin(jnp.flip(vals_at_end)))


def ragged_expand(sizes, budget: int):
    """Enumerate sum(sizes) (owner, t) pairs, t in [0, sizes[owner]).

    Owners must be the row ids of `sizes`.  Returns (owner (budget,),
    t (budget,), rowv (budget,) bool, overflow scalar)."""
    n = sizes.shape[0]
    dst = jnp.cumsum(sizes) - sizes
    total = jnp.sum(sizes)
    owner = jnp.zeros((budget,), I32).at[
        jnp.where((sizes > 0) & (dst < budget), dst, budget)
    ].max(jnp.arange(n, dtype=I32), mode="drop")
    owner = jax.lax.cummax(owner)
    o_safe = jnp.minimum(owner, n - 1)
    t = jnp.arange(budget, dtype=I32) - dst[o_safe]
    rowv = jnp.arange(budget, dtype=I32) < jnp.minimum(total, budget)
    return o_safe, t, rowv, jnp.maximum(total - budget, 0)


@partial(
    jax.jit,
    static_argnames=(
        "n_bound", "min_over", "min_over_floor", "adaptive",
        "long_shift", "cand_budget", "long_budget", "pair_budget",
    ),
)
def glue_device(
    cvals,      # (P,) int32 edge id per closure position (pad BIG)
    ccid,       # (P,) int32 closure id per position (pad BIG)
    cpos,       # (P,) int32 position within closure (pad 0)
    cstart,     # (C,) int32 boundary-node offset per closure (pad 0)
    clen,       # (C,) int32 closure length (pad 0)
    cinv,       # (C,) int32 closure involution (pad identity)
    kmers,      # (E,) int32 kmers per base edge
    n_bound: int,
    min_over: int = 153,
    min_over_floor: int = 53,
    adaptive: bool = True,
    long_shift: int = 40,
    cand_budget: int | None = None,
    long_budget: int | None = None,
    pair_budget: int | None = None,
):
    """Returns (labels (B,) int32 min-id partition,
    (cand_overflow, long_overflow, pair_overflow) diagnostics)."""
    P = cvals.shape[0]
    C = cstart.shape[0]
    E = kmers.shape[0]
    B = n_bound
    if cand_budget is None:
        cand_budget = 4 * P
    if long_budget is None:
        long_budget = 4 * P
    if pair_budget is None:
        pair_budget = 8 * P
    valid_pos = ccid < BIG
    cid_safe = jnp.minimum(ccid, C - 1)

    # ---- 1. per-edge distinct-closure multiplicity
    e_s, c_s = jax.lax.sort((jnp.where(valid_pos, cvals, BIG), ccid),
                            num_keys=2, is_stable=False)
    st_ec = seg.run_starts(e_s, c_s)
    est = seg.run_starts(e_s)
    dcount = _seg_count_at_rows(st_ec, est)
    eend = seg.run_end_mask(est)
    emult = jnp.zeros((E,), I32).at[
        jnp.where(eend & (e_s < BIG), e_s, E)
    ].set(dcount, mode="drop")

    mult_pos = jnp.where(valid_pos, emult[jnp.minimum(cvals, E - 1)], BIG)
    km_pos = jnp.where(
        valid_pos, kmers[jnp.minimum(cvals, E - 1)], 0
    ).astype(U32)

    # ---- 2. per-closure tail-window seed
    pstart = seg.run_starts(ccid)
    csum = jnp.cumsum(km_pos)                  # u32; per-closure diffs exact
    pend = seg.run_end_mask(pstart)
    # suffix-exclusive kmer sum within the closure via the row's RUN-END
    # position.  NOTE: _bcast_back (reverse cummin) is only valid for
    # values that increase along the array, like positions — broadcasting
    # run-end TOTALS with it let the pad run's 0 (and any smaller later
    # closure total) leak backward, leaving in_window EMPTY, so the device
    # cores selected no candidate seeds at all and glued only through
    # long-edge matches (masked at toy scale; caught by the 300 kb mesh
    # identity test).
    pall = jnp.arange(km_pos.shape[0], dtype=I32)
    rend_pos = _bcast_back(jnp.where(pend, pall, BIG), BIG)
    csum_end = csum[jnp.clip(rend_pos, 0, km_pos.shape[0] - 1)]
    suf_excl = csum_end - csum                 # kmers strictly after pos
    in_window = valid_pos & (suf_excl < np.uint32(min_over))
    cmin_mult = jnp.full((C,), BIG, I32).at[
        jnp.where(in_window, ccid, C)
    ].min(mult_pos, mode="drop")
    tied = in_window & (mult_pos == cmin_mult[cid_safe])
    cseed_pos = jnp.full((C,), -1, I32).at[
        jnp.where(tied, ccid, C)
    ].max(cpos, mode="drop")
    is_seed = tied & (cpos == cseed_pos[cid_safe])

    # ---- 3. candidate join: seeds x their edge-run partners
    e3, c3, p3, s3 = jax.lax.sort(
        (jnp.where(valid_pos, cvals, BIG), ccid, cpos, is_seed.astype(I32)),
        num_keys=3, is_stable=False,
    )
    ps = jnp.arange(P, dtype=I32)
    est3 = seg.run_starts(e3)
    run_start3 = jax.lax.cummax(jnp.where(est3, ps, 0))
    rend3 = seg.run_end_mask(est3)
    run_end3 = _bcast_back(jnp.where(rend3, ps, BIG), BIG)
    run_len3 = run_end3 - run_start3 + 1

    # compact seed rows to (C,) arrays
    nseed, (srow, s_rs, s_rl, s_c, s_p) = seg.stable_compact(
        (s3 == 1) & (e3 < BIG), ps, run_start3, run_len3, c3, p3
    )
    sl = lambda a: jax.lax.dynamic_slice(a, (0,), (C,))
    srow, s_rs, s_rl = sl(srow), sl(s_rs), sl(s_rl)
    s_c, s_p = sl(s_c), sl(s_p)
    live_seed = jnp.arange(C, dtype=I32) < nseed
    sizes = jnp.where(live_seed, s_rl - 1, 0)
    owner, t, rowv, cand_overflow = ragged_expand(sizes, cand_budget)
    # partner row: skip the seed's own slot within its run
    in_run_seed = srow[owner] - s_rs[owner]
    prow = s_rs[owner] + t + (t >= in_run_seed).astype(I32)
    prow = jnp.clip(prow, 0, P - 1)
    ca = jnp.where(rowv, s_c[owner], BIG)
    cj1 = jnp.where(rowv, s_p[owner], 0)
    cb = jnp.where(rowv, c3[prow], BIG)
    cj2 = jnp.where(rowv, p3[prow], 0)
    other = cb != ca                            # host skips i2 == i1
    ca = jnp.where(other, ca, BIG)
    cb = jnp.where(other, cb, BIG)

    # ---- 4. dedup on (c1, c2, offset)
    off = cj1 - cj2 + P
    k1, k2, k3, q1, q2 = jax.lax.sort(
        (ca, cb, off, cj1, cj2), num_keys=3, is_stable=True
    )
    first = seg.run_starts(k1, k2, k3)
    live0 = first & (k1 < BIG)
    c1v, c2v = jnp.where(live0, k1, BIG), jnp.where(live0, k2, BIG)
    j1v, j2v = jnp.where(live0, q1, 0), jnp.where(live0, q2, 0)

    # ---- 5. pairwise maximal extension
    coffs = jnp.concatenate(
        [jnp.zeros((1,), I32), jnp.cumsum(clen)[:-1].astype(I32)]
    )
    cvp = jnp.concatenate([cvals, jnp.full((1,), BIG, I32)])

    def extend(c1, j1, c2, j2, live):
        o1 = coffs[jnp.minimum(c1, C - 1)]
        o2 = coffs[jnp.minimum(c2, C - 1)]
        l1 = clen[jnp.minimum(c1, C - 1)]
        l2 = clen[jnp.minimum(c2, C - 1)]

        def back(state):
            a, active = state
            ok = active & (j1 - a - 1 >= 0) & (j2 - a - 1 >= 0)
            ok = ok & (
                cvp[jnp.clip(o1 + j1 - a - 1, 0, P)]
                == cvp[jnp.clip(o2 + j2 - a - 1, 0, P)]
            )
            return a + ok.astype(I32), ok

        a_fin, _ = jax.lax.while_loop(
            lambda s: jnp.any(s[1]), back, (jnp.zeros_like(j1), live)
        )

        def fwd(state):
            b, active = state
            ok = active & (j1 + b < l1) & (j2 + b < l2)
            ok = ok & (
                cvp[jnp.clip(o1 + j1 + b, 0, P)]
                == cvp[jnp.clip(o2 + j2 + b, 0, P)]
            )
            return b + ok.astype(I32), ok

        b_fin, _ = jax.lax.while_loop(
            lambda s: jnp.any(s[1]), fwd, (jnp.ones_like(j1), live)
        )
        return j1 - a_fin, j2 - a_fin, a_fin + b_fin, o1, l1, l2

    s1, s2, L, o1c, l1c, l2c = extend(c1v, j1v, c2v, j2v, live0)

    # ---- 6. end-reaching filter + adaptive gate
    prefx = jnp.concatenate([jnp.zeros((1,), U32), jnp.cumsum(km_pos)])

    def ksum(offs, lo, ln):
        return prefx[jnp.clip(offs + lo + ln, 0, P)] - prefx[
            jnp.clip(offs + lo, 0, P)
        ]

    over = jnp.where(live0, ksum(o1c, s1, L), 0)
    reach = (s1 + L >= l1c) & ((s1 == 0) | (s2 == 0))
    cand_ok = live0 & reach
    over_m = jnp.where(cand_ok, over, UBIG)
    if adaptive:
        n_c = jnp.sum(cand_ok.astype(I32))
        overs_sorted = jax.lax.sort(over_m)
        k30 = (jnp.maximum(n_c - 1, 0).astype(jnp.float32) * 0.30).astype(I32)
        p30 = overs_sorted[jnp.clip(k30, 0, over_m.shape[0] - 1)]
        gate = jnp.clip(p30, np.uint32(min_over_floor), np.uint32(min_over))
        gate = jnp.where(n_c > 0, gate, np.uint32(min_over))
    else:
        gate = jnp.asarray(min_over, U32)
    acc = cand_ok & (over >= gate)

    # ---- 7. long-edge matches: next <= long_shift run neighbors per row
    longrow = (e3 < BIG) & (
        kmers[jnp.minimum(e3, E - 1)].astype(U32) >= gate
    )
    big_run = run_len3 > 1
    lsizes = jnp.where(
        longrow & big_run,
        jnp.minimum(np.int32(long_shift), run_end3 - ps),
        0,
    )
    lowner, lt, lrowv, long_overflow = ragged_expand(lsizes, long_budget)
    lprow = jnp.clip(lowner + 1 + lt, 0, P - 1)
    la = jnp.where(lrowv, c3[lowner], BIG)
    lj1 = jnp.where(lrowv, p3[lowner], 0)
    lb = jnp.where(lrowv, c3[lprow], BIG)
    lj2 = jnp.where(lrowv, p3[lprow], 0)
    llive = (la < BIG) & (lb < BIG)
    ls1, ls2, lL, _, _, _ = extend(la, lj1, lb, lj2, llive)

    # ---- 8. boundary union pairs + rc images, ragged-expanded
    mc1 = jnp.concatenate([jnp.where(acc, c1v, BIG), jnp.where(llive, la, BIG)])
    ms1 = jnp.concatenate([jnp.where(acc, s1, 0), jnp.where(llive, ls1, 0)])
    mc2 = jnp.concatenate([jnp.where(acc, c2v, BIG), jnp.where(llive, lb, BIG)])
    ms2 = jnp.concatenate([jnp.where(acc, s2, 0), jnp.where(llive, ls2, 0)])
    mL = jnp.concatenate([jnp.where(acc, L, 0), jnp.where(llive, lL, 0)])
    mlive = mc1 < BIG
    rc1 = jnp.where(mlive, cinv[jnp.minimum(mc1, C - 1)], BIG)
    rc2 = jnp.where(mlive, cinv[jnp.minimum(mc2, C - 1)], BIG)
    rs1 = jnp.where(mlive, clen[jnp.minimum(mc1, C - 1)] - (ms1 + mL), 0)
    rs2 = jnp.where(mlive, clen[jnp.minimum(mc2, C - 1)] - (ms2 + mL), 0)
    ac = jnp.concatenate([mc1, rc1])
    av = jnp.concatenate([ms1, rs1])
    bc_ = jnp.concatenate([mc2, rc2])
    bv = jnp.concatenate([ms2, rs2])
    aL = jnp.concatenate([mL, mL])
    alive = ac < BIG
    b1 = jnp.where(alive, cstart[jnp.minimum(ac, C - 1)] + av, 0)
    b2 = jnp.where(alive, cstart[jnp.minimum(bc_, C - 1)] + bv, 0)

    usizes = jnp.where(alive, aL + 1, 0)
    uowner, ut, urowv, pair_overflow = ragged_expand(usizes, pair_budget)
    ua = jnp.where(urowv, b1[uowner] + ut, 0)
    ub = jnp.where(urowv, b2[uowner] + ut, 0)
    rowv = urowv

    # ---- 9. union-find to fixpoint (hook by scatter-min + pointer jumps)
    label0 = jnp.arange(B, dtype=I32)

    def uf_round(lab):
        la_ = lab[ua]
        lb_ = lab[ub]
        m = jnp.minimum(la_, lb_)
        lab = lab.at[jnp.where(rowv, ua, B)].min(m, mode="drop")
        lab = lab.at[jnp.where(rowv, ub, B)].min(m, mode="drop")
        lab = jnp.minimum(lab, lab[lab])
        lab = jnp.minimum(lab, lab[lab])
        return lab

    def uf_fix(state):
        lab, _ = state
        nxt = uf_round(lab)
        return nxt, jnp.any(nxt != lab)

    label, _ = jax.lax.while_loop(
        lambda s: s[1], uf_fix, (uf_round(label0), jnp.asarray(True))
    )

    # ---- 10. Zipper to fixpoint
    inst_b = jnp.where(valid_pos, cstart[cid_safe] + cpos, 0)
    inst_lab = jnp.where(valid_pos, cvals, BIG)

    def zip_pass(lab, heads_off, tails_off):
        h = jnp.where(
            valid_pos, lab[jnp.clip(inst_b + heads_off, 0, B - 1)], BIG
        )
        t_ = jnp.where(
            valid_pos, lab[jnp.clip(inst_b + tails_off, 0, B - 1)], BIG
        )
        hk, lk, tk = jax.lax.sort(
            (h, inst_lab, t_), num_keys=2, is_stable=False
        )
        same = (
            (hk == jnp.roll(hk, 1)) & (lk == jnp.roll(lk, 1))
            & (hk < BIG) & (lk < BIG)
        )
        same = same.at[0].set(False)
        ta = jnp.where(same, tk, 0)
        tb = jnp.where(same, jnp.roll(tk, 1), 0)
        m = jnp.minimum(ta, tb)
        lab = lab.at[jnp.where(same, ta, B)].min(m, mode="drop")
        lab = lab.at[jnp.where(same, tb, B)].min(m, mode="drop")
        for _ in range(3):
            lab = jnp.minimum(lab, lab[lab])
        return lab

    def zip_fix(state):
        lab, _ = state
        nxt = zip_pass(zip_pass(lab, 0, 1), 1, 0)
        return nxt, jnp.any(nxt != lab)

    label, _ = jax.lax.while_loop(
        lambda s: s[1], zip_fix, (label, jnp.asarray(True))
    )
    for _ in range(4):
        label = jnp.minimum(label, label[label])
    return label, (cand_overflow, long_overflow, pair_overflow)


# ------------------------------------------------------------------- host IO

def _round_up(x: int, m: int) -> int:
    return -(-max(x, 1) // m) * m


def glue_closures_device(bg, cls, min_over_bases, adaptive: bool,
                         min_over_floor_bases: int = 100,
                         bucket: int = 8192):
    """Host wrapper: sanitized closures -> boundary labels (numpy int64),
    the same partition as the native/python cores.  Returns None when a
    device budget overflowed (caller falls back to the host core)."""
    from ..core.kmer_codec import K

    n = len(cls)
    if n == 0:
        return np.zeros(0, np.int64)
    lens = np.array([len(c) for c in cls], dtype=np.int64)
    cstart = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens + 1, out=cstart[1:])
    total = int(cstart[-1])
    P = _round_up(int(lens.sum()), bucket)
    cvals = np.full(P, BIG, np.int32)
    ccid = np.full(P, BIG, np.int32)
    cpos = np.zeros(P, np.int32)
    flat = np.concatenate([np.asarray(c, np.int32) for c in cls])
    m = len(flat)
    cvals[:m] = flat
    ccid[:m] = np.repeat(np.arange(n, dtype=np.int32), lens)
    cpos[:m] = np.concatenate([np.arange(l, dtype=np.int32) for l in lens])
    Cpad = _round_up(n, 256)
    cst = np.zeros(Cpad, np.int32)
    cst[:n] = cstart[:n]
    cln = np.zeros(Cpad, np.int32)
    cln[:n] = lens
    cin = np.arange(Cpad, dtype=np.int32)
    inv = bg.inv
    idx = {c: i for i, c in enumerate(cls)}
    cin[:n] = np.array(
        [idx[tuple(int(inv[e]) for e in reversed(c))] for c in cls],
        dtype=np.int32,
    )
    kmers = (bg.edges.lengths() - (K - 1)).astype(np.int32)
    Epad = _round_up(bg.n_edges, 256)
    km = np.zeros(Epad, np.int32)
    km[: bg.n_edges] = kmers
    labels, ovf = glue_device(
        jnp.asarray(cvals), jnp.asarray(ccid), jnp.asarray(cpos),
        jnp.asarray(cst), jnp.asarray(cln), jnp.asarray(cin),
        jnp.asarray(km),
        n_bound=_round_up(total, bucket),  # padded: shape-bucketed compiles
        min_over=max(min_over_bases - (K - 1), 1),
        min_over_floor=max(min_over_floor_bases - (K - 1), 1),
        adaptive=adaptive,
    )
    if any(int(x) > 0 for x in ovf):
        return None
    return np.asarray(labels)[:total].astype(np.int64)
