"""Mesh-sharded NucleateGraph glue: the closure gluing over an N-device
mesh (the full §5.8 story for the supergraph build).

Decomposition (mirrors parallel/device_nucleate.py, which documents the
reference semantics being reproduced):
  * closure position rows are sharded in closure-aligned blocks;
  * per-edge multiplicity and the seed-partner join run on EDGE-HASH owner
    shards (ragged/dense all-to-all, the MSP-shuffle pattern);
  * pairwise match extension reads the closure VALUES, which are
    replicated like the pathing dictionary (parallel/sharded_path.py) —
    the quadratic terms (joins, candidates, union pairs, labels) shard,
    the linear sequence payload is mirrored; value-sharded extension via
    distributed gathers is the pod-scale variant;
  * the adaptive overlap gate is computed identically on every shard from
    an all-gather of the candidate overlap arrays (exact order statistic);
  * boundary labels are sharded by range; union hooking exchanges
    (node, min) pairs to label owners, pointer jumping uses distributed
    gathers, and Zipper joins group rows by (head-class, edge-label) hash
    on owner shards — all iterated to a psum-agreed fixpoint.

Partitions are bit-identical to device_nucleate.glue_device (and hence to
the host cores) — tested on the virtual CPU mesh.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.jaxconfig import on_accelerator
from ..ops import segments as seg
from .device_nucleate import BIG, UBIG, _bcast_back, _seg_count_at_rows, ragged_expand
from .mesh import AXIS
from .sharded_build import _exchange, _return

I32 = jnp.int32
U32 = jnp.uint32


def _fnv(x):
    x = x.astype(U32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _label_owner(node, per: int, n_dev: int):
    return jnp.minimum(node // per, n_dev - 1).astype(I32)


def _dist_range_gather(local, idx, valid, per: int, n_dev: int,
                       cap_per: int, use_ragged: bool, fill):
    """Distributed local[idx] over a range-sharded array (owner = idx//per);
    rows with valid=False (or out of range) return `fill`."""
    owner = jnp.where(valid, _label_owner(idx, per, n_dev), n_dev)
    (qi,), ctx = _exchange(
        (idx.astype(I32),), owner, n_dev, cap_per, (0,), use_ragged
    )
    me = jax.lax.axis_index(AXIS).astype(I32)
    loc = jnp.clip(qi - me * per, 0, per - 1)
    resp = local[loc]
    out = _return(resp, ctx, n_dev, jnp.asarray(fill, local.dtype))
    return jnp.where(valid, out, jnp.asarray(fill, local.dtype))


def _dist_label_gather(label_local, idx, valid, per: int, n_dev: int,
                       cap_per: int, use_ragged: bool):
    """Distributed label[idx] over range-sharded labels."""
    return _dist_range_gather(
        label_local, idx, valid, per, n_dev, cap_per, use_ragged, BIG
    )


def _dist_label_min(label_local, idx, val, valid, per: int, n_dev: int,
                    cap_per: int, use_ragged: bool):
    """Distributed label[idx] = min(label[idx], val)."""
    owner = jnp.where(valid, _label_owner(idx, per, n_dev), n_dev)
    (qi, qv), _ = _exchange(
        (idx.astype(I32), val.astype(I32)), owner, n_dev, cap_per,
        (0, BIG), use_ragged,
    )
    me = jax.lax.axis_index(AXIS).astype(I32)
    local = jnp.clip(qi - me * per, 0, per - 1)
    return label_local.at[local].min(qv)


def _sharded_glue_local(
    cvals, ccid, cpos,          # (rows,) per-shard closure position block
    cvals_rep, prefx_rep,       # flat closure values + exclusive kmer prefix
    coffs_rep,                  # per-closure flat offsets (replicated)
    cstart, clen, cinv, kmers,  # replicated closure/edge tables
    *,
    n_dev: int,
    per_label: int,
    min_over: int,
    min_over_floor: int,
    adaptive: bool,
    long_shift: int,
    cap_rows: int,
    cand_budget: int,
    long_budget: int,
    pair_budget: int,
    use_ragged: bool,
    value_shard: bool = False,
):
    rows = cvals.shape[0]
    C = cstart.shape[0]
    E = kmers.shape[0]
    # global flat position count: cvals_rep is the full array when
    # replicated, or this shard's range slice when value_shard
    P = cvals_rep.shape[0] * (n_dev if value_shard else 1)
    valid_pos = ccid < BIG
    cid_safe = jnp.minimum(ccid, C - 1)

    # ---- seed selection is shard-local (closures never split) ----------
    km_pos = jnp.where(
        valid_pos, kmers[jnp.minimum(cvals, E - 1)], 0
    ).astype(U32)
    pstart = seg.run_starts(ccid)
    csum = jnp.cumsum(km_pos)
    pend = seg.run_end_mask(pstart)
    # suffix-exclusive kmer sum via the row's RUN-END position (see
    # device_nucleate.py: _bcast_back over run-end TOTALS is unsound —
    # smaller later totals / the pad run's 0 leak backward and empty the
    # seed window)
    pall = jnp.arange(km_pos.shape[0], dtype=I32)
    rend_pos = _bcast_back(jnp.where(pend, pall, BIG), BIG)
    csum_end = csum[jnp.clip(rend_pos, 0, km_pos.shape[0] - 1)]
    in_window = valid_pos & ((csum_end - csum) < np.uint32(min_over))

    # per-edge distinct-closure multiplicity: ask the edge-hash owner
    e_owner = jnp.where(valid_pos, (_fnv(cvals) % np.uint32(n_dev)).astype(I32), n_dev)
    (re_, rc_), ctx1 = _exchange(
        (jnp.where(valid_pos, cvals, BIG), ccid), e_owner, n_dev, cap_rows,
        (BIG, BIG), use_ragged,
    )
    # per-row edge multiplicity (distinct closures per edge), returned in
    # the received-row order via an iota payload.  The run total broadcasts
    # through the run-end POSITION (monotone), never through run-end
    # COUNTS — a reverse cummin over counts leaks smaller later runs'
    # values backward (the seed-window bug class, see device_nucleate.py)
    es2, cs2, perm2 = jax.lax.sort(
        (re_, rc_, jnp.arange(re_.shape[0], dtype=I32)),
        num_keys=2, is_stable=True,
    )
    est2 = seg.run_starts(es2)
    cnt_incl = _seg_count_at_rows(seg.run_starts(es2, cs2), est2)
    rows2 = jnp.arange(re_.shape[0], dtype=I32)
    rend2 = _bcast_back(
        jnp.where(seg.run_end_mask(est2), rows2, BIG), BIG
    )
    mult_sorted = jnp.where(
        es2 < BIG,
        cnt_incl[jnp.clip(rend2, 0, re_.shape[0] - 1)],
        BIG,
    )
    mult_rows = jnp.zeros((re_.shape[0],), I32).at[perm2].set(mult_sorted)
    mult_pos = _return(mult_rows, ctx1, n_dev, jnp.asarray(BIG, I32))
    mult_pos = jnp.where(valid_pos, mult_pos, BIG)

    cmin_mult = jnp.full((C,), BIG, I32).at[
        jnp.where(in_window, ccid, C)
    ].min(mult_pos, mode="drop")
    tied = in_window & (mult_pos == cmin_mult[cid_safe])
    cseed_pos = jnp.full((C,), -1, I32).at[
        jnp.where(tied, ccid, C)
    ].max(cpos, mode="drop")
    # NOTE: cmin/cseed scatters above are LOCAL; closures are shard-local,
    # so only this shard's rows touch its closures' entries
    is_seed = tied & (cpos == cseed_pos[cid_safe])

    # ---- candidate join on edge-hash owners -----------------------------
    (e3r, c3r, p3r, s3r), _ = _exchange(
        (
            jnp.where(valid_pos, cvals, BIG),
            ccid,
            cpos,
            is_seed.astype(I32),
        ),
        e_owner, n_dev, cap_rows, (BIG, BIG, 0, 0), use_ragged,
    )
    e3, c3, p3, s3 = jax.lax.sort(
        (e3r, c3r, p3r, s3r), num_keys=3, is_stable=False
    )
    R3 = e3.shape[0]
    ps = jnp.arange(R3, dtype=I32)
    est3 = seg.run_starts(e3)
    run_start3 = jax.lax.cummax(jnp.where(est3, ps, 0))
    rend3 = seg.run_end_mask(est3)
    run_end3 = _bcast_back(jnp.where(rend3, ps, BIG), BIG)
    run_len3 = run_end3 - run_start3 + 1

    nseed, (srow, s_rs, s_rl, s_c, s_p) = seg.stable_compact(
        (s3 == 1) & (e3 < BIG), ps, run_start3, run_len3, c3, p3
    )
    CS = min(C, R3)
    sl = lambda a: jax.lax.dynamic_slice(a, (0,), (CS,))
    srow, s_rs, s_rl, s_c, s_p = map(sl, (srow, s_rs, s_rl, s_c, s_p))
    live_seed = jnp.arange(CS, dtype=I32) < nseed
    sizes = jnp.where(live_seed, s_rl - 1, 0)
    owner_s, t, rowv, cand_ovf = ragged_expand(sizes, cand_budget)
    in_run_seed = srow[owner_s] - s_rs[owner_s]
    prow = jnp.clip(s_rs[owner_s] + t + (t >= in_run_seed).astype(I32), 0, R3 - 1)
    ca = jnp.where(rowv, s_c[owner_s], BIG)
    cj1 = jnp.where(rowv, s_p[owner_s], 0)
    cb = jnp.where(rowv, c3[prow], BIG)
    cj2 = jnp.where(rowv, p3[prow], 0)
    other = cb != ca
    ca = jnp.where(other, ca, BIG)
    cb = jnp.where(other, cb, BIG)

    off = cj1 - cj2 + P
    k1, k2, k3, q1, q2 = jax.lax.sort(
        (ca, cb, off, cj1, cj2), num_keys=3, is_stable=True
    )
    first = seg.run_starts(k1, k2, k3)
    live0 = first & (k1 < BIG)
    c1v, c2v = jnp.where(live0, k1, BIG), jnp.where(live0, k2, BIG)
    j1v, j2v = jnp.where(live0, q1, 0), jnp.where(live0, q2, 0)

    # ---- extension: replicated values, or distributed range gathers ----
    if value_shard:
        per_val = cvals_rep.shape[0]

        def fetch_val(idx, valid, cap):
            inr = valid & (idx >= 0) & (idx < P)
            return _dist_range_gather(
                cvals_rep, idx, inr, per_val, n_dev, cap, use_ragged, BIG
            )

        def fetch_pref(idx, valid, cap):
            inr = valid & (idx >= 0) & (idx < P)
            return _dist_range_gather(
                prefx_rep, idx, inr, per_val, n_dev, cap, use_ragged,
                np.uint32(0),
            )
    else:
        cvp = jnp.concatenate([cvals_rep, jnp.full((1,), BIG, I32)])

        def fetch_val(idx, valid, cap):
            return jnp.where(valid, cvp[jnp.clip(idx, 0, P)], BIG)

        def fetch_pref(idx, valid, cap):
            return jnp.where(
                valid, prefx_rep[jnp.clip(idx, 0, P - 1)], np.uint32(0)
            )

    def extend(c1, j1, c2, j2, live):
        o1 = coffs_rep[jnp.minimum(c1, C - 1)]
        o2 = coffs_rep[jnp.minimum(c2, C - 1)]
        l1 = clen[jnp.minimum(c1, C - 1)]
        l2 = clen[jnp.minimum(c2, C - 1)]
        cap = c1.shape[0]

        def back(state):
            a, active = state
            ok = active & (j1 - a - 1 >= 0) & (j2 - a - 1 >= 0)
            v1 = fetch_val(o1 + j1 - a - 1, ok, cap)
            v2 = fetch_val(o2 + j2 - a - 1, ok, cap)
            ok = ok & (v1 == v2) & (v1 < BIG)
            return a + ok.astype(I32), ok

        def cond_any(state):
            return jax.lax.psum(jnp.any(state[1]).astype(I32), AXIS) > 0

        a_fin, _ = jax.lax.while_loop(
            cond_any, back, (jnp.zeros_like(j1), live)
        )

        def fwd(state):
            b, active = state
            ok = active & (j1 + b < l1) & (j2 + b < l2)
            v1 = fetch_val(o1 + j1 + b, ok, cap)
            v2 = fetch_val(o2 + j2 + b, ok, cap)
            ok = ok & (v1 == v2) & (v1 < BIG)
            return b + ok.astype(I32), ok

        b_fin, _ = jax.lax.while_loop(
            cond_any, fwd, (jnp.ones_like(j1), live)
        )
        return j1 - a_fin, j2 - a_fin, a_fin + b_fin, o1, l1

    s1, s2, L, o1c, l1c = extend(c1v, j1v, c2v, j2v, live0)

    # ---- end-reaching filter + (exact, replicated) adaptive gate -------
    def ksum(offs, lo, ln, live):
        cap = offs.shape[0]
        hi = fetch_pref(offs + lo + ln, live, cap)
        lo_ = fetch_pref(offs + lo, live, cap)
        return hi - lo_

    over = jnp.where(live0, ksum(o1c, s1, L, live0), 0)
    l2c = clen[jnp.minimum(c2v, C - 1)]
    reach = (s1 + L >= l1c) & ((s1 == 0) | (s2 == 0))
    cand_ok = live0 & reach
    over_m = jnp.where(cand_ok, over, UBIG)
    if adaptive:
        all_over = jax.lax.all_gather(over_m, AXIS).reshape(-1)
        n_c = jax.lax.psum(jnp.sum(cand_ok.astype(I32)), AXIS)
        overs_sorted = jax.lax.sort(all_over)
        k30 = (jnp.maximum(n_c - 1, 0).astype(jnp.float32) * 0.30).astype(I32)
        p30 = overs_sorted[jnp.clip(k30, 0, all_over.shape[0] - 1)]
        gate = jnp.clip(p30, np.uint32(min_over_floor), np.uint32(min_over))
        gate = jnp.where(n_c > 0, gate, np.uint32(min_over))
    else:
        gate = jnp.asarray(min_over, U32)
    acc = cand_ok & (over >= gate)

    # ---- long-edge matches on the same owner rows -----------------------
    longrow = (e3 < BIG) & (kmers[jnp.minimum(e3, E - 1)].astype(U32) >= gate)
    lsizes = jnp.where(
        longrow & (run_len3 > 1),
        jnp.minimum(np.int32(long_shift), run_end3 - ps),
        0,
    )
    lowner, lt, lrowv, long_ovf = ragged_expand(lsizes, long_budget)
    lprow = jnp.clip(lowner + 1 + lt, 0, R3 - 1)
    la = jnp.where(lrowv, c3[lowner], BIG)
    lj1 = jnp.where(lrowv, p3[lowner], 0)
    lb = jnp.where(lrowv, c3[lprow], BIG)
    lj2 = jnp.where(lrowv, p3[lprow], 0)
    llive = (la < BIG) & (lb < BIG)
    ls1, ls2, lL, _, _ = extend(la, lj1, lb, lj2, llive)

    # ---- boundary union pairs + rc images --------------------------------
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
    uowner, ut, urowv, pair_ovf = ragged_expand(usizes, pair_budget)
    ua = jnp.where(urowv, b1[uowner] + ut, 0)
    ub = jnp.where(urowv, b2[uowner] + ut, 0)

    # ---- distributed union-find over range-sharded labels ---------------
    me = jax.lax.axis_index(AXIS).astype(I32)
    label = me * per_label + jnp.arange(per_label, dtype=I32)

    def hook_round(lab):
        # capacity = the full pair budget: all of one shard's pairs may
        # hash to a single label owner
        la_ = _dist_label_gather(lab, ua, urowv, per_label, n_dev,
                                 pair_budget, use_ragged)
        lb_ = _dist_label_gather(lab, ub, urowv, per_label, n_dev,
                                 pair_budget, use_ragged)
        m = jnp.minimum(la_, lb_)
        lab = _dist_label_min(lab, ua, m, urowv, per_label, n_dev,
                              pair_budget, use_ragged)
        lab = _dist_label_min(lab, ub, m, urowv, per_label, n_dev,
                              pair_budget, use_ragged)
        # pointer jump: label <- min(label, label[label]) (distributed)
        jv = _dist_label_gather(lab, lab, lab < BIG, per_label, n_dev,
                                per_label, use_ragged)
        lab = jnp.minimum(lab, jnp.where(jv < BIG, jv, lab))
        jv = _dist_label_gather(lab, lab, lab < BIG, per_label, n_dev,
                                per_label, use_ragged)
        return jnp.minimum(lab, jnp.where(jv < BIG, jv, lab))

    def uf_fix(state):
        lab, _ = state
        nxt = hook_round(lab)
        ch = jax.lax.psum(jnp.any(nxt != lab).astype(I32), AXIS) > 0
        return nxt, ch

    label, _ = jax.lax.while_loop(
        lambda s: s[1], uf_fix, (hook_round(label), jnp.asarray(True))
    )

    # ---- Zipper over (head-class, edge-label)-hash owners ---------------
    inst_b = jnp.where(valid_pos, cstart[cid_safe] + cpos, 0)
    inst_lab = jnp.where(valid_pos, cvals, BIG)

    def zip_pass(lab, heads_off, tails_off):
        h = _dist_label_gather(lab, inst_b + heads_off, valid_pos,
                               per_label, n_dev, cap_rows, use_ragged)
        t_ = _dist_label_gather(lab, inst_b + tails_off, valid_pos,
                                per_label, n_dev, cap_rows, use_ragged)
        zowner = jnp.where(
            valid_pos,
            ((_fnv(h) ^ _fnv(inst_lab)) % np.uint32(n_dev)).astype(I32),
            n_dev,
        )
        (hh, ll, tt), _ = _exchange(
            (h, inst_lab, t_), zowner, n_dev, cap_rows,
            (BIG, BIG, BIG), use_ragged,
        )
        hk, lk, tk = jax.lax.sort((hh, ll, tt), num_keys=2, is_stable=False)
        same = (
            (hk == jnp.roll(hk, 1)) & (lk == jnp.roll(lk, 1))
            & (hk < BIG) & (lk < BIG)
        )
        same = same.at[0].set(False)
        ta = jnp.where(same, tk, 0)
        tb = jnp.where(same, jnp.roll(tk, 1), 0)
        m = jnp.minimum(ta, tb)
        lab = _dist_label_min(lab, ta, m, same, per_label, n_dev,
                              cap_rows, use_ragged)
        lab = _dist_label_min(lab, tb, m, same, per_label, n_dev,
                              cap_rows, use_ragged)
        for _ in range(2):
            jv = _dist_label_gather(lab, lab, lab < BIG, per_label, n_dev,
                                    per_label, use_ragged)
            lab = jnp.minimum(lab, jnp.where(jv < BIG, jv, lab))
        return lab

    def zip_fix(state):
        lab, _ = state
        nxt = zip_pass(zip_pass(lab, 0, 1), 1, 0)
        ch = jax.lax.psum(jnp.any(nxt != lab).astype(I32), AXIS) > 0
        return nxt, ch

    label, _ = jax.lax.while_loop(
        lambda s: s[1], zip_fix, (label, jnp.asarray(True))
    )
    for _ in range(4):
        jv = _dist_label_gather(label, label, label < BIG, per_label, n_dev,
                                per_label, use_ragged)
        label = jnp.minimum(label, jnp.where(jv < BIG, jv, label))
    ovf = (cand_ovf + long_ovf + pair_ovf).reshape(1)
    return label, ovf


def sharded_glue(mesh, cvals_blocks, ccid_blocks, cpos_blocks,
                 cvals_flat, prefx, coffs, cstart, clen, cinv, kmers,
                 n_bound: int, min_over: int, min_over_floor: int,
                 adaptive: bool, long_shift: int = 40,
                 use_ragged: bool | None = None,
                 value_shard: bool = False):
    """Host entry: closure-aligned row blocks (n_dev, rows) + flat closure
    values / kmer prefix (replicated, or range-sharded with
    value_shard=True) -> (labels (B,) numpy, overflow total)."""
    if use_ragged is None:
        use_ragged = on_accelerator()
    n_dev = mesh.devices.size
    rows = cvals_blocks.shape[1]
    per_label = -(-n_bound // n_dev)
    per_label = max(256, -(-per_label // 256) * 256)
    from jax.sharding import PartitionSpec as Pn

    if value_shard:
        # pad the flat arrays to an n_dev multiple for range sharding
        P0 = cvals_flat.shape[0]
        per_val = -(-P0 // n_dev)
        pad = per_val * n_dev - P0
        if pad:
            cvals_flat = jnp.concatenate(
                [cvals_flat, jnp.full((pad,), BIG, jnp.int32)]
            )
            prefx = jnp.concatenate(
                [prefx, jnp.full((pad,), prefx[-1], prefx.dtype)]
            )
    vspec = Pn(AXIS) if value_shard else Pn()
    fn = partial(
        _sharded_glue_local,
        n_dev=n_dev,
        per_label=per_label,
        min_over=min_over,
        min_over_floor=min_over_floor,
        adaptive=adaptive,
        long_shift=long_shift,
        cap_rows=rows,
        # owner shards process the whole received bucket (n_dev * rows)
        cand_budget=4 * n_dev * rows,
        long_budget=4 * n_dev * rows,
        pair_budget=8 * n_dev * rows,
        use_ragged=use_ragged,
        value_shard=value_shard,
    )
    from .dist import ensure_global, host_fetch

    in_specs = (Pn(AXIS), Pn(AXIS), Pn(AXIS),
                vspec, vspec, Pn(), Pn(), Pn(), Pn(), Pn())
    args = (
        cvals_blocks.reshape(-1), ccid_blocks.reshape(-1),
        cpos_blocks.reshape(-1),
        cvals_flat, prefx, coffs, cstart, clen, cinv, kmers,
    )
    labels, ovf = jax.shard_map(
        fn,
        mesh=mesh,
        check_vma=False,
        in_specs=in_specs,
        out_specs=(Pn(AXIS), Pn(AXIS)),
    )(*(ensure_global(mesh, s, a) for s, a in zip(in_specs, args)))
    labels = host_fetch(labels)[:n_bound]
    return labels, int(host_fetch(ovf).sum())


def split_closure_rows(cls, n_dev: int, bucket: int = 1024):
    """Flat closure position rows -> (n_dev, rows) closure-aligned blocks
    (a closure's rows never split across shards)."""
    n = len(cls)
    lens = np.array([len(c) for c in cls], dtype=np.int64)
    total = int(lens.sum())
    target = -(-total // n_dev)
    # greedy closure assignment
    blocks = [[] for _ in range(n_dev)]
    acc = 0
    d = 0
    for i in range(n):
        if acc >= target and d < n_dev - 1:
            d += 1
            acc = 0
        blocks[d].append(i)
        acc += int(lens[i])
    biggest = max((sum(int(lens[x]) for x in b) for b in blocks), default=1)
    rows = -(-max(biggest, bucket) // bucket) * bucket
    cv = np.full((n_dev, rows), BIG, np.int32)
    ci = np.full((n_dev, rows), BIG, np.int32)
    cp = np.zeros((n_dev, rows), np.int32)
    for d in range(n_dev):
        pos = 0
        for i in blocks[d]:
            l = int(lens[i])
            cv[d, pos : pos + l] = np.asarray(cls[i], np.int32)
            ci[d, pos : pos + l] = i
            cp[d, pos : pos + l] = np.arange(l, dtype=np.int32)
            pos += l
    return cv, ci, cp


def glue_closures_sharded(mesh, bg, cls, min_over_bases: int, adaptive: bool,
                          min_over_floor_bases: int = 100,
                          use_ragged: bool | None = None,
                          value_shard: bool = False):
    """Host wrapper mirroring device_nucleate.glue_closures_device, but over
    the mesh.  Returns (labels int64 (B,), overflow) — same partition."""
    from ..core.kmer_codec import K
    from .device_nucleate import _round_up

    n = len(cls)
    n_dev = mesh.devices.size
    if n == 0:
        return np.zeros(0, np.int64), 0
    lens = np.array([len(c) for c in cls], dtype=np.int64)
    cstart = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens + 1, out=cstart[1:])
    total = int(cstart[-1])
    cv, ci, cp = split_closure_rows(cls, n_dev)
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
    coffs = np.zeros(Cpad, np.int32)
    coffs[:n] = np.concatenate([[0], np.cumsum(lens)[:-1]])
    nflat = int(lens.sum())
    P = _round_up(nflat + 1, 1024)  # >= 1 pad slot: prefix index T stays < P
    flat = np.full(P, BIG, np.int32)
    flat[:nflat] = np.concatenate([np.asarray(c, np.int32) for c in cls])
    kmers = (bg.edges.lengths() - (K - 1)).astype(np.int32)
    Epad = _round_up(bg.n_edges, 256)
    km = np.zeros(Epad, np.int32)
    km[: bg.n_edges] = kmers
    # exclusive kmer prefix over flat positions (prefx[i] = sum before i)
    kmf = np.where(flat[:P] < np.int32(0x7FFFFFFF), km[np.minimum(
        np.maximum(flat[:P], 0), Epad - 1)], 0).astype(np.uint32)
    kmf[nflat:] = 0
    prefx = np.zeros(P, np.uint32)
    np.cumsum(kmf[:-1], out=prefx[1:], dtype=np.uint32)
    labels, ovf = sharded_glue(
        mesh, cv, ci, cp, jnp.asarray(flat), jnp.asarray(prefx),
        jnp.asarray(coffs),
        jnp.asarray(cst), jnp.asarray(cln), jnp.asarray(cin),
        jnp.asarray(km),
        n_bound=total,
        min_over=max(min_over_bases - (K - 1), 1),
        min_over_floor=max(min_over_floor_bases - (K - 1), 1),
        adaptive=adaptive,
        use_ragged=use_ragged,
        value_shard=value_shard,
    )
    return labels.astype(np.int64), ovf
