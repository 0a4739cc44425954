"""Sharded barcode-link accumulation (AllTinks qept over the device mesh).

SURVEY §5.8: the reference accumulates barcode-link triples (edge, edge,
#shared good barcodes) in 20 batched host passes over an inverted
barcode->edge index (SecretOps.cc:807-867).  Mesh formulation:

  1. (barcode, item) incidence rows live data-parallel across the mesh;
  2. rows travel to their OWNER shard by barcode hash (ragged_all_to_all on
     an accelerator, dense all_to_all on CPU) — a barcode's rows are then
     complete on one shard, so pair generation is shard-local;
  3. pairs within a barcode run are generated by CAP-1 static shifted
     comparisons over the (barcode, item)-sorted rows (runs longer than CAP
     are dropped whole — the hot-barcode gate, same as the host engine's
     max_per_bc);
  4. local (i1, i2) partial counts are pre-reduced by one sort + run-sum,
     then travel to their owner shard by pair hash;
  5. the final sort + run-sum yields globally-correct triples, filtered at
     min_shared (>= 4 in the reference).

Tested bit-equal to asm/links.link_triples_np on the 8-device CPU mesh.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import segments as seg
from .mesh import AXIS
from .sharded_build import _exchange

I32 = jnp.int32
SENT = np.int32(0x7FFFFFFF)  # sorts last; never a real barcode/item id


def _fnv_mix(x):
    x = x.astype(jnp.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _pairs_from_sorted(bc_s, it_s, cap: int):
    """(barcode, item)-sorted rows -> per-offset pair columns.

    Returns (e1, e2) each ((cap-1)*N,) int32 with SENT rows for non-pairs.
    Runs longer than `cap` produce nothing (hot-barcode gate)."""
    n = bc_s.shape[0]
    p = jnp.arange(n, dtype=I32)
    starts = seg.run_starts(bc_s)
    run_start = jax.lax.cummax(jnp.where(starts, p, 0))
    ends = seg.run_end_mask(starts)
    # end of each row's run = the NEAREST end at or after the row
    run_end = jnp.flip(jax.lax.cummin(jnp.flip(jnp.where(ends, p, n))))
    klen = run_end - run_start + 1
    ok_row = (bc_s != SENT) & (klen <= cap)

    bcp = jnp.concatenate([bc_s, jnp.full((cap,), SENT, bc_s.dtype)])
    itp = jnp.concatenate([it_s, jnp.full((cap,), SENT, it_s.dtype)])
    okp = jnp.concatenate([ok_row, jnp.zeros((cap,), bool)])
    e1s, e2s = [], []
    for o in range(1, cap):
        bo = jax.lax.dynamic_slice(bcp, (o,), (n,))
        io = jax.lax.dynamic_slice(itp, (o,), (n,))
        ko = jax.lax.dynamic_slice(okp, (o,), (n,))
        good = ok_row & ko & (bc_s == bo)
        e1s.append(jnp.where(good, it_s, SENT))
        e2s.append(jnp.where(good, io, SENT))
    return jnp.concatenate(e1s), jnp.concatenate(e2s)


def _reduce_pairs(e1, e2, weight, out_cap: int):
    """Sort pairs, sum weights per (e1, e2) run, compact run totals.

    Returns (e1, e2, total) each (out_cap,) with SENT/0 padding, plus
    n_valid.  SENT pairs sort last and are excluded."""
    k1, k2, w = jax.lax.sort((e1, e2, weight), num_keys=2, is_stable=False)
    starts = seg.run_starts(k1, k2)
    cs = jnp.cumsum(w)
    base = seg.run_broadcast_from_start(cs - w, starts)
    total = cs - base
    ends = seg.run_end_mask(starts)
    keep = ends & (k1 != SENT)
    nv, (o1, o2, ot) = seg.stable_compact(keep, k1, k2, total)
    oc = min(out_cap, e1.shape[0])  # fewer input rows than requested slots

    def sl(a, fill):
        a = jax.lax.dynamic_slice(a, (0,), (oc,))
        if oc < out_cap:
            a = jnp.concatenate([a, jnp.full((out_cap - oc,), fill, a.dtype)])
        return a

    m = jnp.arange(out_cap) < nv
    return (
        jnp.where(m, sl(o1, SENT), SENT),
        jnp.where(m, sl(o2, SENT), SENT),
        jnp.where(m, sl(ot, 0), 0),
        jnp.minimum(nv, out_cap),
    )


@partial(jax.jit, static_argnames=("cap", "out_cap", "min_shared"))
def bc_link_triples(bc, item, cap: int = 16, out_cap: int | None = None,
                    min_shared: int = 1):
    """Single-device AllTinks: (barcode, item) incidence rows (SENT-padded)
    -> link triples (i1, i2, shared >= min_shared), (out_cap,)-padded.

    Device analogue of asm/links.link_triples_np(max_per_bc=cap)."""
    n = bc.shape[0]
    if out_cap is None:
        out_cap = n
    bc_s, it_s = jax.lax.sort(
        (bc.astype(I32), item.astype(I32)), num_keys=2, is_stable=False
    )
    e1, e2 = _pairs_from_sorted(bc_s, it_s, cap)
    w = (e1 != SENT).astype(I32)
    o1, o2, tot, nv = _reduce_pairs(e1, e2, w, out_cap)
    ok = tot >= min_shared
    nv2, (o1, o2, tot) = seg.stable_compact(ok & (o1 != SENT), o1, o2, tot)
    m = jnp.arange(o1.shape[0]) < nv2
    return (
        jnp.where(m, o1, SENT),
        jnp.where(m, o2, SENT),
        jnp.where(m, tot, 0),
        nv2,
    )


def _sharded_links_local(bc, item, n_dev: int, cap: int, cap_rows: int,
                         out_cap: int, min_shared: int, use_ragged: bool):
    """Per-device body under shard_map."""
    owner = (_fnv_mix(bc) % np.uint32(n_dev)).astype(I32)
    owner = jnp.where(bc == SENT, n_dev, owner)  # pad rows go nowhere
    (bc_r, it_r), _ = _exchange(
        (bc.astype(I32), item.astype(I32)), owner, n_dev, cap_rows,
        (SENT, SENT), use_ragged,
    )
    bc_s, it_s = jax.lax.sort((bc_r, it_r), num_keys=2, is_stable=False)
    e1, e2 = _pairs_from_sorted(bc_s, it_s, cap)
    # local pre-reduce: one row per (pair, this shard)
    l1, l2, lw, _ = _reduce_pairs(e1, e2, (e1 != SENT).astype(I32),
                                  e1.shape[0])
    powner = ((_fnv_mix(l1) ^ _fnv_mix(l2)) % np.uint32(n_dev)).astype(I32)
    powner = jnp.where(l1 == SENT, n_dev, powner)
    (g1, g2, gw), _ = _exchange(
        (l1, l2, lw), powner, n_dev, cap_rows, (SENT, SENT, 0), use_ragged
    )
    o1, o2, tot, _ = _reduce_pairs(g1, g2, gw, out_cap)
    ok = (tot >= min_shared) & (o1 != SENT)
    nv, (o1, o2, tot) = seg.stable_compact(ok, o1, o2, tot)
    m = jnp.arange(out_cap) < nv
    return (
        jnp.where(m, o1, SENT),
        jnp.where(m, o2, SENT),
        jnp.where(m, tot, 0),
        nv.reshape(1),
    )


def sharded_bc_links(mesh, bc_shards, item_shards, cap: int = 16,
                     cap_rows: int | None = None, out_cap: int = 4096,
                     min_shared: int = 1, use_ragged: bool = False):
    """Barcode-link triples over an n-device mesh.

    bc_shards/item_shards: (n_dev, rows_per_dev) int32, SENT-padded.
    Returns (i1, i2, shared) numpy arrays, globally sorted by (i1, i2)."""
    n_dev = mesh.devices.size
    rows = bc_shards.shape[1]
    if cap_rows is None:
        cap_rows = rows
    fn = jax.shard_map(
        partial(
            _sharded_links_local, n_dev=n_dev, cap=cap, cap_rows=cap_rows,
            out_cap=out_cap, min_shared=min_shared, use_ragged=use_ragged,
        ),
        mesh=mesh,
        check_vma=False,
        in_specs=(jax.sharding.PartitionSpec(AXIS),) * 2,
        out_specs=(jax.sharding.PartitionSpec(AXIS),) * 4,
    )
    o1, o2, tot, nv = fn(
        bc_shards.reshape(n_dev * rows), item_shards.reshape(n_dev * rows)
    )
    o1 = np.asarray(o1).reshape(n_dev, out_cap)
    o2 = np.asarray(o2).reshape(n_dev, out_cap)
    tot = np.asarray(tot).reshape(n_dev, out_cap)
    nv = np.asarray(nv).reshape(n_dev)
    i1 = np.concatenate([o1[d, : nv[d]] for d in range(n_dev)])
    i2 = np.concatenate([o2[d, : nv[d]] for d in range(n_dev)])
    s = np.concatenate([tot[d, : nv[d]] for d in range(n_dev)])
    order = np.lexsort((i2, i1))
    return (
        i1[order].astype(np.int64),
        i2[order].astype(np.int64),
        s[order].astype(np.int64),
    )


def split_incidence(bcv, item, n_dev: int, bucket: int = 256):
    """Host prep: flat incidence rows -> (n_dev, rows) SENT-padded shards."""
    n = len(bcv)
    per = -(-max(n, 1) // n_dev)
    per = -(-per // bucket) * bucket
    bc_sh = np.full((n_dev, per), SENT, np.int32)
    it_sh = np.full((n_dev, per), SENT, np.int32)
    for d in range(n_dev):
        lo, hi = d * per, min((d + 1) * per, n)
        if hi > lo:
            bc_sh[d, : hi - lo] = bcv[lo:hi]
            it_sh[d, : hi - lo] = item[lo:hi]
    return bc_sh, it_sh
