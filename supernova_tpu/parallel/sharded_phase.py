"""Mesh-parallel Flipper support accumulation (molecule votes via psum).

SURVEY §5.8: phasing consumes a bubble x molecule support matrix
s[b, m] = reads(arm0) - reads(arm1) (Flipper.cc:36-75 BandedMatrix).  The
reads live data-parallel across the mesh after pathing, so the mesh-native
formulation keeps them there: each device scatter-adds its shard's votes
(read placed on an arm edge -> +/-1 per read into its (bubble, barcode)
cell) into a local dense matrix, and one psum over the mesh yields the
full matrix on every device.  The flip search itself stays host-side — a
line's matrix is small (10^2-10^4 cells) while the votes are read-scale.

Tested identical to asm/phasing._support_matrix on the 8-device CPU mesh
(driver dryrun part 6 + tests/test_sharded_phase.py).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .mesh import AXIS

I32 = jnp.int32


def _votes_local(re, rb, edge_bubble, edge_sign, n_bubbles: int, n_mols: int):
    """One shard's (read_edge, read_bc) rows -> psum'd (B, M) vote matrix."""
    e = jnp.clip(re, 0, edge_bubble.shape[0] - 1)
    bub = edge_bubble[e]
    sgn = edge_sign[e]
    valid = (re >= 0) & (bub >= 0) & (rb >= 0) & (rb < n_mols)
    b_ix = jnp.where(valid, bub, 0)
    m_ix = jnp.where(valid, rb, 0)
    v = jnp.where(valid, sgn, 0).astype(I32)
    mat = jnp.zeros((n_bubbles, n_mols), I32).at[b_ix, m_ix].add(v)
    return jax.lax.psum(mat, AXIS)


def sharded_vote_matrix(
    mesh, edge_bubble, edge_sign, read_edge_sh, read_bc_sh,
    n_bubbles: int, n_mols: int,
):
    """Accumulate the phasing support matrix over the mesh.

    edge_bubble: (E,) int32, bubble index of each D-edge or -1;
    edge_sign: (E,) int32, +1 for arm0 edges, -1 for arm1, 0 otherwise;
    read_edge_sh/read_bc_sh: (n_dev, rows) shards of per-read vote rows
    (-1 padded; one row per read placed on an arm edge).
    -> (n_bubbles, n_mols) numpy int32, identical on every device."""
    n_dev = mesh.devices.size
    rows = read_edge_sh.shape[1]
    fn = jax.shard_map(
        partial(
            _votes_local,
            edge_bubble=jnp.asarray(edge_bubble, I32),
            edge_sign=jnp.asarray(edge_sign, I32),
            n_bubbles=n_bubbles, n_mols=n_mols,
        ),
        mesh=mesh,
        check_vma=False,
        in_specs=(jax.sharding.PartitionSpec(AXIS),) * 2,
        out_specs=jax.sharding.PartitionSpec(),
    )
    out = fn(
        np.asarray(read_edge_sh, np.int32).reshape(n_dev * rows),
        np.asarray(read_bc_sh, np.int32).reshape(n_dev * rows),
    )
    return np.asarray(out)


def split_votes(read_edge, read_bc, n_dev: int, bucket: int = 256):
    """Host prep: flat vote rows -> (n_dev, rows) -1-padded shards."""
    n = len(read_edge)
    per = -(-max(n, 1) // n_dev)
    per = -(-per // bucket) * bucket
    re_sh = np.full((n_dev, per), -1, np.int32)
    rb_sh = np.full((n_dev, per), -1, np.int32)
    for d in range(n_dev):
        lo, hi = d * per, min((d + 1) * per, n)
        if hi > lo:
            re_sh[d, : hi - lo] = read_edge[lo:hi]
            rb_sh[d, : hi - lo] = read_bc[lo:hi]
    return re_sh, rb_sh
