"""Stream compaction (ops/segments.stable_compact): cumsum slots + one
unique-index scatter per column.  It is the one compaction of the count's
kept runs, the block merge and the glue cores."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supernova_tpu.ops import segments as seg


@pytest.mark.parametrize(
    "n,frac",
    [(1000, 0.03), (70000, 0.5), (32768, 0.0), (33000, 1.0)],
)
def test_compact_matches_reference(rng, n, frac):
    keep = rng.random(n) < frac
    cols = [
        rng.integers(0, 2**31, n).astype(np.uint32) for _ in range(3)
    ] + [rng.integers(-5, 2**30, n).astype(np.int32)]
    nv, out = seg.stable_compact(jnp.asarray(keep), *map(jnp.asarray, cols))
    assert int(nv) == keep.sum()
    for c, o in zip(cols, out):
        o = np.asarray(o)
        assert o.dtype == c.dtype
        assert np.array_equal(o[: int(nv)], c[keep])
        assert not o[int(nv):].any()  # tail zeroed


def test_compact_agrees_with_sort_path(rng):
    """Same result as the unstable 4-key compaction sort (keys ~valid,
    wa, wb, wc) that the count used before, on its precondition: rows
    sorted by words, kept rows distinct (run ends)."""
    n = 5000
    wa = np.sort(rng.integers(0, 2**20, n).astype(np.uint32))
    wb = rng.integers(0, 2**31, n).astype(np.uint32)
    wc = rng.integers(0, 2**31, n).astype(np.uint32)
    order = np.lexsort((wc, wb, wa))
    wa, wb, wc = wa[order], wb[order], wc[order]
    ends = np.ones(n, bool)
    ends[:-1] = (wa[1:] != wa[:-1]) | (wb[1:] != wb[:-1]) | (wc[1:] != wc[:-1])
    keep = ends & (rng.random(n) < 0.3)
    pay = rng.integers(0, 2**31, n).astype(np.uint32)

    @jax.jit
    def sort_path(valid, *cols):
        out = jax.lax.sort(((~valid).astype(jnp.uint32),) + cols, num_keys=4,
                           is_stable=False)
        live = jnp.arange(n) < jnp.sum(valid.astype(jnp.int32))
        return tuple(jnp.where(live, c, 0) for c in out[1:])

    cols = tuple(map(jnp.asarray, (wa, wb, wc, pay)))
    nv, got = seg.stable_compact(jnp.asarray(keep), *cols)
    ref = sort_path(jnp.asarray(keep), *cols)
    assert int(nv) == keep.sum()
    for s, p in zip(got, ref):
        assert np.array_equal(np.asarray(s), np.asarray(p))


def test_compact_is_stable_with_duplicate_words(rng):
    """Stable even when kept rows share identical words (the sort path
    needed distinct words)."""
    n = 700
    wa = np.zeros(n, np.uint32)
    keep = rng.random(n) < 0.4
    marker = np.arange(n, dtype=np.uint32)
    nv, (_, out_m) = seg.stable_compact(
        jnp.asarray(keep), jnp.asarray(wa), jnp.asarray(marker)
    )
    assert np.array_equal(np.asarray(out_m)[: int(nv)], marker[keep])
