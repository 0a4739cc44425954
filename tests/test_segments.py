import jax.numpy as jnp
import numpy as np

from supernova_tpu.ops import segments as seg


def test_run_starts_and_ids():
    keys = jnp.asarray(np.array([1, 1, 2, 2, 2, 5, 7, 7]))
    starts = np.asarray(seg.run_starts(keys))
    assert starts.tolist() == [True, False, True, False, False, True, True, False]
    ids = np.asarray(seg.segment_ids_from_starts(jnp.asarray(starts)))
    assert ids.tolist() == [0, 0, 1, 1, 1, 2, 3, 3]


def test_run_starts_multi_key_2d():
    w = jnp.asarray(np.array([[1, 2], [1, 2], [1, 3], [2, 3]], dtype=np.uint32))
    starts = np.asarray(seg.run_starts(w))
    assert starts.tolist() == [True, False, True, True]


def test_seg_reductions():
    ids = jnp.asarray(np.array([0, 0, 1, 1, 1, 2], dtype=np.int32))
    vals = jnp.asarray(np.array([1, 2, 3, 4, 5, 6], dtype=np.int32))
    assert np.asarray(seg.seg_sum(vals, ids, 6)).tolist() == [3, 12, 6, 0, 0, 0]
    assert np.asarray(seg.seg_max(vals, ids, 6))[:3].tolist() == [2, 5, 6]



def test_stable_compact():
    valid = jnp.asarray(np.array([False, True, False, True, True]))
    a = jnp.asarray(np.array([10, 11, 12, 13, 14], dtype=np.int32))
    w = jnp.asarray(np.arange(10, dtype=np.uint32).reshape(5, 2))
    n, (a2, w2) = seg.stable_compact(valid, a, w)
    assert int(n) == 3
    assert np.asarray(a2)[:3].tolist() == [11, 13, 14]
    assert np.asarray(w2)[:3].tolist() == [[2, 3], [6, 7], [8, 9]]


def test_compact_sorted_words_matches_stable():
    """The count's compaction case: rows sorted by words, kept rows are the
    distinct run ends; stable_compact keeps them in word order with every
    payload, exactly as numpy boolean indexing does."""
    rng = np.random.default_rng(3)
    n = 4096
    # sorted-by-words rows with duplicates (runs)
    wa = np.sort(rng.integers(0, 50, n).astype(np.uint32))
    wb = np.zeros(n, np.uint32)
    wc = np.arange(n, dtype=np.uint32) // 7  # runs share wc too
    order = np.lexsort((wc, wb, wa))
    wa, wc = wa[order], wc[order]
    # keep = last row of each (wa, wb, wc) run -> distinct kept words
    last = np.concatenate(
        [(wa[1:] != wa[:-1]) | (wc[1:] != wc[:-1]), [True]]
    )
    pay1 = rng.integers(0, 1000, n).astype(np.uint32)
    pay2 = rng.integers(0, 1000, n).astype(np.uint32)
    cols = (wa, wb, wc, pay1, pay2)
    nv, res = seg.stable_compact(jnp.asarray(last), *map(jnp.asarray, cols))
    k = int(nv)
    assert k == last.sum()
    for c, r in zip(cols, res):
        assert np.array_equal(np.asarray(r)[:k], c[last])
