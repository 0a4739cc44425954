"""Per-run statistics of the count (kmer/count.run_stats via
reduce_occurrences and the blocked count's unfiltered reduce) against a
brute-force model of the Kmerizer::reduce rules, including a long run of
one kmer."""
import jax.numpy as jnp
import numpy as np
import pytest

from supernova_tpu.core import kmer_codec as kc
from supernova_tpu.kmer import count as kcount


def make_occurrences(rng, n, n_kmers, long_run=None):
    """Unsorted occurrence rows: ~10% invalid (sentinel words), ~20% of the
    valid rows from barcode-ignored reads; one kmer repeated over a long
    stretch when long_run=(lo, hi)."""
    ids = rng.integers(0, n_kmers, n)
    if long_run is not None:
        ids[long_run[0]:long_run[1]] = ids[long_run[0]]
    w0 = (ids // 1000).astype(np.uint32)
    w1 = (ids % 1000).astype(np.uint32)
    w2 = (ids * 7 % 911).astype(np.uint32)
    valid = rng.random(n) < 0.9
    bc = rng.integers(1, 50, n).astype(np.int32)
    bc[rng.random(n) < 0.2] = kcount.BC_IGNORED
    lm = rng.integers(0, 16, n).astype(np.uint32)
    rm = rng.integers(0, 16, n).astype(np.uint32)
    s = np.uint32(kc.SENTINEL)
    words = tuple(np.where(valid, w, s) for w in (w0, w1, w2))
    return words, bc, lm, rm, valid


def brute(words, bc, lm, rm, valid):
    """kmer (w0, w1, w2) -> [count, {barcodes}, has_ign, lm, rm]."""
    out = {}
    for i in np.flatnonzero(valid):
        k = (int(words[0][i]), int(words[1][i]), int(words[2][i]))
        e = out.setdefault(k, [0, set(), False, 0, 0])
        e[0] += 1
        if bc[i] == kcount.BC_IGNORED:
            e[2] = True
        elif bc[i] > 0:
            e[1].add(int(bc[i]))
        e[3] |= int(lm[i])
        e[4] |= int(rm[i])
    return out


def _dev(words, bc, lm, rm, valid):
    return (kc.W3(*map(jnp.asarray, words)), jnp.asarray(bc), jnp.asarray(lm),
            jnp.asarray(rm), jnp.asarray(valid))


@pytest.mark.parametrize("n", [128 * 64, 128 * (256 + 64)])
def test_reduce_occurrences_matches_brute(rng, n):
    occ = make_occurrences(rng, n, max(40, n // 50), (n // 3, n // 3 + 1024))
    want = {
        k: e for k, e in brute(*occ).items()
        if e[0] >= 3 and (e[2] or len(e[1]) >= 2)
    }
    t = kcount.reduce_occurrences(*_dev(*occ), min_freq=3, min_bc=2)
    m = int(t.n_valid)
    got = list(zip(*(np.asarray(x)[:m] for x in t.words)))
    assert got == sorted(want)
    for j, k in enumerate(got):
        cnt, bcs, _, l, r = want[k]
        assert int(t.count[j]) == cnt
        assert int(t.nbc[j]) == len(bcs)
        assert int(t.left_mask[j]) == l and int(t.right_mask[j]) == r


@pytest.mark.parametrize("n", [128 * 64, 128 * (256 + 64)])
def test_raw_block_stats_match_brute(rng, n):
    occ = make_occurrences(rng, n, max(40, n // 50), (n // 3, n // 3 + 1024))
    want = brute(*occ)
    t = kcount._reduce_occurrences_raw(*_dev(*occ))
    m = int(t.n_valid)
    got = list(zip(*(np.asarray(x)[:m] for x in t.words)))
    assert got == sorted(want)
    st = np.asarray(t.stats)[:m]
    for j, k in enumerate(got):
        cnt, bcs, ign, l, r = want[k]
        assert int(t.count[j]) == cnt
        assert (st[j] >> 9) & 4095 == min(len(bcs), 4095)
        assert (st[j] >> 5) & 15 == l and (st[j] >> 1) & 15 == r
        assert bool(st[j] & 1) == ign
