"""Codec invariants: pack/unpack, rc involution, canonical ordering, search.

Mirrors the reference's kmer data-structure round-trip tests
(lib/tada/src/kmer/mod.rs:858 #[cfg(test)], bitenc.rs:469).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from supernova_tpu.core import dna, kmer_codec as kc
from supernova_tpu.core.kmer_codec import W3, np_to_soa, soa_to_np


def random_codes(rng, n):
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def test_dna_roundtrip(rng):
    codes = random_codes(rng, 301)
    seq = dna.codes_to_seq(codes)
    assert np.array_equal(dna.seq_to_codes(seq), codes)
    assert np.array_equal(dna.revcomp(dna.revcomp(codes)), codes)


def test_pack_unpack_roundtrip(rng):
    codes = random_codes(rng, kc.K)
    words = kc.words_from_codes_np(codes)
    assert np.array_equal(kc.codes_from_words_np(words), codes)


def test_sliding_words_matches_np(rng):
    n = 57
    codes = random_codes(rng, n + kc.K - 1)
    ws = soa_to_np(kc.sliding_words(codes, n))
    for p in range(n):
        expect = kc.words_from_codes_np(codes[p : p + kc.K])
        assert np.array_equal(ws[p], expect), p


@pytest.mark.parametrize("n", [512, 128 * 300])
def test_sliding_words_block_widths(rng, n):
    """sliding_words at one and at several 32k-row block widths, against a
    numpy shift-or brute force over every start position."""
    codes = rng.integers(0, 4, n + 128, dtype=np.int32)
    ws = kc.sliding_words(codes, n)
    win = np.lib.stride_tricks.sliding_window_view(codes[: n + kc.K - 1], kc.K)
    for j, got in enumerate((ws.a, ws.b, ws.c)):
        part = win[:, 16 * j : 16 * (j + 1)].astype(np.uint64)
        want = (part << (2 * np.arange(15, -1, -1, dtype=np.uint64))).sum(1)
        assert np.array_equal(np.asarray(got), want.astype(np.uint32))


def test_rc_words_matches_np(rng):
    codes = random_codes(rng, kc.K + 9)
    ws = kc.sliding_words(codes, 10)
    rc = soa_to_np(kc.rc_words(ws))
    for p in range(10):
        expect = kc.words_from_codes_np(dna.revcomp(codes[p : p + kc.K]))
        assert np.array_equal(rc[p], expect), p
    # involution
    assert np.array_equal(soa_to_np(kc.rc_words(kc.rc_words(ws))), soa_to_np(ws))


def test_lexicographic_matches_base_order(rng):
    # word order must equal base-string order
    for _ in range(50):
        a = random_codes(rng, kc.K)
        b = random_codes(rng, kc.K)
        wa = np_to_soa(kc.words_from_codes_np(a)[None])
        wb = np_to_soa(kc.words_from_codes_np(b)[None])
        lt = bool(np.asarray(kc.lex_lt(wa, wb))[0])
        assert lt == (dna.codes_to_seq(a) < dna.codes_to_seq(b))


def test_canonicalize(rng):
    codes = random_codes(rng, kc.K + 99)
    ws = kc.sliding_words(codes, 100)
    canon, flipped = kc.canonicalize(ws)
    canon_np = soa_to_np(canon)
    rc = soa_to_np(kc.rc_words(ws))
    ws_np = soa_to_np(ws)
    for p in range(100):
        fwd = dna.codes_to_seq(kc.codes_from_words_np(ws_np[p]))
        rcs = dna.codes_to_seq(kc.codes_from_words_np(rc[p]))
        got = dna.codes_to_seq(kc.codes_from_words_np(canon_np[p]))
        assert got == min(fwd, rcs)
    # canonical sentinel safety: all-ones can never be canonical
    assert not np.any(np.all(canon_np == kc.SENTINEL, axis=-1))


def test_successor_predecessor(rng):
    codes = random_codes(rng, kc.K)
    w = np_to_soa(kc.words_from_codes_np(codes)[None])
    for b in range(4):
        succ = soa_to_np(kc.successor_words(w, jnp.full((1,), b)))[0]
        expect = kc.words_from_codes_np(np.concatenate([codes[1:], [b]]))
        assert np.array_equal(succ, expect)
        pred = soa_to_np(kc.predecessor_words(w, jnp.full((1,), b)))[0]
        expect = kc.words_from_codes_np(np.concatenate([[b], codes[:-1]]))
        assert np.array_equal(pred, expect)
    assert int(kc.first_base(w)[0]) == codes[0]
    assert int(kc.last_base(w)[0]) == codes[-1]


def test_unpack_bases(rng):
    codes = random_codes(rng, kc.K + 4)
    w = kc.sliding_words(codes, 5)
    dense = np.asarray(kc.unpack_bases(w))
    for p in range(5):
        assert np.array_equal(dense[p], codes[p : p + kc.K])


def test_sort_and_search(rng):
    n = 500
    codes = random_codes(rng, n + kc.K - 1)
    ws, _ = kc.canonicalize(kc.sliding_words(codes, n))
    ws_sorted, _, _ = kc.sort_by_words(ws)
    ws_np = soa_to_np(ws_sorted)
    # sorted lexicographically
    keys = [tuple(row) for row in ws_np.tolist()]
    assert keys == sorted(keys)
    # search finds every member
    idx, found = kc.searchsorted_words(ws_sorted, ws)
    assert bool(np.all(np.asarray(found)))
    hit_rows = ws_np[np.asarray(idx)]
    assert np.array_equal(hit_rows, soa_to_np(ws))
    # membership result agrees with a python-set check
    probe = np_to_soa(np.array([[0, 0, 1]], dtype=np.uint32))
    in_table = any(t == (0, 0, 1) for t in keys)
    _, found = kc.searchsorted_words(ws_sorted, probe)
    assert bool(found[0]) == in_table


def test_searchsorted_with_sentinel_padding(rng):
    n = 100
    codes = random_codes(rng, n + kc.K - 1)
    ws, _ = kc.canonicalize(kc.sliding_words(codes, n))
    ws_sorted, _, _ = kc.sort_by_words(ws)
    padded = np.full((256, 3), kc.SENTINEL, dtype=np.uint32)
    padded[:n] = soa_to_np(ws_sorted)
    idx, found = kc.searchsorted_words(np_to_soa(padded), ws)
    assert bool(np.all(np.asarray(found)))
    assert np.all(np.asarray(idx) < n)
