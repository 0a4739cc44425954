"""Blocked counting (HBM-bounded): bit-identical to the single program."""
import numpy as np

from supernova_tpu.core.kmer_codec import soa_to_np
from supernova_tpu.ingest.ingest import ingest_sim
from supernova_tpu.kmer import count as kcount
from supernova_tpu.sim import genome as sim


def _tables_equal(t1, t2):
    n1, n2 = int(t1.n_valid), int(t2.n_valid)
    assert n1 == n2
    assert np.array_equal(soa_to_np(t1.words)[:n1], soa_to_np(t2.words)[:n2])
    for f in ("count", "nbc", "left_mask", "right_mask"):
        assert np.array_equal(
            np.asarray(getattr(t1, f))[:n1], np.asarray(getattr(t2, f))[:n2]
        ), f


def _readset(rng, size=9000, bcs=60, err=0.002):
    g = sim.random_genome(rng, size, n_repeat_chunks=2, repeat_len=150)
    _, hb = sim.diploidize(rng, g, 0.001)
    wl = sim.make_whitelist(rng, 256)
    reads = sim.simulate_linked_reads(
        rng, (g, hb), wl, n_barcodes=bcs, molecules_per_barcode=2,
        molecule_len=3000, coverage_per_molecule=2.0, error_rate=err,
        bc_error_rate=0.02,
    )
    return ingest_sim(reads, wl)


def test_blocked_equals_single(rng):
    rs = _readset(rng)
    single = kcount.count_readset(rs)
    blocked = kcount.count_readset_blocked(rs, max_positions=200_000)
    _tables_equal(single, blocked)


def test_blocked_respects_barcode_boundaries(rng):
    rs = _readset(rng, bcs=40)
    blocks = kcount.split_readset_blocks(rs, 150_000)
    assert len(blocks) >= 2
    assert sum(b.n_reads for b in blocks) == rs.n_reads
    seen = []
    for b in blocks:
        bset = set(int(x) for x in b.bc[b.bc > 0])
        seen.append(bset)
    for i in range(len(seen)):
        for j in range(i + 1, len(seen)):
            assert not (seen[i] & seen[j]), "barcode split across blocks"


def test_blocked_unbarcoded(rng):
    rs = _readset(rng)
    rs.barcoded = False
    single = kcount.count_readset(rs)
    blocked = kcount.count_readset_blocked(rs, max_positions=200_000)
    _tables_equal(single, blocked)


def test_blocked_pathing_equals_single(rng):
    from supernova_tpu.align import pather
    from supernova_tpu.dbg import build as dbuild
    from supernova_tpu.dbg import graph as dgraph

    rs = _readset(rng)
    table = dbuild.trim_table(kcount.count_readset(rs), pad_multiple=256)
    bg = dgraph.from_device(dbuild.build_graph(table), table)
    single = pather.path_readset(bg, rs)
    blocked = pather._path_readset_blocked(bg, rs, pather.MAX_PATH, max_positions=200_000)
    n = rs.n_reads
    for f in range(5):
        a = np.asarray(single[f])[:n]
        b = np.asarray(blocked[f])[:n]
        assert np.array_equal(a, b), f


def test_partitioned_merge_equals_single(rng, monkeypatch):
    """When the concatenated per-block raw rows exceed MERGE_ROWS, the merge
    runs in kmer-range partitions — bit-identical to the one-shot merge
    (the 10 Mb full-coverage merge ran out of a 16 GB device's memory;
    this is the fix)."""
    rs = _readset(rng)
    single = kcount.count_readset(rs)
    monkeypatch.setattr(kcount, "MERGE_ROWS", 20_000)  # force many partitions
    blocked = kcount.count_readset_blocked(rs, max_positions=150_000)
    _tables_equal(single, blocked)


def test_partitioned_merge_skew(rng, monkeypatch):
    """A splitter landing inside one dominant leading word must not split a
    kmer's rows across partitions (partitions cut on word boundaries)."""
    rs = _readset(rng, size=4000)
    single = kcount.count_readset(rs)
    monkeypatch.setattr(kcount, "MERGE_ROWS", 4_000)
    blocked = kcount.count_readset_blocked(rs, max_positions=60_000)
    _tables_equal(single, blocked)


def test_oom_halving_retry(rng, monkeypatch):
    """count_readset halves the block size and retries when the blocked
    count raises a device ResourceExhausted (the 10 Mb OOM path)."""
    rs = _readset(rng)
    want = kcount.count_readset(rs)

    sizes = []
    real_blocked = kcount.count_readset_blocked

    def fake_blocked(rs_, max_positions=kcount.BLOCK_POSITIONS, **kw):
        sizes.append(max_positions)
        if len(sizes) < 3:  # first two attempts "OOM"
            raise ValueError("RESOURCE_EXHAUSTED: device backend error")
        return real_blocked(rs_, max_positions=max_positions, **kw)

    monkeypatch.setattr(kcount, "count_readset_blocked", fake_blocked)
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", 200_000)
    monkeypatch.setattr(kcount, "MIN_BLOCK_POSITIONS", 25_000)
    got = kcount.count_readset(rs)
    assert sizes == [200_000, 100_000, 50_000]
    _tables_equal(want, got)


def test_oom_retry_reraises_non_oom(rng, monkeypatch):
    rs = _readset(rng)

    def fake_blocked(rs_, **kw):
        raise ValueError("some other failure")

    monkeypatch.setattr(kcount, "count_readset_blocked", fake_blocked)
    monkeypatch.setattr(kcount, "BLOCK_POSITIONS", 200_000)
    import pytest as _pytest

    with _pytest.raises(ValueError, match="some other"):
        kcount.count_readset(rs)


def test_packed_block_path_bit_identical(rng):
    """count_block_raw_packed (compact transfers, device-side expansion)
    must be bit-identical to the host-expanded block path, and the blocked
    count must equal the single-program count through it."""
    import jax.numpy as jnp

    from supernova_tpu.ingest.reads import build_readset_flat
    from supernova_tpu.kmer import count as kcount

    rl, n_reads = 150, 2000
    g = rng.integers(0, 4, 2500)
    starts = rng.integers(0, len(g) - rl, n_reads)
    codes = g[np.add.outer(starts, np.arange(rl))].reshape(-1).astype(np.uint8)
    offsets = np.arange(n_reads + 1, dtype=np.int64) * rl
    quals = rng.choice([2, 20, 37], n_reads * rl, p=[0.02, 0.08, 0.9]).astype(
        np.uint8
    )
    bc = np.sort(rng.integers(0, 50, n_reads // 2)).astype(np.int32)
    rs = build_readset_flat(
        codes, offsets, quals, bc, n_barcodes=50, barcoded=True
    )

    full = kcount.prepare_reads(rs)
    pk = kcount.prepare_reads_packed(rs)
    assert pk is not None
    raw_f = kcount.count_block_raw(
        full["codes_ext"], full["pos_read"], full["glen_pos"],
        full["bc_pos"], uniform_rl=full["uniform_rl"],
    )
    raw_p = kcount.count_block_raw_packed(
        jnp.asarray(pk["codes_packed"]), jnp.asarray(pk["glen"]),
        jnp.asarray(pk["read_bc"]), jnp.asarray(np.int32(pk["n_reads"])),
        uniform_rl=pk["uniform_rl"], nbp=pk["nbp"],
    )
    nv = int(raw_f.n_valid)
    assert int(raw_p.n_valid) == nv and nv > 0
    for f in ("count", "stats"):
        assert np.array_equal(
            np.asarray(getattr(raw_f, f))[:nv],
            np.asarray(getattr(raw_p, f))[:nv],
        )
    for w in "abc":
        assert np.array_equal(
            np.asarray(getattr(raw_f.words, w))[:nv],
            np.asarray(getattr(raw_p.words, w))[:nv],
        )

    t_b = kcount.count_readset_blocked(rs, max_positions=120_000)
    t_s = kcount.count_readset(rs)
    nv = int(t_s.n_valid)
    assert nv > 500 and int(t_b.n_valid) == nv
    for f in ("count", "nbc", "left_mask", "right_mask"):
        assert np.array_equal(
            np.asarray(getattr(t_b, f))[:nv], np.asarray(getattr(t_s, f))[:nv]
        )
    for w in "abc":
        assert np.array_equal(
            np.asarray(getattr(t_b.words, w))[:nv],
            np.asarray(getattr(t_s.words, w))[:nv],
        )


def test_partitioned_merge_spill_resume(rng, tmp_path, monkeypatch):
    """Persistent spill dir: completed blocks are reused on resume, the meta
    guard invalidates stale spills, and results stay bit-identical."""
    rs = _readset(rng)
    single = kcount.count_readset(rs)
    monkeypatch.setattr(kcount, "MERGE_ROWS", 20_000)
    sd = tmp_path / "spill"
    b1 = kcount.count_readset_blocked(
        rs, max_positions=150_000, spill_dir=str(sd)
    )
    _tables_equal(single, b1)
    assert (sd / "meta.json").exists()
    oks = sorted(sd.glob("b*.ok"))
    assert len(oks) >= 2
    # simulate a partial run: drop one marker, resume re-counts only that one
    oks[1].unlink()
    b2 = kcount.count_readset_blocked(
        rs, max_positions=150_000, spill_dir=str(sd)
    )
    _tables_equal(single, b2)
    # different block size -> meta mismatch -> spills cleared, still identical
    b3 = kcount.count_readset_blocked(
        rs, max_positions=100_000, spill_dir=str(sd)
    )
    _tables_equal(single, b3)


def test_recompute_adjacencies_host_twin(rng):
    """The numpy adjacency recompute (bounded-memory 100 Mb endgame) is
    bit-identical to the jitted one — including pruning mask bits whose
    neighbor kmer is NOT in the table."""
    import jax.numpy as jnp

    from supernova_tpu.core import kmer_codec as kc

    rs = _readset(rng)
    t = kcount.count_readset(rs)
    n = int(t.n_valid)
    assert n > 500
    # corrupt the masks with extra bits so the recompute has real work
    lm = np.asarray(t.left_mask).copy()
    rm = np.asarray(t.right_mask).copy()
    lm[:n] |= rng.integers(0, 16, n).astype(np.uint32)
    rm[:n] |= rng.integers(0, 16, n).astype(np.uint32)
    t2 = t._replace(left_mask=jnp.asarray(lm), right_mask=jnp.asarray(rm))
    want = kcount.recompute_adjacencies(t2)
    wa = np.asarray(t.words.a)[:n]
    wb = np.asarray(t.words.b)[:n]
    wc = np.asarray(t.words.c)[:n]
    got_l, got_r = kcount.recompute_adjacencies_host(
        wa, wb, wc, lm[:n], rm[:n], chunk=257
    )
    assert np.array_equal(got_l, np.asarray(want.left_mask)[:n])
    assert np.array_equal(got_r, np.asarray(want.right_mask)[:n])
