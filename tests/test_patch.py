"""Gap patching: a low-coverage hole splits the graph; spanning mate pairs +
a single hole-covering read let patching re-join it (the DF patch stage)."""
import numpy as np
import pytest

from supernova_tpu.asm import patch as apatch
from supernova_tpu.align import pather
from supernova_tpu.core import dna
from supernova_tpu.core.kmer_codec import K
from supernova_tpu.dbg import build as dbuild
from supernova_tpu.dbg import graph as dgraph
from supernova_tpu.ingest.reads import build_readset
from supernova_tpu.kmer import count as kcount


def test_patch_closes_coverage_gap(rng):
    from supernova_tpu.sim import genome as sim

    g = sim.random_genome(rng, 3000)
    hole_lo, hole_hi = 1400, 1480
    read_len, insert = 150, 500

    reads, quals = [], []

    def q():
        return np.full(read_len, 37, np.uint8)

    def overlaps_hole(a, b):
        return not (b <= hole_lo or a >= hole_hi)

    # proper mate pairs tiling the genome; reads overlapping the hole are
    # dropped (=> its kmers fall below min_freq), but pairs *spanning* it
    # survive and link the two flanking edges
    for s in range(0, len(g) - insert, 17):
        r1_span = (s, s + read_len)
        r2_span = (s + insert - read_len, s + insert)
        if overlaps_hole(*r1_span) or overlaps_hole(*r2_span):
            continue
        reads.append(g[r1_span[0] : r1_span[1]].copy())
        quals.append(q())
        reads.append(dna.revcomp(g[r2_span[0] : r2_span[1]]).copy())
        quals.append(q())
    # one long rescue read covering the hole + both flanks: its kmers appear
    # once -> filtered from the graph, but its bases feed the local assembler
    reads.append(g[hole_lo - 70 : hole_hi + 150].copy())
    quals.append(np.full(70 + (hole_hi - hole_lo) + 150, 37, np.uint8))
    reads.append(dna.revcomp(g[2000:2150]).copy())
    quals.append(q())

    rs = build_readset(reads, quals, np.zeros(len(reads) // 2, np.int32),
                       n_barcodes=0, barcoded=False)

    table = dbuild.trim_table(kcount.count_readset(rs, min_freq=2), pad_multiple=256)
    bg = dgraph.from_device(dbuild.build_graph(table), table)
    # the hole must have split the genome into >= 2 unipaths per strand
    assert bg.n_edges >= 4

    rp = pather.path_readset(bg, rs)
    edges = np.asarray(rp.edges)[: rs.n_reads]
    plen = np.asarray(rp.path_len)[: rs.n_reads]

    pairs = apatch.find_edge_pairs(bg, edges, plen, dup=None, min_support=2)
    assert pairs, "no gap pairs found"

    closures = apatch.close_gaps(bg, rs, pairs)
    assert closures, "no closures built"
    gs = dna.codes_to_seq(g)
    gr = dna.codes_to_seq(dna.revcomp(g))
    for c in closures:
        s2 = dna.codes_to_seq(c)
        assert s2 in gs or s2 in gr, "chimeric closure"

    new_bg, n_pairs, n_closed = apatch.patch_graph(bg, rs, edges, plen, None)
    new_bg.validate()
    # the patched graph joins across the hole
    assert new_bg.edges.lengths().max() > bg.edges.lengths().max()


def test_insert_patches_runs_on_default_device(rng, monkeypatch):
    """The rebuild runs on the default device: it neither asks for the CPU
    device nor opens a device context, whatever the backend."""
    import jax

    from supernova_tpu.sim import genome as sim

    g = sim.random_genome(rng, 2000)
    seqs = [g[:1000].copy(), g[1010:].copy()]
    prs = build_readset(
        seqs, [np.full(len(s), 37, np.uint8) for s in seqs],
        np.zeros(1, np.int32), n_barcodes=0, barcoded=False,
    )
    table = dbuild.trim_table(
        kcount.count_readset(prs, min_freq=1, min_read_len=K)
    )
    bg = dgraph.from_device(dbuild.build_graph(table), table)
    assert int(bg.edges.lengths().max()) < len(g)

    def no_context(*a, **k):
        raise AssertionError("insert_patches opened a device context")

    monkeypatch.setattr(jax, "default_device", no_context)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    closure = g[1000 - 2 * K : 1010 + 2 * K].copy()
    new_bg = apatch.insert_patches(bg, [closure])
    assert int(new_bg.edges.lengths().max()) == len(g)
