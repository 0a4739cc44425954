"""Benchmark: 48-mer counting throughput on the real device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

The north-star metric (BASELINE.json) is k-mers/s/chip.  vs_baseline is
measured against the reference's MSP stage envelope: 4 threads per 8-GB
chunk scanning ~8 fastq files (lib/tada/src/cmd_msp.rs:31,264-280); public
MSPKmerCounter-class CPU counters sustain ~10-20M kmers/s on such a budget —
we use 20M kmers/s as the reference-per-node figure (generous to the
reference).
"""
from __future__ import annotations

import json
import time

import numpy as np

REFERENCE_KMERS_PER_SEC = 20e6
# Reference pather envelope: HBVPather::algorithmTwo runs OpenMP-parallel on
# the 28-thread asmlarge node (10X/paths/ReadPathVecX.cc class machinery);
# public DISCOVAR-class pathing sustains ~20-40k reads/s on such a node — we
# use 40k reads/s as the reference-per-node figure (generous to the
# reference).
REFERENCE_READS_PER_SEC = 40e3


def device_line() -> dict:
    """The device JAX runs on, as the results name it; exits non-zero when
    that is not a GPU (a CPU number is not a device metric)."""
    import jax

    d = jax.devices()[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
    if d.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {info}")
    return info


def main():
    device = device_line()
    import jax

    from supernova_tpu.core.jaxconfig import ensure_cache

    ensure_cache()

    from supernova_tpu.kmer.count import count_kmers

    rng = np.random.default_rng(0)
    read_len = 150
    # ~48M bases => ~33M kmer positions per iteration
    n_reads = 320_000
    nb = n_reads * read_len
    from supernova_tpu.core.kmer_codec import K

    # reads tile a 1 Mb genome at ~48x so the filter keeps realistic tables
    genome = rng.integers(0, 4, 1_000_000)
    starts = rng.integers(0, len(genome) - read_len, n_reads)
    flat = genome[np.add.outer(starts, np.arange(read_len))].reshape(-1)
    codes_ext = np.zeros(nb + 128, dtype=np.int32)
    codes_ext[:nb] = flat
    pos_read = np.repeat(np.arange(n_reads, dtype=np.int32), read_len)
    glen_pos = np.full(nb, read_len, dtype=np.int32)
    bc_pos = np.repeat(
        rng.integers(1, 1_000_000, n_reads).astype(np.int32), read_len
    )

    args = tuple(
        map(jax.numpy.asarray, (codes_ext, pos_read, glen_pos, bc_pos))
    )

    @jax.jit
    def step(codes_ext, pos_read, glen_pos, bc_pos):
        t = count_kmers(
            codes_ext, pos_read, glen_pos, bc_pos, uniform_rl=read_len
        )
        return t.n_valid

    # warmup/compile (int() forces a full device round trip)
    int(step(*args))

    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        int(step(*args))
    dt = (time.perf_counter() - t0) / iters

    kmer_positions = nb - n_reads * (K - 1)
    kps = kmer_positions / dt

    def count_line(extra):
        return json.dumps(
            {
                "metric": "kmer_count_throughput",
                "value": round(kps, 1),
                "unit": "kmers/s/chip",
                "vs_baseline": round(kps / REFERENCE_KMERS_PER_SEC, 3),
                "extra": extra,
            }
        )

    extra = {"device": device}
    extra.update(bench_pather(rng.integers(0, 4, 1_000_000), rng))
    print(count_line(extra), flush=True)


def bench_pather(genome, rng):
    """Reads-aligned/s on the real device: build the 1 Mb DBG once, then
    time warm path_readset iterations over ~100k 150-mers."""
    from supernova_tpu.align import pather
    from supernova_tpu.dbg import build as dbuild
    from supernova_tpu.dbg import graph as dgraph
    from supernova_tpu.ingest.reads import build_readset_flat
    from supernova_tpu.kmer import count as kcount

    read_len = 150
    n_reads = 100_000
    starts = rng.integers(0, len(genome) - read_len, n_reads)
    flat = genome[np.add.outer(starts, np.arange(read_len))].reshape(-1)
    offsets = np.arange(n_reads + 1, dtype=np.int64) * read_len
    quals = np.full(flat.shape, 37, np.uint8)
    bc = np.zeros(n_reads // 2, dtype=np.int32)
    rs = build_readset_flat(
        flat.astype(np.uint8), offsets, quals, bc, n_barcodes=0, barcoded=False
    )

    table = dbuild.trim_table(
        kcount.count_readset(rs, min_freq=2), pad_multiple=256
    )
    bg = dgraph.from_device(dbuild.build_graph(table), table)

    # warmup/compile
    rp = pather.path_readset(bg, rs)
    int(np.asarray(rp.path_len)[0])
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        rp = pather.path_readset(bg, rs)
        np.asarray(rp.path_len)  # forces device round trip
    dt = (time.perf_counter() - t0) / iters
    rps = n_reads / dt
    # slice off the shape-bucket padding rows (they can never place and
    # dilute the fraction; the pipeline slices [: rs.n_reads] the same way)
    placed = float((np.asarray(rp.path_len)[:n_reads] > 0).mean())
    return {
        "reads_aligned_per_s": round(rps, 1),
        "pather_vs_baseline": round(rps / REFERENCE_READS_PER_SEC, 3),
        "placed_frac": round(placed, 4),
    }


if __name__ == "__main__":
    main()
