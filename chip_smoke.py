#!/usr/bin/env python3
"""Smoke run of the assembler's main path on one NVIDIA GPU.

    python chip_smoke.py           # phases 1-5, one GPU
    python chip_smoke.py --four    # phase 6 alone, on a host with four GPUs

Everything runs in this one process, which owns the card; the only child
processes are nvidia-smi and a CPU-pinned assembler run that never opens
the card.  Any failed check raises, and the script exits non-zero.

  1. Device report: JAX devices, versions, the card's name and power limit,
     and whether the native host libraries built.  Anything but a GPU is
     refused.
  2. Kernels at real width, on a dataset cut from the 10 Mb rung
     (scripts/val10mb.sh: same genome, seed and per-barcode yield, 1/5 of
     its barcodes so one full count block exists): count_kmers on one
     96M-position count block, and the fused pather on one pather block
     against the graph that count builds.  Each runs again on the CPU
     device in this process and must agree exactly (the pipeline is
     integer).  Also: each program's memory_analysis() and the device peak,
     the device times of the count's occurrence sort, run statistics and
     compaction, and the partitioned host merge in forked workers.
  3. Backend identity: `simulate` and `run` at the end-to-end size on the
     GPU through supernova_tpu.cli.main, and the same `run` in a child
     pinned to the CPU backend; raw and pseudohap FASTA must be identical.
  4. End to end: `evaluate` of that GPU run: pseudohap anchored_frac
     >= 0.99 and mean_identity >= 0.9995, raw flavor mean_identity >= 0.9999
     and 0 misassemblies; per-stage walls and memory peaks.
  5. Card-only tests: pytest -m gpu (tests/test_gpu.py) in this process.
  6. (--four only) The mesh pipeline over four GPUs against a one-GPU run
     of the same 300 kb input: per-read paths bit-identical, raw and
     pseudohap FASTA identical.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"

# Phase 2: the 10 Mb rung's dataset (scripts/val10mb.sh), cut to the
# barcodes that fill one count block (~120 kb of reads per barcode).
RUNG_GENOME, RUNG_REPEATS, RUNG_WHITELIST, RUNG_SEED = 10_000_000, 200, 16_384, 11
BLOCK_BARCODES = 840
# Phases 3-4: the rung scaled to 1 Mb — repeats and barcodes per Mb as at
# 10 Mb.  The 10 Mb rung itself spends over an hour in host stages, beyond
# this script's time limit.  Phase 6 scales it to 300 kb (the size of the
# mesh identity test): still a mesh count (below BLOCK_POSITIONS), and two
# runs of it fit a four-GPU call.
E2E_GENOME, E2E_REPEATS, E2E_BARCODES = 1_000_000, 20, 400
FOUR_GENOME, FOUR_REPEATS, FOUR_BARCODES = 300_000, 6, 120
# Quality floors.  Pseudohap identity is held to 0.9995, not 0.9999: a
# pseudohaplotype is a phase mosaic at a 0.001 het rate, and every recorded
# eval of it (artifacts/val*/eval.json, 0.99973-0.99994) sits below 0.9999;
# the raw flavor is held to 0.9999.
MIN_ANCHORED, MIN_IDENTITY_PSEUDOHAP, MIN_IDENTITY_RAW = 0.99, 0.9995, 0.9999
# a forked host pool that gives up says so with one of these
FALLBACK_MARKS = ("fell back to serial", "device OOM")

log = logging.getLogger("chip_smoke")


class _Marks(logging.Handler):
    """Collects log records that mean a degraded run."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.hits: list[str] = []

    def emit(self, record):
        msg = record.getMessage()
        if any(m in msg for m in FALLBACK_MARKS):
            self.hits.append(msg)


MARKS = _Marks()


def say(*parts):
    print(*parts, flush=True)


def _check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def _no_fallbacks(phase: str):
    _check(not MARKS.hits, f"{phase}: degraded run: {MARKS.hits}")


# ---------------------------------------------------------------- phase 1

def card_line() -> str:
    """nvidia-smi's name and power limit for each card (a child that never
    imports JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def phase_device(n_expected: int):
    import jax
    import jaxlib

    from supernova_tpu import native
    from supernova_tpu.core import jaxconfig

    devs = jax.devices()
    say(f"[1] jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    say(f"[1] devices: {devs}")
    for d in devs:
        say(f"[1]   {d.id}: platform={d.platform} kind={d.device_kind}")
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, JAX found "
            f"{devs[0].platform} ({devs[0].device_kind})"
        )
    _check(len(devs) >= n_expected,
           f"need {n_expected} GPUs, JAX sees {len(devs)}")
    card = card_line()
    say(f"[1] card (name, power limit): {card}")
    errs = native.build_errors()
    say(f"[1] native fastq_decode: {'built' if 'fastq_decode' not in errs else 'FAILED'}, "
        f"nucleate_core: {'built' if 'nucleate_core' not in errs else 'FAILED'} {errs or ''}")
    jaxconfig.ensure_cache()
    say(f"[1] compile cache: {jaxconfig.cache_dir()}")
    return devs[0], card


# ---------------------------------------------------------------- phase 2

def _mem(compiled, dev) -> str:
    m = compiled.memory_analysis()
    peak = dev.memory_stats()["peak_bytes_in_use"]
    gib = 2**30
    return (
        f"args {m.argument_size_in_bytes / gib:.3f} GiB, "
        f"out {m.output_size_in_bytes / gib:.3f} GiB, "
        f"temp {m.temp_size_in_bytes / gib:.3f} GiB; "
        f"process device peak {peak / gib:.3f} GiB"
    )


def _timed(fn, *args, reps: int = 2):
    """-> (result, [seconds per call]); each call ends in block_until_ready."""
    import jax

    ts, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, ts


def _same(tag: str, a, b):
    import jax
    import numpy as np

    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    _check(len(la) == len(lb), f"{tag}: tree mismatch")
    for i, (x, y) in enumerate(zip(la, lb)):
        x, y = np.asarray(x), np.asarray(y)
        _check(x.shape == y.shape and x.dtype == y.dtype and
               np.array_equal(x, y), f"{tag}: leaf {i} differs GPU vs CPU")


def phase_kernels(dev, card: str):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from supernova_tpu.align import pather
    from supernova_tpu.cli import simulate_dataset
    from supernova_tpu.dbg import build as dbuild
    from supernova_tpu.dbg import graph as dgraph
    from supernova_tpu.ingest.ingest import ingest_sim
    from supernova_tpu.kmer import count as kcount
    from supernova_tpu.ops import segments as seg

    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    _, _, wl, reads = simulate_dataset(
        RUNG_GENOME, RUNG_REPEATS, BLOCK_BARCODES, RUNG_WHITELIST, RUNG_SEED
    )
    rs = ingest_sim(reads, wl)
    block = kcount.split_readset_blocks(rs, kcount.BLOCK_POSITIONS)[0]
    npos = int(block.offsets[-1])
    _check(npos > 0.9 * kcount.BLOCK_POSITIONS, f"block holds {npos} positions")
    say(f"[2] dataset: {rs.n_reads} reads; count block {block.n_reads} reads, "
        f"{npos} positions (host set-up {time.perf_counter() - t0:.1f} s)")

    # -- count_kmers at block width, GPU vs CPU
    inp = kcount.prepare_reads(block)
    rl = inp["uniform_rl"]
    args = tuple(inp[k] for k in ("codes_ext", "pos_read", "glen_pos", "bc_pos"))
    t0 = time.perf_counter()
    count_c = kcount.count_kmers.lower(*args, uniform_rl=rl).compile()
    say(f"[2] count_kmers compile {time.perf_counter() - t0:.1f} s; "
        f"{_mem(count_c, dev)}")
    tab, ts = _timed(count_c, *args)
    say(f"[2] count_kmers on {card}: {[round(t, 4) for t in ts]} s/call, "
        f"{int(tab.n_valid)} kmers kept")

    # -- where the count's device time goes: each part jitted alone
    occ = jax.jit(lambda *a: kcount.cut_occurrence_tails(
        rl, *kcount.extract_occurrences(*a)))(*args)
    srt, t_sort = _timed(jax.jit(kcount.sort_occurrences), *occ)
    st, t_stats = _timed(jax.jit(kcount.run_stats), *srt)
    ws, _ = srt
    ends, cnt, nbc, ign, lmk, rmk = st
    keep = ends & (cnt >= kcount.MIN_FREQ)
    _, t_comp = _timed(jax.jit(seg.stable_compact), keep, ws.a, ws.b, ws.c,
                       cnt, nbc, lmk, rmk)
    say(f"[2] count parts at {occ[0].a.shape[0]} rows on {card} (s per "
        f"call; the first compiles): "
        f"occurrence sort {t_sort}, run statistics {t_stats}, "
        f"compaction {t_comp}")
    del occ, srt, st, ws, ends, cnt, nbc, ign, lmk, rmk, keep

    # -- blocked-count twin: unfiltered block table -> partitioned host
    #    merge in forked workers; must equal the one-program count
    raw = kcount.count_block_raw(*args, uniform_rl=rl)
    nv = int(raw.n_valid)
    cols = [np.asarray(x)[:nv] for x in
            (raw.words.a, raw.words.b, raw.words.c, raw.count, raw.stats)]
    del raw
    merge_rows, kcount.MERGE_ROWS = kcount.MERGE_ROWS, 4_000_000
    try:
        t0 = time.perf_counter()
        merged = kcount._merge_blocks_partitioned(
            *([c] for c in cols), kcount.MIN_FREQ, kcount.MIN_BC
        )
    finally:
        kcount.MERGE_ROWS = merge_rows
    _no_fallbacks("phase 2 merge")
    k = int(tab.n_valid)
    ref = (tab.words.a, tab.words.b, tab.words.c, tab.count, tab.nbc,
           tab.left_mask, tab.right_mask)
    _same("partitioned merge", [np.asarray(x)[:k] for x in ref], merged)
    say(f"[2] partitioned host merge of {nv} raw rows in forked workers: "
        f"{time.perf_counter() - t0:.1f} s, equals count_kmers")
    del cols, merged, ref

    # the CPU reference count runs asynchronously beside the graph build
    # (dispatched after the forked merge, so no fork meets its threads)
    t_cpu = time.perf_counter()
    tab_cpu = kcount.count_kmers(*jax.device_put(args, cpu), uniform_rl=rl)
    del args

    # -- fused pather on one pather block against the block's graph
    t0 = time.perf_counter()
    table = kcount.recompute_adjacencies(dbuild.trim_table(tab))
    bg = dgraph.from_device(dbuild.build_graph(table), table)
    _same("count_kmers", tab, jax.block_until_ready(tab_cpu))
    say(f"[2] count_kmers GPU == CPU (exact); the CPU run was ready "
        f"{time.perf_counter() - t_cpu:.1f} s after its dispatch")
    del tab, table, tab_cpu
    pb = kcount.split_readset_blocks(
        block, pather._join_block_positions(bg, block))[0]
    pk = kcount.prepare_reads_packed(pb)
    say(f"[2] graph: {bg.n_edges} edges from {int(bg.kmer_words.shape[0])} "
        f"dictionary rows ({time.perf_counter() - t0:.1f} s); pather block "
        f"{pb.n_reads} reads, {pk['nbp']} positions")
    da = bg.device_arrays()
    dyn = (da["words"], da["node_edge"], da["node_pos"], da["from_v"],
           da["to_v"], da["edge_kmers"], jnp.asarray(pk["codes_packed"]),
           jnp.asarray(np.int32(pk["n_reads"])))
    static = dict(max_path=pather.MAX_PATH, uniform_rl=pk["uniform_rl"],
                  nbp=pk["nbp"], rp_pad=kcount._round_up(pb.n_reads + 1, 1024))
    t0 = time.perf_counter()
    path_c = pather.path_reads_packed.lower(*dyn, **static).compile()
    say(f"[2] pather compile {time.perf_counter() - t0:.1f} s; "
        f"{_mem(path_c, dev)}")
    rp, ts = _timed(path_c, *dyn)
    placed = float((np.asarray(rp.path_len)[: pb.n_reads] > 0).mean())
    say(f"[2] pather on {card}: {[round(t, 4) for t in ts]} s/call, "
        f"{pb.n_reads} reads, placed {placed:.4f}")
    t0 = time.perf_counter()
    rp_cpu = jax.block_until_ready(
        pather.path_reads_packed(*jax.device_put(dyn, cpu), **static))
    say(f"[2] pather on CPU: {time.perf_counter() - t0:.1f} s (compile included)")
    _same("pather", rp, rp_cpu)
    _check(placed > 0.9, f"pather placed only {placed:.4f} of reads")
    say("[2] pather GPU == CPU (exact)")


# ------------------------------------------------------------ phases 3, 4

def _cli(*argv) -> str:
    """supernova_tpu.cli.main in this process; -> its standard output."""
    from supernova_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    _check(rc == 0, f"supernova_tpu {argv[0]} exited {rc}")
    return buf.getvalue()


def _fasta(path: Path) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()


def phase_identity_and_e2e(card: str):
    sim_dir, gpu_dir, cpu_dir = WORK / "sim", WORK / "run_gpu", WORK / "run_cpu"
    t0 = time.perf_counter()
    _cli("simulate", "--out", sim_dir, "--genome-size", E2E_GENOME,
         "--repeats", E2E_REPEATS, "--barcodes", E2E_BARCODES,
         "--whitelist-size", RUNG_WHITELIST, "--seed", RUNG_SEED)
    say(f"[3] simulate {E2E_GENOME} bp, {E2E_BARCODES} barcodes: "
        f"{time.perf_counter() - t0:.1f} s")
    run = ["run", "--r1", sim_dir / "sample_R1.fastq.gz",
           "--r2", sim_dir / "sample_R2.fastq.gz",
           "--whitelist", sim_dir / "whitelist.txt",
           "--flavors", "raw,pseudohap"]
    # the CPU twin runs beside the GPU run; it never opens the card
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    cpu_log = open(WORK / "run_cpu.log", "w")
    t_cpu = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "supernova_tpu", *map(str, run),
         "--out", str(cpu_dir)],
        cwd=ROOT, env=env, stdout=cpu_log, stderr=subprocess.STDOUT,
    )
    try:
        t0 = time.perf_counter()
        _cli(*run, "--out", gpu_dir)
        wall = time.perf_counter() - t0
        say(f"[3] run on {card}: {wall:.1f} s")
        rc = child.wait(timeout=1800)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        cpu_log.close()
    if rc != 0:
        say((WORK / "run_cpu.log").read_text()[-3000:])
    _check(rc == 0, f"CPU-backend run exited {rc}")
    say(f"[3] run on the CPU backend (child): "
        f"{time.perf_counter() - t_cpu:.1f} s")
    for fl in ("raw", "pseudohap"):
        a = _fasta(gpu_dir / f"assembly.{fl}.fasta.gz")
        b = _fasta(cpu_dir / f"assembly.{fl}.fasta.gz")
        _check(a == b, f"{fl} FASTA differs GPU vs CPU")
        say(f"[3] {fl} FASTA identical GPU vs CPU ({len(a)} bytes)")
    _no_fallbacks("phase 3")

    # -- phase 4: evaluate the GPU run
    truth = (sim_dir / "truth_hap_a.npy", sim_dir / "truth_hap_b.npy")
    ev = json.loads(_cli("evaluate", "--fasta",
                         gpu_dir / "assembly.pseudohap.fasta.gz",
                         "--truth", *truth))
    ev_raw = json.loads(_cli("evaluate", "--fasta",
                             gpu_dir / "assembly.raw.fasta.gz",
                             "--truth", *truth))
    _no_fallbacks("phase 4 evaluate")
    say(f"[4] pseudohap: anchored_frac {ev['anchored_frac']}, mean_identity "
        f"{ev['mean_identity']}, misassemblies {ev['misassemblies']}, "
        f"n_contigs {ev['n_contigs']}; raw mean_identity "
        f"{ev_raw['mean_identity']}, misassemblies {ev_raw['misassemblies']}")
    _check(ev["anchored_frac"] >= MIN_ANCHORED, "pseudohap anchored_frac")
    _check(ev["mean_identity"] >= MIN_IDENTITY_PSEUDOHAP,
           "pseudohap mean_identity")
    _check(ev_raw["mean_identity"] >= MIN_IDENTITY_RAW, "raw mean_identity")
    _check(ev_raw["misassemblies"] == 0, "raw flavor misassemblies")
    stats = json.loads((gpu_dir / "all_stats.json").read_text())
    say(f"[4] per-stage wall (s) and process peaks (GiB) on {card}:")
    for k, v in stats.items():
        if k.startswith("etime_") and k.endswith("_h") and k != "etime_h":
            st = k[len("etime_"):-2]
            say(f"[4]   {st:<12} {v * 3600:9.2f} s  device "
                f"{stats.get(f'mem_peak_{st}_gb')}  host "
                f"{stats.get(f'mem_peak_host_{st}_gb')}")


# ---------------------------------------------------------------- phase 5

class _Tally:
    def __init__(self):
        self.passed, self.failed, self.skipped = 0, 0, 0

    def pytest_runtest_logreport(self, report):
        if report.skipped:
            self.skipped += 1
        elif report.failed:
            self.failed += 1
        elif report.when == "call":
            self.passed += 1


def phase_gpu_tests():
    import pytest

    os.environ["SUPERNOVA_GPU_TESTS"] = "1"
    tally = _Tally()
    rc = pytest.main(
        ["-q", "-p", "no:cacheprovider", "-o", "addopts=", "-m", "gpu",
         str(ROOT / "tests" / "test_gpu.py")],
        plugins=[tally],
    )
    say(f"[5] pytest -m gpu: {tally.passed} passed, {tally.failed} failed, "
        f"{tally.skipped} skipped (rc {rc})")
    _check(rc == 0 and tally.failed == 0 and tally.skipped == 0
           and tally.passed > 0, "card-only tests")


# ---------------------------------------------------------------- phase 6

def phase_four(card: str):
    import numpy as np

    from supernova_tpu.asm import supergraph
    from supernova_tpu.cli import simulate_dataset
    from supernova_tpu.core.jaxconfig import on_accelerator
    from supernova_tpu.ingest.ingest import ingest_sim
    from supernova_tpu.pipeline.run import Pipeline

    _, _, wl, reads = simulate_dataset(
        FOUR_GENOME, FOUR_REPEATS, FOUR_BARCODES, RUNG_WHITELIST, RUNG_SEED
    )
    rs = ingest_sim(reads, wl)
    supergraph.PARANOID = False
    say(f"[6] mesh exchanges: "
        f"{'ragged_all_to_all' if on_accelerator() else 'padded all_to_all'}")
    for tag, md in (("mesh", True), ("single", False)):
        t0 = time.perf_counter()
        p = Pipeline(WORK / tag, multi_device=md)
        _check(bool(p._mesh_ndev()) == md, f"{tag}: mesh choice")
        p.run_full(rs, flavors=("raw", "pseudohap"))
        say(f"[6] {FOUR_GENOME} bp, {tag} ({p._mesh_ndev() or 1} GPU) on "
            f"{card}: {time.perf_counter() - t0:.1f} s")
    z1 = np.load(WORK / "single" / "paths.npz")
    z2 = np.load(WORK / "mesh" / "paths.npz")
    _check(sorted(z1.files) == sorted(z2.files), "paths.npz fields")
    for f in z1.files:
        _check(np.array_equal(z1[f], z2[f]), f"paths.npz {f} differs")
    say(f"[6] pathing bit-identical ({', '.join(sorted(z1.files))})")
    for fl in ("raw", "pseudohap"):
        a = _fasta(WORK / "single" / f"assembly.{fl}.fasta.gz")
        b = _fasta(WORK / "mesh" / f"assembly.{fl}.fasta.gz")
        _check(a == b, f"{fl} FASTA differs one GPU vs mesh")
        say(f"[6] {fl} FASTA identical one GPU vs mesh ({len(a)} bytes)")
    _no_fallbacks("phase 6")


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    if not (ROOT / "supernova_tpu" / "__init__.py").exists():
        print("chip_smoke: the supernova_tpu package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # phase 2 compares with the CPU device in this process: keep the CPU
    # platform available beside the GPU when JAX_PLATFORMS names one
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    logging.getLogger().addHandler(MARKS)
    t_start = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)

    n = 4 if args.four else 1
    dev, card = phase_device(n)
    if args.four:
        phase_four(card)
    else:
        t0 = time.perf_counter()
        phase_kernels(dev, card)
        say(f"[2] phase wall {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_identity_and_e2e(card)
        say(f"[3-4] phase wall {time.perf_counter() - t0:.1f} s")
        phase_gpu_tests()
    import jax

    shutil.rmtree(WORK, ignore_errors=True)
    say(f"total wall {time.perf_counter() - t_start:.1f} s; card {card}")
    say(ok_line(dev.platform, dev.device_kind, len(jax.devices())))
    return 0


def ok_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind,
                                "count": count}}
    )


if __name__ == "__main__":
    sys.exit(main())
