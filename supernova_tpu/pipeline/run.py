"""Pipeline orchestration: the _ASSEMBLER analogue with checkpoint re-entry.

Stage graph (reference: mro/_assembler.mro:27-95):
  ingest (BUCKET/SORT/ParseBarcodedFastqs) -> count (_ASM_SN) ->
  graph (DF build) -> paths (DF pathReads) -> fasta (MakeFasta raw)
with each stage writing an npz checkpoint into the out dir — the a.* file
contract (SURVEY.md §8) re-expressed; existing checkpoints are reused,
mirroring the reference's START=<stage> re-entry (DF.cc:147-155).
"""
from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path

import numpy as np

log = logging.getLogger("supernova_tpu")

from ..align import index as pindex
from ..align import pather
from ..core import kmer_codec as kc_codec
from ..dbg import build as dbuild
from ..dbg import graph as dgraph
from ..ingest.ingest import valid_barcode_fraction
from ..ingest.reads import ReadSet
from ..kmer import count as kcount
from ..out import fasta as fout
from ..stats.logger import StatLogger, n50

# Dictionary rows above which mesh pathing value-shards the kmer->(edge,pos)
# table across devices instead of replicating it (~28 B/row resident +
# lookup-sort temps; 64M rows ~ a 2 Gb genome's filtered dict — sized for a
# 16 GB device, not yet for the H100).  Addin:
# pipeline.run.PATH_VS_DICT_ROWS (tests force it low to exercise the path).
PATH_VS_DICT_ROWS = 64_000_000

# Flat base count above which the ReadSet re-homes onto disk memmaps
# (reads.lazy/) — the VirtualMasterVec analogue.  2 GB of codes+quals RAM is
# the break-even on this class of host.  Addin: pipeline.run.LAZY_READS_MIN_BASES.
LAZY_READS_MIN_BASES = 2_000_000_000


class Pipeline:
    def __init__(
        self,
        outdir: str | Path,
        stats: StatLogger | None = None,
        resume: bool = False,
        downsample: dict | None = None,
        auto_downsample: bool = True,
        multi_device: bool | None = None,
    ):
        """downsample: {"target_reads": N} or {"gigabases": G} — the
        reference's user downsampling knob (mro/assembler_cs.mro:12,
        df/__init__.py:91-119).  auto_downsample: when the kmer-spectrum
        coverage estimate exceeds the reference's >90x alarm threshold
        (alarms-supernova.json:5-15), subsample to the ideal 56x and
        recount (the reference only alarms; excess coverage lets error
        kmers past the frequency filter and shreds the graph)."""
        from ..core.jaxconfig import ensure_cache

        ensure_cache()
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.stats = stats or StatLogger.load(self.outdir / "all_stats.json")
        self.resume = resume
        self.downsample = downsample
        self.auto_downsample = auto_downsample
        # multi_device: None = auto (shard count+build over all local
        # devices on an accelerator; off on the CPU backend); True forces
        # the mesh path (tests use the
        # 8-virtual-device CPU mesh); False forces single-device; a
        # (hosts, chips_per_host) tuple selects the 2-D mesh with the
        # DCN-aware hierarchical count exchange.  Also settable via
        # SUPERNOVA_TPU_TOPOLOGY=HxC in the environment.
        if multi_device is None:
            topo = os.environ.get("SUPERNOVA_TPU_TOPOLOGY")
            if topo:
                h, c = topo.lower().split("x")
                multi_device = (int(h), int(c))
            else:
                # joined fleet (cli init_from_env / pod auto-init): the 2-D
                # mesh shape IS the fleet topology
                import jax

                if jax.process_count() > 1:
                    multi_device = (
                        jax.process_count(), jax.local_device_count()
                    )
        self.multi_device = multi_device
        self._shard_tables = None  # per-shard tables for the sharded build
        self._t_start = time.time()
        from .orchestrate import Orchestrator

        self.orch = Orchestrator(self.outdir)

    def _timed(self, name, fn, *a, **kw):
        """Per-stage wall-clock + peak-memory stats (etime_*/mem_peak_* schema,
        DF.cc:705-707) recorded through the orchestrator, which also keeps
        pipestance.json stage state (attempts/wall/status — the Martian
        runtime analogue, pipeline/orchestrate.py)."""
        from ..stats.trace import stage

        def body():
            with stage(name, self.stats):
                return fn(*a, **kw)

        return self.orch.run_stage(name, body)

    # ---------------------------------------------------------------- stages

    def stage_ingest(self, rs: ReadSet) -> ReadSet:
        # user downsampling (target_reads / gigabases)
        if self.downsample:
            from ..ingest.ingest import subsample_pairs

            frac = 1.0
            if self.downsample.get("target_reads"):
                frac = self.downsample["target_reads"] / max(rs.n_reads, 1)
            elif self.downsample.get("gigabases"):
                actual_gb = float(len(rs.codes)) / 1e9
                frac = self.downsample["gigabases"] / max(actual_gb, 1e-12)
            if frac < 1.0:
                rs = subsample_pairs(rs, frac)
                self.stats.log(
                    "downsample_frac", frac, "user downsample fraction",
                    stage="ingest",
                )
        ck = self.outdir / "reads.npz"
        if not ck.exists():
            rs.save(ck)
        # VirtualMasterVec analogue: above LAZY_READS_MIN_BASES, re-home the
        # flat base/qual stores onto disk memmaps so host RSS for the rest
        # of the run is bounded by the touched working set, not the read
        # total (feudal/VirtualMasterVec.h; RunStages.cc:323-327)
        if len(rs.codes) > LAZY_READS_MIN_BASES and not rs.is_lazy:
            lz = self.outdir / "reads.lazy"
            if not (lz / "codes.npy").exists():
                rs.save_lazy(lz)
            rs = ReadSet.load_lazy(lz)
            self.stats.log(
                "reads_lazy", 1, "bases/quals memmap-backed", stage="ingest"
            )
        self.stats.log("nreads", rs.n_reads, "number of reads", cs=True, stage="ingest")
        self.stats.log(
            "mean_read_len",
            float(np.mean(rs.lengths())) if rs.n_reads else 0.0,
            "mean input read length",
            cs=True,
            stage="ingest",
        )
        if rs.barcoded:
            self.stats.log(
                "valid_bc_perc",
                100.0 * valid_barcode_fraction(rs),
                "% reads with valid barcode",
                cs=True,
                stage="ingest",
            )
            rpb = np.diff(rs.bci)[1:]  # reads per real barcode
            self.stats.log("rpb_N50", n50(rpb[rpb > 0]), "N50 reads per barcode", cs=True)
            # huge-barcode fraction (SanityCheckBarcodeCounts,
            # DfTools.cc:595-614: barcodes with >= 50k reads)
            total_bc_reads = int(rpb.sum())
            if total_bc_reads:
                big = int(rpb[rpb >= 50_000].sum())
                self.stats.log(
                    "big_bc_perc", 100.0 * big / total_bc_reads,
                    "% reads in >=50k-read barcodes", stage="ingest",
                )
            # occupancy-based GEM count (EstimateGEMCount, DfTools.cc:550)
            from ..stats import gems as sgems

            n_gems = sgems.estimate_gem_count(rs.bci, rs.n_barcodes)
            if n_gems:
                self.stats.log(
                    "est_gem_count", n_gems,
                    "estimated GEM partitions (whitelist occupancy)",
                    stage="ingest",
                )
        # OOM-precursor check (alarms-supernova.json:17-22)
        from ..stats import gems as sgems2

        mpr = sgems2.mem_per_read_mb(rs.n_reads)
        if mpr is not None:
            self.stats.log(
                "mem_per_read", mpr,
                "MB of available memory per input read", stage="ingest",
            )
        # blockwise (the quals store may be a disk memmap; a full >=
        # comparison would materialize a read-total-sized temporary)
        nq = len(rs.quals)
        q30_n = sum(
            int((rs.quals[s : s + (1 << 26)] >= 30).sum())
            for s in range(0, nq, 1 << 26)
        )
        q30 = float(q30_n / nq * 100) if nq else 0.0
        self.stats.log("q30_r2_perc", q30, "Q30 bases %", stage="ingest")
        # bad-cycles check (DF.cc:364-424 qual-stat alerts / the
        # "quality <= 2 at fixed positions" alarm): per-cycle Q<=2 fraction
        if rs.n_reads:
            lens = rs.lengths()
            L = int(lens.min())
            if L > 0:
                if (lens == lens[0]).all():
                    # uniform reads: per-cycle view, no index matrix
                    qmat = rs.quals.reshape(rs.n_reads, L)
                else:
                    # ragged: sample reads (the alert needs a fraction, not
                    # an exact count; a 200k sample pins it to ~0.2%)
                    take = np.linspace(
                        0, rs.n_reads - 1, min(rs.n_reads, 200_000)
                    ).astype(np.int64)
                    starts = rs.offsets[:-1][take]
                    qmat = rs.quals[starts[:, None] + np.arange(L)[None, :]]
                bad_cycle_frac = float((qmat <= 2).mean(axis=0).max())
                self.stats.log(
                    "worst_cycle_q2_frac", 100.0 * bad_cycle_frac,
                    "worst per-cycle %% of bases with Q<=2", stage="ingest",
                )
        return rs

    def stage_count(self, rs: ReadSet):
        from ..stats import histograms as hist

        ck = self.outdir / "kmers.npz"
        if self.resume and ck.exists():
            # host-backed table: the downstream consumers either resume from
            # their own checkpoints (graph.npz) or are numpy (coverage
            # estimate), so an eager host->device put of a multi-100MB
            # table would be wasted; jnp ops lift np arrays lazily if the
            # graph stage does recompute
            z = np.load(ck)
            w = np.asarray(z["words"], dtype=np.uint32)
            return kcount.KmerTable(
                kc_codec.W3(w[:, 0], w[:, 1], w[:, 2]),
                z["count"],
                z["nbc"],
                z["left_mask"],
                z["right_mask"],
                np.int32(z["n_valid"]),
            )
        ndev = self._mesh_ndev()
        if ndev and int(rs.offsets[-1]) > kcount.BLOCK_POSITIONS:
            # per-device occurrence buffers would exceed device memory; the
            # blocked single-device path bounds it (sharded+blocked is future)
            log.info("count: readset exceeds device budget; using blocked path")
            ndev = 0
        if ndev:
            table = self._count_sharded(rs, ndev)
        else:
            # persistent block spills: an OOM-killed count resumes at block
            # granularity (the 100 Mb rung lost two ~75-min block phases)
            table = kcount.count_readset(
                rs, spill_dir=str(self.outdir / "count_spill")
            )
        table = dbuild.trim_table(table)
        n = int(table.n_valid)
        self.stats.log("kmers_distinct", n, "distinct filtered 48-mers", stage="count")
        spec = hist.kmer_spectrum(table)
        (self.outdir / "stats").mkdir(exist_ok=True)
        hist.write_hist_json(
            self.outdir / "stats" / "histogram_kmer_count.json",
            "48-mer multiplicity spectrum",
            spec["bins"],
            spec["counts"],
        )
        np.savez_compressed(
            self.outdir / "kmers.npz",
            words=kc_codec.soa_to_np(table.words),
            count=np.asarray(table.count),
            nbc=np.asarray(table.nbc),
            left_mask=np.asarray(table.left_mask),
            right_mask=np.asarray(table.right_mask),
            n_valid=np.int64(n),
        )
        # block spills are superseded by the checkpoint just written
        import shutil

        shutil.rmtree(self.outdir / "count_spill", ignore_errors=True)
        return table

    # lines at or above this are placed scaffolding citizens: fill content
    # owned by one of them duplicates sequence living elsewhere
    FILL_OWNER_LONG_LINE = 20_000

    def _fill_ownership(self, D, lines):
        """Ownership context for the fill gate (asm/fillcheck
        fill_owned_frac): the graph kmer dictionary's sorted word columns
        plus a per-dict-row flag marking kmers whose owning base edge
        lives in a LONG line.  A wrong-copy / skip-genome fill duplicates
        the interior of a long line placed elsewhere — which pair checks
        cannot see when the flanking repeat outspans the fragment length.
        Content of SHORT unjoined fragments stays fillable (it is often
        exactly the missing gap piece).  None when the dictionary is
        unavailable."""
        bg = D.bg
        kw = getattr(bg, "kmer_words", None)
        ne = getattr(bg, "node_edge", None)
        nk = int(getattr(bg, "n_kmers", 0) or 0)
        if kw is None or ne is None or nk == 0:
            return None
        kw = np.asarray(kw)[:nk]
        llens = lines.lengths(D)
        long_base = np.zeros(bg.n_edges, bool)
        for li, ln in enumerate(lines.lines):
            if llens[li] < self.FILL_OWNER_LONG_LINE:
                continue
            for d in ln.edges():
                row = np.asarray(D.epaths.row(int(d)), np.int64)
                if len(row) and row[0] >= 0:
                    long_base[row] = True
        long_base = long_base | long_base[np.asarray(bg.inv)]
        e_of_row = np.asarray(ne)[0::2][:nk]
        row_long = long_base[np.clip(e_of_row, 0, bg.n_edges - 1)]
        np_rows = np.asarray(bg.node_pos)[0::2][:nk]
        return {
            "words": (
                np.ascontiguousarray(kw[:, 0]),
                np.ascontiguousarray(kw[:, 1]),
                np.ascontiguousarray(kw[:, 2]),
            ),
            "row_long": row_long,
            "row_edge": e_of_row.astype(np.int64),
            "row_pos": np_rows.astype(np.int64),
            # copy-preference test (asm/fillcheck.copy_preference) fetches
            # the alternative copy's sequence lazily per fill
            "edge_seq": lambda e: bg.edges.row(int(e)),
        }

    def _glue_mesh(self):
        """Mesh for the supergraph closure glue in multi-device mode
        (parallel/sharded_nucleate.py), else None (host/device cores)."""
        ndev = self._mesh_ndev()
        if not ndev:
            return None
        from ..parallel.mesh import make_mesh

        return make_mesh(ndev)

    def _mesh_ndev(self) -> int:
        """Devices to shard count/build over (0 = single-device path)."""
        import jax

        n = len(jax.devices())
        if isinstance(self.multi_device, tuple):
            h, c = self.multi_device
            return h * c if (h * c > 1 and n >= h * c) else 0
        if self.multi_device is None:
            from ..core.jaxconfig import on_accelerator

            return n if (n > 1 and on_accelerator()) else 0
        return n if (self.multi_device and n > 1) else 0

    def _count_sharded(self, rs: ReadSet, ndev: int):
        """Mesh count: reads data-parallel, kmer space hash-sharded
        (parallel/sharded_count.py); keeps the per-shard tables for the
        distributed graph build.  Verified bit-identical to the
        single-device path (tests/test_sharded_{count,build}.py)."""
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded_count import (
            merge_shard_tables,
            sharded_count,
            split_readset,
        )

        codes, pr, glp, bcp, nbl, _rl, url = split_readset(rs, ndev)
        mesh = make_mesh(ndev)
        if isinstance(self.multi_device, tuple):
            # 2-D (host, chip) topology: hierarchical DCN-aware exchange;
            # shard tables land on the same devices host-major, so the
            # flat mesh keeps working for the distributed build
            from ..parallel.mesh import make_mesh2
            from ..parallel.sharded_count import sharded_count_hier

            h, c = self.multi_device
            tables, ovf = sharded_count_hier(
                make_mesh2(h, c), *map(np.asarray, (codes, pr, glp, bcp)),
                n_hosts=h, chips_per_host=c, capacity=4 * nbl,
                uniform_rl=url,
            )
        else:
            tables, ovf = sharded_count(
                mesh, *map(np.asarray, (codes, pr, glp, bcp)),
                n_dev=ndev, capacity=4 * nbl, uniform_rl=url,
            )
        if int(np.asarray(ovf).sum()) > 0:
            log.warning("sharded count overflow; single-device fallback")
            self._shard_tables = None
            return kcount.count_readset(rs)
        self._shard_tables = (mesh, tables, ndev)
        self.stats.log("n_shards", ndev, "count/build mesh devices", stage="count")
        merged = merge_shard_tables(tables)
        return kcount.recompute_adjacencies(dbuild.trim_table(merged))

    def _count_with_cov_guard(self, rs: ReadSet):
        """Count, estimate coverage from the spectrum, and (auto mode)
        downsample + recount past the >90x alarm.  -> (table, rs)."""
        table = self.stage_count(rs)
        from ..kmer.count import estimate_coverage

        rl = float(np.mean(rs.lengths())) if rs.n_reads else 150.0
        cov, gsize = estimate_coverage(table, rl)
        if cov:
            self.stats.log(
                "est_coverage", cov, "kmer-spectrum coverage estimate",
                cs=True, stage="count",
            )
            if gsize:
                self.stats.log(
                    "est_genome_size", gsize,
                    "kmer-spectrum genome size estimate", stage="count",
                )
            # scale gate: the estimate is only trustworthy with a real
            # spectrum (toy sims have too few distinct kmers)
            if self.auto_downsample and cov > 90.0 and int(table.n_valid) >= 50_000:
                from ..ingest.ingest import subsample_pairs

                frac = 56.0 / cov
                self.stats.log(
                    "downsample_frac_auto", frac,
                    "auto downsample to 56x (coverage alarm >90x)",
                    stage="count",
                )
                rs = subsample_pairs(rs, frac)
                (self.outdir / "kmers.npz").unlink(missing_ok=True)
                # free the full-coverage table (and any shard tables) BEFORE
                # the recount — holding them across a second blocked count
                # contributed to HBM exhaustion at the 10 Mb scale
                table = None
                self._shard_tables = None
                import gc

                gc.collect()
                table = self.stage_count(rs)
        return table, rs

    def stage_graph(self, table) -> dgraph.BaseGraph:
        ck = self.outdir / "graph.npz"
        if self.resume and ck.exists():
            return dgraph.BaseGraph.load(ck)
        if self._shard_tables is not None:
            # distributed unipath build over the hash-sharded tables
            # (adjacency + linking + list ranking as mesh collectives)
            from ..parallel.sharded_build import sharded_build_graph

            mesh, tables, ndev = self._shard_tables
            bg = sharded_build_graph(mesh, tables, ndev)
        else:
            dg = dbuild.build_graph(table)
            bg = dgraph.from_device(dg, table)
        bg.save(self.outdir / "graph.npz")
        lens = bg.edges.lengths()
        canonical = np.arange(bg.n_edges) <= bg.inv  # one per rc pair
        self.stats.log("n_edges", bg.n_edges, "unipath edges (fwd+rc)", stage="graph")
        self.stats.log(
            "edge_N50", n50(lens[canonical]), "unipath edge N50 (bases)", cs=True
        )
        self.stats.log("assembly_checksum", bg.checksum(), "graph checksum", stage="graph")
        return bg

    def _path_sharded(self, bg, rs, ndev: int):
        """Data-parallel pathing over the mesh (parallel/sharded_path.py);
        per-read results identical to the single-device pather.

        Dictionary layout: replicated per device below PATH_VS_DICT_ROWS
        (fast path — no exchange), hash-sharded by kmer above it (the
        pod-scale HBM story: no device holds the full table, lookups ride
        an all-to-all to the owner shard; reference analogue is the MSP
        shard contract, lib/tada/src/cmd_msp.rs:44-50)."""
        import jax.numpy as jnp

        from ..core.kmer_codec import K as KK
        from ..core.kmer_codec import np_to_soa
        from ..parallel.mesh import make_mesh
        from ..parallel.sharded_path import (
            shard_dictionary,
            sharded_path,
            sharded_path_vs,
            split_for_pathing,
        )

        mesh = make_mesh(ndev)
        codes, off, pr, rlen, nbl, rl, idx_blocks = split_for_pathing(
            rs, ndev
        )
        n_dict = int(np.asarray(bg.kmer_words).shape[0])
        value_shard = n_dict > PATH_VS_DICT_ROWS
        graph_args = (
            jnp.asarray(bg.from_v.astype(np.int32)),
            jnp.asarray(bg.to_v.astype(np.int32)),
            jnp.asarray((bg.edges.lengths() - (KK - 1)).astype(np.int32)),
        )
        read_args = (
            jnp.asarray(codes), jnp.asarray(off), jnp.asarray(pr),
            jnp.asarray(rlen),
        )
        if value_shard:
            words_sh, ne_sh, np_sh, L_sh = shard_dictionary(
                np_to_soa(bg.kmer_words), bg.node_edge, bg.node_pos, ndev
            )
            rp = sharded_path_vs(
                mesh, words_sh, jnp.asarray(ne_sh), jnp.asarray(np_sh),
                *graph_args, *read_args,
                n_dev=ndev, shard_rows=L_sh, capacity=2 * nbl,
            )
        else:
            rp = sharded_path(
                mesh,
                np_to_soa(bg.kmer_words),
                jnp.asarray(bg.node_edge),
                jnp.asarray(bg.node_pos),
                *graph_args, *read_args,
            )
        self.stats.log("n_shards_path", ndev, "pathing mesh devices", stage="paths")
        self.stats.log(
            "path_dict_sharded", int(value_shard),
            "1 = kmer dictionary value-sharded across the mesh",
            stage="paths",
        )

        def gather(col, width=None):
            a = np.asarray(col)
            a = a.reshape((ndev, rl) + a.shape[1:])
            return np.concatenate(
                [a[d][: len(idx_blocks[d])] for d in range(ndev)]
            )

        return pather.ReadPaths(
            jnp.asarray(gather(rp.edges)),
            jnp.asarray(gather(rp.path_len)),
            jnp.asarray(gather(rp.offset)),
            jnp.asarray(gather(rp.first_skip)),
            jnp.asarray(gather(rp.overflow)),
        )

    def stage_paths(self, bg, rs):
        ck = self.outdir / "paths.npz"
        if self.resume and ck.exists():
            import jax.numpy as jnp

            z = np.load(ck)
            plen_z = z["path_len"] if "path_len" in z else z["zip_plen"]
            same = len(plen_z) == rs.n_reads and (
                "n_edges" in z and int(z["n_edges"]) == bg.n_edges
            )
            if same:  # same reads AND same graph -> reuse
                if "edges" in z:  # legacy dense format
                    edges_z = z["edges"]
                else:  # ReadPathVecX-style zipped format (align/pathzip)
                    from ..align import pathzip

                    edges_z, plen_z, _ = pathzip.load_zipped(z, bg)
                rp = pather.ReadPaths(
                    jnp.asarray(edges_z),
                    jnp.asarray(plen_z),
                    jnp.asarray(z["offset"]),
                    jnp.zeros(rs.n_reads, jnp.int32),
                    jnp.zeros(rs.n_reads, bool),
                )
                counts = pindex.edge_read_counts(
                    edges_z, plen_z, bg.n_edges
                )
                ebcx = pindex.edge_barcodes(
                    edges_z, plen_z, rs.bc, bg.n_edges
                )
                np.savez_compressed(
                    self.outdir / "ebcx.npz",
                    values=ebcx.values, offsets=ebcx.offsets, counts=counts,
                )
                return rp
        ndev = self._mesh_ndev()
        if ndev and int(rs.offsets[-1]) > kcount.BLOCK_POSITIONS:
            ndev = 0  # device-memory guard: blocked single-device pathing
        if ndev:
            rp = self._path_sharded(bg, rs, ndev)
        else:
            rp = pather.path_readset(bg, rs)
        edges = np.asarray(rp.edges)[: rs.n_reads]
        plen = np.asarray(rp.path_len)[: rs.n_reads]
        offset = np.asarray(rp.offset)[: rs.n_reads]
        # qual-tolerant seed rescue for zero-hit reads (algorithmTwo's
        # qual-aware seeding; align/rescue.py)
        from ..align import rescue as arescue

        edges, plen, offset, n_resc = arescue.rescue_unplaced(
            bg, rs, edges, plen, offset
        )
        if n_resc:
            self.stats.log(
                "paths_rescued", n_resc,
                "zero-hit reads placed by low-qual substitution seeds",
                stage="paths",
            )
        # ExtendPathsNew: extend through unambiguous walks (Extend.cc:15)
        from ..asm import bads as abads

        edges, plen, offset, n_ext = abads.extend_paths(
            bg, rs, edges, plen, offset
        )
        if n_ext or n_resc:
            import jax.numpy as jnp

            rp = rp._replace(
                edges=jnp.asarray(edges), path_len=jnp.asarray(plen),
                offset=jnp.asarray(offset),
            )
            self.stats.log("paths_extended", n_ext, stage="paths")
        # zipped (ReadPathVecX-style) path checkpoint: first edge + branch
        # choices per read instead of the dense edge matrix
        from ..align import pathzip

        pathzip.save_zipped(
            self.outdir / "paths.npz", bg, edges, plen, offset,
            extra={"n_edges": np.int64(bg.n_edges)},
        )
        placed = float((plen > 0).mean()) if rs.n_reads else 0.0
        self.stats.log("placed_perc", placed * 100, "% reads pathed", stage="paths")
        counts = pindex.edge_read_counts(edges, plen, bg.n_edges)
        ebcx = pindex.edge_barcodes(edges, plen, rs.bc, bg.n_edges)
        np.savez_compressed(
            self.outdir / "ebcx.npz",
            values=ebcx.values,
            offsets=ebcx.offsets,
            counts=counts,
        )
        return rp

    def stage_patch(self, bg, rp, rs):
        """DF patch stage: dead-end pair discovery -> local closures ->
        graph rebuild + re-path (RunStages.cc StageFindPatch/InsertPatch)."""
        from ..asm import dups as adups
        from ..asm import patch as apatch

        import time as _time

        ck = self.outdir / "graph.patched.npz"
        if self.resume and ck.exists():
            # re-enter past patching: the patched graph + its paths.npz
            # (stage_paths resume validates reads/graph consistency)
            bg2 = dgraph.BaseGraph.load(ck)
            rp2 = self.stage_paths(bg2, rs)
            return bg2, rp2

        edges = np.asarray(rp.edges)[: rs.n_reads]
        plen = np.asarray(rp.path_len)[: rs.n_reads]
        offset = np.asarray(rp.offset)[: rs.n_reads]
        t0 = _time.time()
        dup = adups.mark_dups(edges, plen, offset, rs.bc)
        pairs = apatch.find_edge_pairs(bg, edges, plen, dup)
        t1 = _time.time()
        closures = apatch.close_gaps(bg, rs, pairs)
        t2 = _time.time()
        self.stats.log("gap_pairs", len(pairs), "dead-end edge pairs", stage="patch")
        self.stats.log("gap_closures", len(closures), "gaps closed", stage="patch")
        self.stats.log("etime_patch_find_s", t1 - t0,
                       "patch: pair discovery wall", stage="patch")
        self.stats.log("etime_patch_close_s", t2 - t1,
                       "patch: closure consensus wall", stage="patch")
        if not closures:
            return bg, rp
        np.savez_compressed(
            self.outdir / "closures.npz",
            values=np.concatenate(closures),
            offsets=np.concatenate(
                [[0], np.cumsum([len(c) for c in closures])]
            ).astype(np.int64),
        )
        bg2 = apatch.insert_patches(bg, closures)
        bg2.save(self.outdir / "graph.patched.npz")
        t3 = _time.time()
        self.stats.log("etime_patch_rebuild_s", t3 - t2,
                       "patch: graph rebuild wall", stage="patch")
        rp2 = self.stage_paths(bg2, rs)
        self.stats.log("etime_patch_repath_s", _time.time() - t3,
                       "patch: re-path wall", stage="patch")
        return bg2, rp2

    def _resume_supergraph(self, bg, rs, ck, dck):
        """START=supergraph re-entry: rebuild D/lines + the placement and
        molecule side state from supergraph.npz + dpaths.npz (the orig/a.sup
        snapshot semantics).  Returns (D, lines, dup) or None when the
        checkpoints do not match the current graph/reads."""
        from ..asm import lines as alines
        from ..asm.supergraph import SuperGraph
        from ..core.ragged import Ragged

        z = np.load(ck)
        dz = np.load(dck)
        ev = z["epaths_values"]
        if len(dz["dlen"]) != rs.n_reads or (
            ev.size and int(ev.max()) >= bg.n_edges
        ):
            return None  # different reads or graph: recompute
        from_v = z["from_v"]
        to_v = z["to_v"]
        nv = int(max(from_v.max(), to_v.max())) + 1 if len(from_v) else 0
        D = SuperGraph(
            epaths=Ragged(ev, z["epaths_offsets"]),
            dinv=z["dinv"],
            from_v=from_v,
            to_v=to_v,
            n_vertices=nv,
            bg=bg,
        )
        dpaths, dlen = dz["dpaths"], dz["dlen"]
        if dpaths.size and int(dpaths.max()) >= D.n_edges:
            return None  # dpaths.npz belongs to a different D: recompute
        lines = alines.find_lines(D)
        self._dpaths, self._dlen = dpaths, dlen
        cpk = self.outdir / "cpaths.npz"
        if cpk.exists():
            from ..asm.closures import load_closures

            self._closures = load_closures(cpk)  # Splat input (a.cpaths)
        if rs.barcoded:
            from ..asm import misassembly as amis
            from ..asm import molecules as amol
            from ..asm import supergraph as asg

            edges, plen, _off = self._base_paths
            ek = self.outdir / "ebcx.npz"
            ebcx = None
            if ek.exists():
                from ..core.ragged import Ragged as _R

                ze = np.load(ek)
                if len(ze["offsets"]) == bg.n_edges + 1:
                    ebcx = _R(ze["values"], ze["offsets"])
            if ebcx is None:
                ebcx = pindex.edge_barcodes(edges, plen, rs.bc, bg.n_edges)
            sup_bcs = asg.super_edge_barcodes(D, ebcx)
            pos0 = amol.read_line_positions(
                D, lines, dpaths, dlen, rs.bc, base_paths=self._base_paths
            )
            lines = amis.break_lines(lines, D, sup_bcs, line_positions=pos0)
            positions = amol.read_line_positions(
                D, lines, dpaths, dlen, rs.bc, base_paths=self._base_paths
            )
            self._molecules = amol.infer_molecules(positions)
            lp: dict = {}
            for (b, li), ps in positions.items():
                lp.setdefault(li, {})[b] = ps
            self._line_positions = lp
        log.info("supergraph: resumed from checkpoints")
        return D, lines, z["dup"]

    def stage_supergraph(self, bg, rp, rs):
        """TR/MC analogue: dup marking, weak-edge trimming, D build, lines."""
        from ..asm import dups as adups
        from ..asm import lines as alines
        from ..asm import supergraph as asg

        edges = np.asarray(rp.edges)[: rs.n_reads]
        plen = np.asarray(rp.path_len)[: rs.n_reads]
        offset = np.asarray(rp.offset)[: rs.n_reads]
        self._base_paths = (edges, plen, offset)  # for lbpx-resolution positions

        ck = self.outdir / "supergraph.npz"
        dck = self.outdir / "dpaths.npz"
        if self.resume and ck.exists() and dck.exists():
            got = self._resume_supergraph(bg, rs, ck, dck)
            if got is not None:
                return got
        dup = adups.mark_dups(edges, plen, offset, rs.bc)
        self.stats.log(
            "dup_frac", adups.dup_fraction(dup), "duplicate pair fraction",
            stage="supergraph",
        )
        med_ins, proper = adups.insert_size_stats(bg, edges, plen, offset)
        if med_ins is not None:
            self.stats.log(
                "median_ins_sz", med_ins, "median insert size", cs=True,
                stage="supergraph",
            )
            self.stats.log(
                "proper_pairs_perc", 100.0 * proper,
                "% placed pairs properly paired", cs=True, stage="supergraph",
            )
        counts = pindex.edge_read_counts(edges, plen, bg.n_edges)

        # closure paths first (a.cpaths analogue); bad pairs excluded like
        # dups (MakeClosures uses non-dup non-bad pairs, SecretOps.cc:1049)
        from ..asm import bads as abads
        from ..asm import closures as aclos

        bad = abads.mark_bads(bg, rs, edges, plen, offset)
        self.stats.log(
            "bad_read_frac", float(bad.mean()) if len(bad) else 0.0,
            "reads contradicting the assembly", stage="supergraph",
        )
        bad_pair = bad[0::2] | bad[1::2]
        cl = aclos.make_closures(bg, edges, plen, dup | bad_pair)
        aclos.save_closures(self.outdir / "cpaths.npz", cl)
        self._closures = cl  # a.cpaths analogue, consumed by Splat
        self.stats.log("n_closures", len(cl), "closure paths", stage="supergraph")

        keep = asg.trim_weak_edges(bg, counts)
        # TR trimming ahead of MC: closures riding Lawnmower-trimmed WEAK
        # FORK branches are error evidence — drop them (dead-end tips stay:
        # genuine sequence ends are tips too)
        keep_forks = asg.trim_weak_edges(bg, counts, tips=False)
        if cl and not keep_forks.all():
            n0 = len(cl)
            cl = [c for c in cl if bool(keep_forks[np.asarray(c, np.int64)].all())]
            if n0 != len(cl):
                self.stats.log(
                    "closures_trimmed", n0 - len(cl),
                    "closures dropped on trimmed edges", stage="supergraph",
                )
        if cl:
            # faithful MC construction: glue closures into D
            D = asg.closures_to_graph(bg, cl, mesh=self._glue_mesh())
            self.stats.log("supergraph_mode", "closures", stage="supergraph")
        else:
            D = asg.build_supergraph(bg, keep)
            # flatten lopsided (error-artifact) bubbles and rebuild once
            from ..asm import bubbles as abub

            support = asg.super_edge_support(D, counts)
            keep2, n_flat = abub.flatten_bubbles(bg, keep, D, support)
            if n_flat:
                keep = keep2
                D = asg.build_supergraph(bg, keep)
                self.stats.log(
                    "bubbles_flattened", n_flat, "weak bubble arms removed",
                    stage="supergraph",
                )
        D.validate()

        # Cleaner passes: hang trimming, weak bubble arms (3:0 rule),
        # inversion-bubble zapping, iterated to a fixpoint; then
        # KillInversionArtifacts (needs barcode support)
        from ..asm import clean as aclean
        from ..asm import inversion as ainv
        from ..asm import place as aplace

        rbc = rs.bc if rs.barcoded else None
        place_fn = lambda Dx: aplace.place_reads(Dx, edges, plen, read_bc=rbc)
        D, n_cleaned = aclean.clean_supergraph(D, place_fn)
        if n_cleaned:
            D.validate()
            self.stats.log(
                "super_edges_cleaned", n_cleaned,
                "D-edges removed by cleanup passes", stage="supergraph",
            )
        dpaths, dlen = place_fn(D)
        dels = ainv.kill_inversion_artifacts(D, dpaths, dlen, rbc)
        if dels:
            D = ainv.delete_edges(D, dels)
            D.validate()
            dpaths, dlen = place_fn(D)
            self.stats.log(
                "inversion_edges_deleted", len(dels),
                "inversion-artifact D-edges removed", stage="supergraph",
            )

        # PullApart (read-pair repeat separation) + Decycle
        from ..asm import pullapart as apull

        D2, n_pulls = apull.pull_apart(D, dpaths, dlen)
        if n_pulls:
            D = D2
            D.validate()
            dpaths, dlen = place_fn(D)
            self.stats.log("n_pullaparts", n_pulls, stage="supergraph")
        dc = apull.decycle(D, dpaths, dlen)
        if dc:
            D = ainv.delete_edges(D, dc)
            D.validate()
            dpaths, dlen = place_fn(D)
            self.stats.log("n_decycled", len(dc), stage="supergraph")

        # loop capture: abstract remaining loop subgraphs into {-4} cells so
        # lines run straight through them (CaptureLoops, 10X/Capture.cc;
        # the reference captures in CleanTheAssembly + the surgery stage)
        from ..asm import capture as acap

        D2, n_cap = acap.capture_loops(D)
        if n_cap:
            D = D2
            D.validate()
            dpaths, dlen = place_fn(D)
            self.stats.log(
                "n_loops_captured", n_cap,
                "loop subgraphs captured into cell gap edges",
                stage="supergraph",
            )
        D2m, n_messy = acap.capture_messy_loops(D)
        if n_messy:
            D = D2m
            D.validate()
            dpaths, dlen = place_fn(D)
            self.stats.log(
                "n_messy_loops_captured", n_messy,
                "tangles between long lines captured into cells",
                stage="supergraph",
            )

        lines = alines.find_lines(D)
        self.stats.log("n_super_edges", D.n_edges, stage="supergraph")
        self.stats.log("n_lines", lines.n_lines, stage="supergraph")

        # misassembly breaking: split lines at junctions with no spanning
        # barcodes (KillMisassembledCells analogue)
        if rs.barcoded:
            from ..asm import misassembly as amis
            from ..asm import molecules as amol0

            ebcx = pindex.edge_barcodes(edges, plen, rs.bc, bg.n_edges)
            sup_bcs = asg.super_edge_barcodes(D, ebcx)
            pos0 = amol0.read_line_positions(
                D, lines, dpaths, dlen, rs.bc, base_paths=self._base_paths
            )
            lines = amis.break_lines(lines, D, sup_bcs, line_positions=pos0)
            self.stats.log(
                "n_lines_after_break", lines.n_lines, stage="supergraph"
            )

        # dpaths already computed above (re-placed after any inversion cleanup)
        self._dpaths, self._dlen = dpaths, dlen
        np.savez_compressed(
            self.outdir / "dpaths.npz",
            dpaths=dpaths,
            dlen=dlen,
            counts=aplace.dpath_counts(D, dpaths, dlen),
        )

        # barcode molecules on lines (lbpx analogue)
        if rs.barcoded:
            from ..asm import molecules as amol

            positions = amol.read_line_positions(
                D, lines, dpaths, dlen, rs.bc, base_paths=self._base_paths
            )
            mols = amol.infer_molecules(positions)
            self._molecules = mols
            # line -> {bc: [positions]} for orientation-aware scaffolding
            lp: dict = {}
            for (b, li), ps in positions.items():
                lp.setdefault(li, {})[b] = ps
            self._line_positions = lp
            if mols:
                self.stats.log(
                    "lw_mean_mol_len",
                    amol.lw_mean_length(mols),
                    "length-weighted mean molecule length",
                    cs=True,
                )
                from ..stats import gems as sgems

                lm = sgems.estimate_loading_mass_ng(mols)
                if lm is not None:
                    self.stats.log(
                        "loading_mass", lm,
                        "estimated input DNA loading mass (ng)",
                    )
                from ..stats import histograms as hist

                h = hist.length_histogram(
                    np.array([m.length for m in mols]), bin_width=500
                )
                (self.outdir / "stats").mkdir(exist_ok=True)
                hist.write_hist_json(
                    self.outdir / "stats" / "histogram_molecules.json",
                    "inferred molecule lengths",
                    h["bins"],
                    h["counts"],
                )
        np.savez_compressed(
            self.outdir / "supergraph.npz",
            epaths_values=D.epaths.values,
            epaths_offsets=D.epaths.offsets,
            dinv=D.dinv,
            from_v=D.from_v,
            to_v=D.to_v,
            keep=keep,
            dup=dup,
        )
        return D, lines, dup

    def _star_multipass(self, D, lines, rs, ebcx, max_passes: int = 3):
        """Star's multi-pass loop over a gap-joined D (CP stages star /
        starstar / fix re-run Star after updating D — CP.cc:932,1309): each
        pass scores joins, inserts {-2, size} gap edges (Gaprika-sized from
        barcode molecules), and re-runs FindLines over the new D."""
        from collections import defaultdict

        from ..asm import lines as alines
        from ..asm import molecules as amol
        from ..asm import scaffold as asc
        from ..asm import star as astar
        from ..asm import supergraph as asg

        good = asc.good_barcodes(rs.bc)
        total = 0
        for _ in range(max_passes):
            llens, lbp, line_bcs, positions = self._line_evidence(
                D, lines, rs, ebcx, good
            )
            canon = list(range(lines.n_lines))
            lhood = astar.line_prox(line_bcs, canon)
            rdead = astar.right_dead_ends(lines, D)
            # calibrated admission floor: a join must look at least as
            # linked as a true 20 kb gap on THIS dataset's bridge curve
            # (raw bridge counts are same-GEM-noise-dominated on small
            # rungs; the Jaccard is scale-invariant — asm/gaprika.py)
            from ..asm import gaprika as agk

            lp_cal: dict = {}
            for (b, li), ps in positions.items():
                lp_cal.setdefault(li, {})[b] = ps
            # one window for calibration AND measurement: the floor is the
            # curve value at max_gap computed with window jwin, so the veto
            # must measure bridge_jaccard at the same view (ADVICE r4 #2 —
            # a 20 kb view vs a 10 kb-calibrated floor over-rejects joins)
            jwin = min(agk.WINDOW, astar.BRIDGE_VIEW)
            floor = agk.join_jaccard_floor(
                lp_cal, llens, D, lines, window=jwin
            )
            joins = astar.star_joins(
                canon, llens, lines.linv, lbp, lhood, rdead,
                jaccard_floor=floor, jaccard_view=jwin,
            )
            joins = astar.filter_joins(joins, lines.linv)
            if not joins:
                break
            by_bl = defaultdict(list)
            for m in amol.infer_molecules(positions):
                by_bl[(m.bc, m.line)].append(m)
            gap_sizes = {
                (L1, R): amol.estimate_gap(by_bl, L1, int(llens[L1]), R)
                for L1, R, _ in joins
            }
            D = astar.insert_star_gaps(D, lines, joins, gap_sizes)
            D.validate()
            lines = alines.find_lines(D)
            total += len(joins)
        return D, lines, total

    def _line_evidence(self, D, lines, rs, ebcx, good):
        """Per-line scaffolding evidence: lengths, end-restricted barcode
        positions (lbp), good-barcode sets, raw positions."""
        from ..asm import molecules as amol
        from ..asm import scaffold as asc
        from ..asm import star as astar
        from ..asm import supergraph as asg

        llens = lines.lengths(D)
        sup_bcs = asg.super_edge_barcodes(D, ebcx)
        line_bc_edges = []
        for ln in lines.lines:
            bcs = [sup_bcs[int(dd)] for dd in ln.edges()]
            line_bc_edges.append(
                np.unique(np.concatenate(bcs)) if bcs else np.zeros(0, np.int64)
            )
        line_bcs = asc.line_barcode_sets(lines, line_bc_edges, good)
        positions = amol.read_line_positions(
            D, lines, self._dpaths, self._dlen, rs.bc,
            base_paths=self._base_paths,
        )
        lbp_all = {li: [] for li in range(lines.n_lines)}
        for (bc, li), ps in positions.items():
            lbp_all[li].extend((bc, p) for p in ps)
        lbp = astar.restrict_positions(lbp_all, llens)
        return llens, lbp, line_bcs, positions

    def _barcode_join_passes(self, D, lines, rs, ebcx, max_passes: int = 3):
        """BarcodeJoin passes over D (the reference repeats BarcodeJoin
        through CleanTheAssembly, 10X/CleanThe.cc:2806-2929): find symmetric
        barcode-order links between long lines, splice them (gap edges or
        neighborhood duplication), re-find lines, iterate."""
        from ..asm import barcode_join as abj
        from ..asm import lines as alines
        from ..asm import scaffold as asc
        from ..asm import star as astar

        good = asc.good_barcodes(rs.bc)
        total = 0
        for _ in range(max_passes):
            llens, lbp, line_bcs, _pos = self._line_evidence(
                D, lines, rs, ebcx, good
            )
            canon = list(range(lines.n_lines))
            lhood = astar.line_prox(line_bcs, canon)
            cov = astar.line_coverage(llens, lbp)
            D2, n = abj.barcode_join(D, lines, llens, lbp, lhood, cov)
            if not n:
                break
            D = D2
            D.validate()
            lines = alines.find_lines(D)
            total += n
        return D, lines, total

    def _fix_misassemblies(self, D, lines, rs, edges, plen):
        """FixMisassemblies (Super.cc:259-304) at its CP.cc:902-923 call
        site between star and starstar: kill low-unique junk components,
        re-place reads, zap inversion bubbles, then kill misassembled
        cells at the base window tier.  Returns (D, lines).

        The reference also resplays here (Splay @ MIN_SPLAY2, CP.cc:908)
        because its next pass is Star, which reconnects with {-2} gap
        edges; our starstar analogue is BarcodeJoin, whose
        neighborhood-duplication splice turns freshly-severed line ends
        into cloned (duplicated) sequence in the output — so the resplay
        is intentionally omitted (measured: resplay+join inflated an 8 kb
        sim's pseudohap to 13.8 kb; without it, 8.2 kb at equal
        identity)."""
        from ..asm import clean as aclean
        from ..asm import misassembly as amis
        from ..asm import molecules as amol
        from ..asm.inversion import delete_edges as del_edges
        from ..asm.inversion import zap_inversion_bubbles

        n_sp = 0
        n_kill = 0
        # post-splay cleanup (CP.cc:910-916)
        dels = aclean.kill_low_unique(D)
        if dels:
            D = del_edges(D, dels)
            D.validate()
            lines = self._refresh_line_state(D, rs, edges, plen)
            n_kill += len(dels)
        # ZapInversionBubbles (Super.cc:283-285)
        zaps = zap_inversion_bubbles(D, lines)
        if zaps:
            D = del_edges(D, zaps)
            D.validate()
            lines = self._refresh_line_state(D, rs, edges, plen)
            n_kill += len(zaps)
        # fresh placements + positions, then the kill pass (Super.cc:295)
        if getattr(self, "_line_positions", None) is None or n_kill or n_sp:
            self._refresh_positions(D, lines, rs)
        lwml = (
            amol.lw_mean_length(self._molecules) if self._molecules else None
        )
        dels2 = amis.kill_misassembled_cells(
            D, lines, self._line_positions, lw_mol_len=lwml
        )
        if dels2:
            D = del_edges(D, dels2)
            D.validate()
            lines = self._refresh_line_state(D, rs, edges, plen)
            n_kill += len(dels2)
        if n_sp or n_kill:
            self.stats.log(
                "fix_misassemblies_edits", n_sp + n_kill,
                "resplays + edges deleted by FixMisassemblies",
                stage="scaffold",
            )
        return D, lines

    def _refresh_line_state(self, D, rs, edges, plen):
        """Recompute lines, placements, molecules and line positions after a
        supergraph edit (the repeated CP re-placement pattern)."""
        from ..asm import lines as alines
        from ..asm import place as aplace

        lines = alines.find_lines(D)
        self._dpaths, self._dlen = aplace.place_reads(
            D, edges, plen, read_bc=rs.bc if rs.barcoded else None,
            lines=lines,
        )
        if rs.barcoded:
            self._refresh_positions(D, lines, rs)
        return lines

    def _refresh_positions(self, D, lines, rs):
        from ..asm import molecules as amol

        positions = amol.read_line_positions(
            D, lines, self._dpaths, self._dlen, rs.bc,
            base_paths=self._base_paths,
        )
        self._molecules = amol.infer_molecules(positions)
        lp: dict = {}
        for (b, li), ps in positions.items():
            lp.setdefault(li, {})[b] = ps
        self._line_positions = lp

    def _save_sup_snapshot(self, name: str, D, extra: dict | None = None
                           ) -> None:
        """CP-phase supergraph snapshot ({star,patch,fase}/a.sup.npz — the
        reference's per-stage a.sup BasicWrite family, CP.cc:365-471)."""
        d = self.outdir / name
        d.mkdir(exist_ok=True)
        np.savez_compressed(
            d / "a.sup.npz",
            epaths_values=D.epaths.values,
            epaths_offsets=D.epaths.offsets,
            dinv=D.dinv,
            from_v=D.from_v,
            to_v=D.to_v,
            **(extra or {}),
        )

    def _load_sup_snapshot(self, bg, path, want_reads: int | None = None,
                           want_paths: bool = False):
        """Load a phase snapshot when it matches the current base graph
        (and, when recorded, the read count).  want_paths=True additionally
        returns the snapshot's placements -> (D, dpaths, dlen)."""
        if not path.exists():
            return None
        from ..asm.supergraph import SuperGraph
        from ..core.ragged import Ragged

        z = np.load(path)
        ev = z["epaths_values"]
        eo = z["epaths_offsets"]
        if ev.size:
            # sanity: base-edge ids in range — but only NON-gap rows: gap
            # rows ([-2, gap_len, ...]) embed lengths that can exceed
            # n_edges on small graphs
            lens = np.diff(eo)
            first = np.full(len(lens), -1, ev.dtype)
            ne = lens > 0
            first[ne] = ev[eo[:-1][ne]]
            real = np.repeat(first >= 0, lens)
            if real.any() and int(ev[real].max()) >= bg.n_edges:
                return None
        if "n_base_edges" in z and int(z["n_base_edges"]) != bg.n_edges:
            return None
        if want_reads is not None and (
            "n_reads" not in z or int(z["n_reads"]) != want_reads
        ):
            return None
        from_v, to_v = z["from_v"], z["to_v"]
        nv = int(max(from_v.max(), to_v.max())) + 1 if len(from_v) else 0
        D = SuperGraph(
            epaths=Ragged(ev, z["epaths_offsets"]),
            dinv=z["dinv"], from_v=from_v, to_v=to_v, n_vertices=nv, bg=bg,
        )
        if want_paths:
            if "dpaths" not in z:
                return None
            return D, z["dpaths"], z["dlen"]
        return D

    # Re-enterable phase sequence between pathing and phasing, snapshotted
    # after every phase (the reference's 16 START= re-entry points,
    # CP.cc:196-198, with a.sup writes at CP.cc:365-471).  --resume
    # restores the NEWEST matching snapshot and re-runs only later phases.
    SUP_PHASES = (
        "splay", "star", "fix", "starstar", "presize", "stackaroo",
        "unvoid", "void", "patch", "mis", "invfix", "canon", "gaprika",
        "audit", "fase",
    )

    def _scaffold_star_phases(self, D, lines, rs, edges, plen, ebcx):
        """Run the star-gap phase sequence with per-phase snapshots and
        START=-style re-entry.  Returns (D, lines), or None when star and
        barcode-join passes produced no joins (callers fall back to the
        legacy mutual-best scaffolder)."""
        from ..asm import capture as acap2
        from ..asm import clean as aclean
        from ..asm import lines as alines_s
        from ..asm import local as alocal
        from ..asm import misassembly as amis2
        from ..asm import molecules as amol
        from ..asm import scaffold as asc
        from ..asm import splat as aspl
        from ..asm import stackaroo as astk
        from ..asm.inversion import delete_edges as del_edges

        st = {"joins": 0}

        def _refresh(D):
            return self._refresh_line_state(D, rs, edges, plen)

        def ph_splay(D, lines):
            # Splay vertices at long-line ends before the barcode-evidence
            # joins (Splay, CP.cc:620): graph adjacency alone must not hold
            # long lines together across their end vertices
            n_sp = aclean.splay_line_ends(D, lines, lines.lengths(D))
            if n_sp:
                lines = alines_s.find_lines(D)
                self._refresh_positions(D, lines, rs)
                self.stats.log(
                    "splayed_vertices", n_sp,
                    "long-line end vertices splayed", stage="scaffold",
                )
            return D, lines

        def ph_star(D, lines):
            D, lines, n_joins = self._star_multipass(D, lines, rs, ebcx)
            st["joins"] += n_joins
            if n_joins:
                self.stats.log(
                    "star_gap_joins", n_joins,
                    "{-2} gap edges inserted by Star passes", stage="scaffold",
                )
            return D, lines

        def ph_fix(D, lines):
            # FixMisassemblies between star and starstar (CP.cc:902-923)
            return self._fix_misassemblies(D, lines, rs, edges, plen)

        def ph_starstar(D, lines):
            D, lines, n_bj = self._barcode_join_passes(D, lines, rs, ebcx)
            st["joins"] += n_bj
            if n_bj:
                self.stats.log(
                    "barcode_joins", n_bj,
                    "line joins made by BarcodeJoin passes", stage="scaffold",
                )
            return D, lines

        def ph_stackaroo(D, lines):
            # Stackaroo: upgrade bridgeable {-2} edges to {-3} sequence
            D, n_filled = astk.stackaroo_gaps(
                D, rs, self._dpaths, self._dlen,
                ownership=self._fill_ownership(D, lines),
            )
            if n_filled:
                D.validate()
                self.stats.log(
                    "gaps_filled_post", n_filled,
                    "gap edges upgraded to sequence by read stacks",
                    stage="scaffold",
                )
            return D, lines

        def ph_unvoid(D, lines):
            # Unvoid: barcode-restricted local assembly over the {-2} gaps
            # Stackaroo left open (BuildLocal.cc:1055, CP.cc:790)
            D2u, n_unvoid = alocal.unvoid(
                D, rs, ebcx, ownership=self._fill_ownership(D, lines)
            )
            if n_unvoid:
                D = D2u
                D.validate()
                lines = _refresh(D)
                self.stats.log(
                    "gaps_unvoided", n_unvoid,
                    "gaps closed by barcode-local assembly", stage="scaffold",
                )
            return D, lines

        def ph_void(D, lines):
            # Unvoid call site 1 (CP.cc:660-790): close voids at line
            # dead-ends toward barcode-neighborhood lines
            llens_u, _lbp_u, line_bcs_u, _pos_u = self._line_evidence(
                D, lines, rs, ebcx, asc.good_barcodes(rs.bc)
            )
            D2v, n_voids = alocal.unvoid_voids(
                D, rs, ebcx, lines, line_bcs_u, llens_u,
                ownership=self._fill_ownership(D, lines),
            )
            if n_voids:
                D = D2v
                D.validate()
                lines = _refresh(D)
                self.stats.log(
                    "voids_closed", n_voids,
                    "line dead-ends joined by barcode-local assembly",
                    stage="scaffold",
                )
            return D, lines

        def ph_patch(D, lines):
            # pair-linked {-2} gaps -> {-1}, then Splat the saved DF
            # closures across them (CP.cc:1233-1257 + Splat.cc)
            D2c, n_conv = aspl.convert_bc_gaps(D, self._dpaths, self._dlen)
            if n_conv:
                D = D2c
                D.validate()
                self.stats.log(
                    "pair_gaps_converted", n_conv,
                    "{-2} gaps with read-pair links -> {-1}",
                    stage="scaffold",
                )
            cl2 = getattr(self, "_closures", None)
            if cl2 and n_conv:
                D3, n_sp = aspl.splat(
                    D, [np.asarray(c, np.int64) for c in cl2]
                )
                if n_sp:
                    D = D3
                    D.validate()
                    lines = _refresh(D)
                    self.stats.log(
                        "gaps_splatted", n_sp,
                        "pair gaps replaced by closure sequence",
                        stage="scaffold",
                    )
            # line-keyed state moves to the merged lines
            self._refresh_positions(D, lines, rs)
            return D, lines

        def ph_mis(D, lines):
            # KillMisassembledCells escalation over the joined lines
            # (CP.cc:942-1106), then the position-free Alt variant
            # interior discontinuity scan FIRST (asm/fixint.py): the kill
            # tiers fragment lines near repeat joins, pushing the junction
            # into the scanner's end margins — scan while lines are long
            from ..asm import fixint as afix

            lpx = self._line_positions or {}
            if lpx:
                splits, gap_dels, detaches, finfo = afix.find_interior_breaks(
                    D, lines, lpx, lines.lengths(D)
                )
                log.info("fixint: %s", finfo)
                # Surgery order matters: split_edges/detach_edges preserve
                # existing edge IDs (they only append edges / adjust the
                # split pair's dinv), while del_edges COMPACTS and renumbers
                # D-edges — so all three lists, computed on one graph, stay
                # valid only if deletions run LAST.
                n_broken = 0
                if splits:
                    D = afix.split_edges(D, splits)
                    n_broken += len(splits)
                if detaches:
                    D = afix.detach_edges(D, detaches)
                    n_broken += len(detaches)
                if gap_dels:
                    dels_g = sorted(
                        {g for d in gap_dels for g in (d, int(D.dinv[d]))}
                    )
                    D = del_edges(D, dels_g)
                    n_broken += len(gap_dels)
                if n_broken:
                    D.validate()
                    lines = _refresh(D)
                    self.stats.log(
                        "interior_breaks", n_broken,
                        "breaks at calibrated bridge-fraction dips "
                        "(gap dels + edge splits + head detaches)",
                        stage="scaffold",
                    )
            lwml = (
                amol.lw_mean_length(self._molecules)
                if self._molecules else None
            )
            n_killed = 0
            for (req, flk, ign) in amis2.ESCALATION_TIERS:
                dels = amis2.kill_misassembled_cells(
                    D, lines, self._line_positions,
                    bc_require=req, bc_flank=flk, bc_ignore=ign,
                    lw_mol_len=lwml,
                )
                if not dels:
                    continue
                n_killed += len(dels)
                D = del_edges(D, dels)
                D.validate()
                lines = _refresh(D)
            dels_alt = amis2.kill_misassembled_cells_alt(D, lines, ebcx)
            if dels_alt:
                n_killed += len(dels_alt)
                D = del_edges(D, dels_alt)
                D.validate()
                lines = _refresh(D)
            if n_killed:
                self.stats.log(
                    "misassembled_cells_killed", n_killed,
                    "D-edges deleted at unsupported junctions",
                    stage="scaffold",
                )
            return D, lines

        def ph_invfix(D, lines):
            # InvFix (InvFix.cc, CP.cc:1403): flip interior segments
            # between barcode-only gap pairs that barcode windows call
            # inverted
            from ..asm import inversion as ainv2

            n_flips = ainv2.inv_fix(D, lines, self._line_positions or {})
            if n_flips:
                D.validate()
                lines = _refresh(D)
                self.stats.log(
                    "inversions_fixed", n_flips,
                    "line interiors flipped to their rc by InvFix",
                    stage="scaffold",
                )
            return D, lines

        def ph_canon(D, lines):
            # canon: flatten 3-4-path cells into parallel edges ahead of
            # phasing/output (CP.cc:1819-1860)
            D2c2, n_canon = acap2.canonicalize_cells(D, lines)
            if n_canon:
                D = D2c2
                D.validate()
                lines = _refresh(D)
                self.stats.log(
                    "cells_canonicalized", n_canon, stage="scaffold"
                )
            return D, lines

        def ph_gaprika(D, lines):
            # Gaprika (CP.cc:1578): re-size every {-2} barcode-only gap
            # from the bridge-fraction curve calibrated on the assembly's
            # own gap-free line stretches; joins whose linkage falls below
            # half the curve's max-gap value are misassembly suspects
            # (Gaprika.cc:225-229) and get BROKEN here — the barcode-set
            # discontinuity score at join points
            from ..asm import gaprika as agk

            # line ids must match the CURRENT lines (as the presize phase
            # this runs right after starstar's joins changed them)
            self._refresh_positions(D, lines, rs)
            for _ in range(2):  # second pass re-sizes after any breaks
                lp = self._line_positions or {}
                if not lp:
                    break
                D, n_sized, ginfo = agk.gaprika(D, lines, lp, lines.lengths(D))
                if n_sized:
                    D.validate()
                    self.stats.log(
                        "gaps_sized", n_sized,
                        "{-2} gaps re-sized by the calibrated bridge curve",
                        stage="scaffold",
                    )
                log.info(
                    "gaprika: %s",
                    {k: v for k, v in ginfo.items() if k != "curve"},
                )
                weak = ginfo.get("weak_edges") or []
                if not weak:
                    break
                dels = sorted(
                    {int(d) for d in weak} | {int(D.dinv[d]) for d in weak}
                )
                D = del_edges(D, dels)
                D.validate()
                lines = _refresh(D)
                self.stats.log(
                    "weak_gap_joins_broken", len(weak),
                    "{-2} joins deleted for sub-curve barcode linkage",
                    stage="scaffold",
                )
            return D, lines

        def ph_audit(D, lines):
            # final fill-content audit: every {-3} row (whatever created
            # it — stackaroo, unvoid closures, grafts, splat) must still
            # verify against the CURRENT placements; failures demote to
            # calibrated {-2} so the contested content prints as Ns
            # (asm/stackaroo.audit_seq_gaps)
            D2, n_dem = astk.audit_seq_gaps(
                D, rs, self._dpaths, self._dlen,
                ownership=self._fill_ownership(D, lines),
            )
            if n_dem:
                D = D2
                D.validate()
                lines = _refresh(D)
                self.stats.log(
                    "seq_gaps_demoted", n_dem,
                    "{-3} fills failing the final pair-content audit "
                    "-> calibrated {-2}", stage="scaffold",
                )
            return D, lines

        def ph_fase(D, lines):
            return D, lines  # terminal marker: snapshot only

        fns = {
            "splay": ph_splay, "star": ph_star, "fix": ph_fix,
            "starstar": ph_starstar, "presize": ph_gaprika,
            "stackaroo": ph_stackaroo,
            "unvoid": ph_unvoid, "void": ph_void, "patch": ph_patch,
            "mis": ph_mis, "invfix": ph_invfix, "canon": ph_canon,
            "gaprika": ph_gaprika, "audit": ph_audit, "fase": ph_fase,
        }

        start_idx = 0
        if self.resume:
            for i in range(len(self.SUP_PHASES) - 1, -1, -1):
                name = self.SUP_PHASES[i]
                path = self.outdir / name / "a.sup.npz"
                got = self._load_sup_snapshot(
                    D.bg, path, want_reads=rs.n_reads, want_paths=True
                )
                if got is None:
                    continue
                D, self._dpaths, self._dlen = got
                from ..asm import lines as alines_r

                lines = alines_r.find_lines(D)
                self._refresh_positions(D, lines, rs)
                zj = np.load(path)
                st["joins"] = int(zj["joins"]) if "joins" in zj else 1
                start_idx = i + 1
                log.info("scaffold: resumed from the %s snapshot", name)
                break

        for name in self.SUP_PHASES[start_idx:]:
            t0 = time.time()
            D, lines = fns[name](D, lines)
            log.info("scaffold phase %s: %.1fs", name, time.time() - t0)
            self._save_sup_snapshot(
                name, D,
                extra={
                    "n_reads": np.int64(rs.n_reads),
                    "n_base_edges": np.int64(D.bg.n_edges),
                    "dpaths": self._dpaths,
                    "dlen": self._dlen,
                    "joins": np.int64(st["joins"]),
                },
            )
            if os.environ.get("SN_STOP_AFTER_PHASE") == name:
                log.info("scaffold: SN_STOP_AFTER_PHASE=%s hit, exiting", name)
                raise SystemExit(0)
            if name == "starstar":
                if st["joins"] == 0:
                    return None  # no star evidence: legacy scaffolder
                self.stats.log("scaffold_mode", "star-gap", stage="scaffold")
        return D, lines

    def stage_scaffold_phase(self, D, lines, rp, rs):
        """CP analogue: barcode links -> scaffolds; Flipper -> phasing.
        Barcoded mode runs the reference construction: Star joins insert
        {-2} gap edges into D (multi-pass), Stackaroo upgrades bridgeable
        gaps to {-3} sequence edges, and scaffolds ARE the lines of the
        gap-joined D.  Returns (D, lines, scaffolds, phasings)."""
        from ..asm import phasing as aph
        from ..asm import scaffold as asc
        from ..asm import stackaroo as astk
        from ..asm import supergraph as asg

        edges = np.asarray(rp.edges)[: rs.n_reads]
        plen = np.asarray(rp.path_len)[: rs.n_reads]
        ebcx = pindex.edge_barcodes(edges, plen, rs.bc, D.bg.n_edges)
        lp = getattr(self, "_line_positions", None)
        scaffolds = None
        if rs.barcoded and lp:
            got = self._scaffold_star_phases(D, lines, rs, edges, plen, ebcx)
            if got is not None:
                from ..asm.lines import canonical_lines
                from ..asm.scaffold import Scaffold

                D, lines = got
                scaffolds = [
                    Scaffold([int(li)], []) for li in canonical_lines(lines)
                ]
        if scaffolds is None:
            # legacy path (unbarcoded or no star evidence): mutual-best
            # barcode-set scaffolding over line chains
            good = asc.good_barcodes(rs.bc)
            sup_bcs = asg.super_edge_barcodes(D, ebcx)
            line_bc_edges = []
            for ln in lines.lines:
                bcs = [sup_bcs[int(d)] for d in ln.edges()]
                line_bc_edges.append(
                    np.unique(np.concatenate(bcs)) if bcs else np.zeros(0, np.int64)
                )
            line_bcs = asc.line_barcode_sets(lines, line_bc_edges, good)
            line_lens = lines.lengths(D)
            scaffolds = asc.scaffold_lines(
                lines, line_bcs, line_lens, line_positions=lp,
            )
            # Gaprika-style gap estimates from barcode molecules
            mols = getattr(self, "_molecules", None)
            if mols:
                from collections import defaultdict

                from ..asm import molecules as amol

                by_bl = defaultdict(list)
                for m in mols:
                    by_bl[(m.bc, m.line)].append(m)
                for sc in scaffolds:
                    for i in range(len(sc.line_ids) - 1):
                        la, lb = sc.line_ids[i], sc.line_ids[i + 1]
                        sc.gaps[i] = max(
                            1,
                            amol.estimate_gap(by_bl, la, int(line_lens[la]), lb),
                        )
            # legacy Stackaroo over Scaffold gaps
            from ..out import pseudohap as oph

            line_seqs = {
                li: oph.line_sequence(D, lines.lines[li], {})
                for sc in scaffolds
                for li in sc.line_ids
            }
            n_filled = astk.stackaroo(
                D, lines, scaffolds, rs, self._dpaths, self._dlen, line_seqs,
                ownership=self._fill_ownership(D, lines),
            )
            if n_filled:
                self.stats.log(
                    "gaps_filled_post", n_filled,
                    "scaffold gaps closed by read stacks", stage="scaffold",
                )
        self.stats.log("n_scaffolds", len(scaffolds), stage="scaffold")

        # lines of lines: scaffold-level structure + N50 (FindLineLines,
        # 10X/LineLine.cc; the reference walks these in ScafLinePrinter)
        from ..asm.lines import find_line_lines, line_line_lengths

        ll = find_line_lines(D, lines)
        lens2 = line_line_lengths(lines.lengths(D), ll)
        canon2 = np.nonzero(np.arange(ll.n_lines) <= ll.linv)[0]
        self.stats.log("n_line_lines", len(canon2), stage="scaffold")
        if len(canon2):
            self.stats.log(
                "line_line_N50", n50(lens2[canon2]),
                "line-of-lines N50 (bases)", stage="scaffold",
            )

        if getattr(self, "_molecules", None):
            bc_counts = aph.build_edge_molecule_counts(
                D, lines, self._dpaths, self._dlen, rs.bc
            )
        else:
            bc_counts = aph.build_edge_bc_counts(
                D, self._dpaths, self._dlen, rs.bc
            )
        phasings = {}
        for sc in scaffolds:
            for li in sc.line_ids:
                phasings[li] = aph.phase_line(
                    lines.lines[li], bc_counts, dinv=D.dinv
                )

        from ..asm.het import estimate_hetdist

        hd = estimate_hetdist(D, lines)
        if hd is not None:
            self.stats.log(
                "hetdist_aligned", hd,
                "mean distance between het SNPs (arm alignment)", cs=True,
            )
        return D, lines, scaffolds, phasings

    def stage_fasta(self, bg, flavor: str = "raw", ctx=None) -> Path:
        from ..out import pseudohap as ph

        out = self.outdir / f"assembly.{flavor}.fasta.gz"
        if flavor == "raw":
            fout.write_raw_fasta(bg, out)
        elif flavor in ("megabubbles", "pseudohap", "pseudohap2", "efasta"):
            D, lines, scaffolds, phasings = ctx
            if flavor == "megabubbles":
                ph.write_megabubbles_fasta(D, lines, scaffolds, phasings, out)
            elif flavor == "pseudohap":
                ph.write_pseudohap_fasta(D, lines, scaffolds, phasings, out)
            elif flavor == "efasta":
                from ..out import efasta as oef

                out = self.outdir / "assembly.efasta.gz"
                oef.write_efasta(D, lines, scaffolds, phasings, out)
            else:
                ph.write_pseudohap2_fasta(D, lines, scaffolds, phasings, out)
        else:
            raise ValueError(f"unknown flavor {flavor}")
        return out

    # ------------------------------------------------------------------ run

    def run(self, rs: ReadSet, flavor: str = "raw"):
        rs = self.stage_ingest(rs)
        exits = self.stats.exit_alerts()
        if exits:
            self.finalize()
            raise RuntimeError(f"preflight exit alerts: {exits}")
        table, rs = self._count_with_cov_guard(rs)
        bg = self.stage_graph(table)
        self.stage_paths(bg, rs)
        path = self.stage_fasta(bg, flavor)
        self.finalize()
        return bg, path

    def run_full(self, rs: ReadSet, flavors=("raw", "megabubbles", "pseudohap", "pseudohap2")):
        """Full pipeline through supergraph, scaffolding, phasing, report."""
        from ..asm import dups as adups
        from ..asm import report as areport
        from ..out import pseudohap as ph

        rs = self.stage_ingest(rs)
        exits = self.stats.exit_alerts()
        if exits:
            self.finalize()
            raise RuntimeError(f"preflight exit alerts: {exits}")
        table, rs = self._timed("count", self._count_with_cov_guard, rs)
        bg = self._timed("graph", self.stage_graph, table)
        if self.resume and (self.outdir / "graph.patched.npz").exists():
            # re-enter past patching: pre-patch paths are superseded by the
            # patched graph's paths.npz (START=patch semantics)
            rp = None
        else:
            rp = self._timed("paths", self.stage_paths, bg, rs)
        bg, rp = self._timed("patch", self.stage_patch, bg, rp, rs)
        D, lines, dup = self._timed("supergraph", self.stage_supergraph, bg, rp, rs)
        D, lines, scaffolds, phasings = self._timed(
            "scaffold", self.stage_scaffold_phase, D, lines, rp, rs
        )

        outputs = {}
        ctx = (D, lines, scaffolds, phasings)
        for flavor in flavors:
            outputs[flavor] = self.stage_fasta(bg, flavor, ctx=ctx)

        # GFA graph exports (tada gfa / scaf-graph analogues)
        from ..out import gfa as ogfa

        ogfa.write_gfa(bg, self.outdir / "graph.gfa.gz")
        ogfa.write_gfa_super(D, self.outdir / "supergraph.gfa.gz")

        # final assembly state (the final/a.sup* family analogue): enough to
        # re-emit any FASTA flavor without recomputing (mkoutput)
        import pickle

        with open(self.outdir / "assembly_state.pkl", "wb") as f:
            pickle.dump(
                {"D": D, "lines": lines, "scaffolds": scaffolds,
                 "phasings": phasings}, f,
            )

        # final/a.sup* checkpoint family (SuperFiles, 10X/SuperFiles.cc:96)
        from ..out import superfiles as osf

        lbpx = None
        lp = getattr(self, "_line_positions", None)
        if lp:
            lbpx = [
                (li, bc, p)
                for li, bcs in lp.items()
                for bc, ps in bcs.items()
                for p in ps
            ]
        osf.write_super_files(
            self.outdir,
            D,
            lines,
            phasings=phasings,
            dpaths=getattr(self, "_dpaths", None),
            dlen=getattr(self, "_dlen", None),
            lbpx=lbpx,
        )

        scaffold_seqs = []
        for sc in scaffolds:
            parts = [
                ph.line_sequence(D, lines.lines[li], {}) for li in sc.line_ids
            ]
            scaffold_seqs.append(ph.join_parts(parts, sc))

        # histogram JSONs (CP.cc:1916-1922 analogues)
        from ..asm.report import contig_lengths_from_seq
        from ..stats import histograms as hist

        statsdir = self.outdir / "stats"
        statsdir.mkdir(exist_ok=True)
        contigs = [l for s in scaffold_seqs for l in contig_lengths_from_seq(s)]
        for name, lens in (
            ("contig", contigs),
            ("scaffold", [len(s) for s in scaffold_seqs]),
            ("edge", [D.edge_len(d) for d in range(D.n_edges)]),
        ):
            h = hist.length_histogram(lens)
            hist.write_hist_json(
                statsdir / f"histogram_{name}.json",
                f"{name} length histogram",
                h["bins"],
                h["counts"],
            )
        pb_lens = []
        from ..asm.phasing import phase_block_lengths

        for li, ph2 in phasings.items():
            pb_lens.extend(phase_block_lengths(D, lines.lines[li], ph2))
        h = hist.length_histogram(np.array(pb_lens or [0]))
        hist.write_hist_json(
            statsdir / "histogram_phase_block.json",
            "phase block lengths",
            h["bins"],
            h["counts"],
        )
        rb = hist.reads_per_barcode_histogram(rs)
        hist.write_hist_json(
            statsdir / "histogram_reads_per_barcode.json",
            "reads per barcode",
            rb["bins"],
            rb["counts"],
        )
        areport.report_assembly_stats(
            self.stats,
            D,
            lines,
            scaffolds,
            phasings,
            scaffold_seqs,
            adups.dup_fraction(dup),
            bg.checksum(),
        )
        self.finalize()
        return D, lines, scaffolds, phasings, outputs

    def finalize(self):
        self.stats.log(
            "etime_h", (time.time() - self._t_start) / 3600.0,
            "total elapsed hours", cs=True,
        )
        self.stats.dump_json(self.outdir / "all_stats.json")
        (self.outdir / "stats").mkdir(exist_ok=True)
        self.stats.dump_text(self.outdir / "stats" / "summary.txt")
        self.stats.dump_json(self.outdir / "summary.json", cs_only=True)
        self.stats.dump_csv(self.outdir / "summary_cs.csv")
        self.stats.dump_alerts(self.outdir / "alerts.json")
