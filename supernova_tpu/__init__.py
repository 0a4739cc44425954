"""supernova_tpu — a JAX/XLA linked-read de novo diploid
genome assembly framework with the capabilities of 10x Genomics Supernova.

Reference behavior blueprint: /root/repo/SURVEY.md (cites 10XGenomics/supernova).
This is a from-scratch re-architecture: sharded device arrays + collective
merges instead of the reference's Martian/C++/Rust stage pipeline.

Layering (bottom to top):
  core/      packed-base + ragged-array substrate (feudal/Basevector analogue)
  ops/       sorted-segment reductions, compaction, alignment DP
  ingest/    FASTQ -> barcode-corrected, barcode-sorted ReadSet (bci CSR index)
  kmer/      48-mer counting (MSP/SHARD_ASM/Kmerizer analogue)
  dbg/       de Bruijn graph build + unipath compaction (buildEdges/HBV analogue)
  align/     read-to-graph pathing + inverted indexes (pathReads analogue)
  asm/       patching, closures, supergraph, scaffolding, phasing (DF/TR/MC/CP)
  out/       FASTA emission (MakeFasta analogue)
  parallel/  device-mesh sharding: data-parallel reads, hash-sharded kmer space
  stats/     StatLogger/alarms analogue (summary.json schema)
  pipeline/  stage orchestration + a.* style checkpoints
  sim/       fixed-seed synthetic genomes + linked reads (sim_tests.rs analogue)
"""

__version__ = "0.1.0"

K = 48  # kmer size; reference: lib/tada/src/kmer/mod.rs:27 (enforced K=48)
