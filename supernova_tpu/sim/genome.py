"""Fixed-seed synthetic diploid genomes + barcoded linked reads.

JAX-framework analogue of the reference's simulation test harness
(lib/tada/src/sim_tests.rs:73-140): random genomes with deliberately repeated
substructure, diploidized with SNPs, shredded into barcoded read pairs whose
barcode groups come from long molecules — the linked-read data model
(SURVEY.md intro).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..core import dna


def random_genome(
    rng: np.random.Generator,
    length: int,
    n_repeat_chunks: int = 0,
    repeat_len: int = 400,
) -> np.ndarray:
    """Random base codes with `n_repeat_chunks` repeated substrings pasted in
    (repeats are what make assembly non-trivial; sim_tests.rs:73-108)."""
    g = rng.integers(0, 4, size=length, dtype=np.uint8)
    for _ in range(n_repeat_chunks):
        src = int(rng.integers(0, length - repeat_len))
        dst = int(rng.integers(0, length - repeat_len))
        g[dst : dst + repeat_len] = g[src : src + repeat_len]
    return g


def diploidize(
    rng: np.random.Generator, hap_a: np.ndarray, het_rate: float = 0.001
) -> Tuple[np.ndarray, np.ndarray]:
    """Second haplotype = hap_a with SNPs at rate het_rate."""
    hap_b = hap_a.copy()
    n_snp = rng.binomial(len(hap_a), het_rate)
    pos = rng.choice(len(hap_a), size=n_snp, replace=False)
    shift = rng.integers(1, 4, size=n_snp, dtype=np.uint8)
    hap_b[pos] = (hap_b[pos] + shift) % 4
    return pos, hap_b


@dataclass
class SimReads:
    """Simulated barcoded paired reads, pre-ingestion (raw sequencer view)."""

    r1: List[np.ndarray] = field(default_factory=list)  # base codes
    q1: List[np.ndarray] = field(default_factory=list)  # qual scores (phred)
    r2: List[np.ndarray] = field(default_factory=list)
    q2: List[np.ndarray] = field(default_factory=list)
    barcode: List[np.ndarray] = field(default_factory=list)  # 16bp codes
    bc_qual: List[np.ndarray] = field(default_factory=list)
    # ground truth for tests
    truth_pos: List[int] = field(default_factory=list)
    truth_hap: List[int] = field(default_factory=list)

    def n_pairs(self) -> int:
        return len(self.r1)


def make_whitelist(rng: np.random.Generator, n: int) -> np.ndarray:
    """n distinct random 16bp barcodes, shape (n, 16) uint8 codes (sorted by
    packed value as the real 4M-with-alts whitelist is by string)."""
    seen = set()
    out = []
    while len(out) < n:
        bc = rng.integers(0, 4, size=16, dtype=np.uint8)
        key = bc.tobytes()
        if key not in seen:
            seen.add(key)
            out.append(bc)
    arr = np.stack(out)
    packed = pack_bc(arr)
    order = np.argsort(packed, kind="stable")
    return arr[order]


def pack_bc(bc_codes: np.ndarray) -> np.ndarray:
    """(N,16) base codes -> (N,) uint32 packed barcode (base-big-endian)."""
    bc_codes = np.asarray(bc_codes, dtype=np.uint32)
    out = np.zeros(bc_codes.shape[0], dtype=np.uint32)
    for i in range(16):
        out = (out << np.uint32(2)) | bc_codes[:, i]
    return out


def simulate_linked_reads(
    rng: np.random.Generator,
    haplotypes: Tuple[np.ndarray, np.ndarray],
    whitelist: np.ndarray,
    n_barcodes: int = 50,
    molecules_per_barcode: int = 3,
    molecule_len: int = 5000,
    read_len: int = 150,
    coverage_per_molecule: float = 0.3,
    insert_size: int = 350,
    error_rate: float = 0.0,
    bc_error_rate: float = 0.0,
    base_qual: int = 37,
    chromium_model: bool = False,
    min_molecule_len: int = 1_000,
) -> SimReads:
    """Shred long molecules (drawn from either haplotype) into read pairs
    sharing the molecule's barcode.  Deterministic for a fixed rng.

    With `chromium_model=True` the GEM statistics follow the reference's
    envelope (alarms-supernova.json:100-112; SURVEY.md §0): molecule count
    per barcode ~ Poisson(molecules_per_barcode) and molecule length ~
    Exponential(mean=molecule_len) clipped to [min_molecule_len, genome] —
    the sparse-sampling regime (0.1-0.3x per molecule, ~10 molecules/GEM,
    50-100 kb molecules) the real instrument produces.  Default (False)
    keeps fixed-length molecules for focused unit tests."""
    sim = SimReads()
    glen = len(haplotypes[0])
    bc_idx = rng.choice(len(whitelist), size=n_barcodes, replace=False)
    for b in bc_idx:
        bc = whitelist[b]
        n_mols = (
            max(1, int(rng.poisson(molecules_per_barcode)))
            if chromium_model else molecules_per_barcode
        )
        for _ in range(n_mols):
            hap = int(rng.integers(0, 2))
            g = haplotypes[hap]
            if chromium_model:
                mlen = int(rng.exponential(molecule_len))
                mlen = min(max(mlen, min_molecule_len), glen)
            else:
                mlen = min(molecule_len, glen)
            mstart = int(rng.integers(0, glen - mlen + 1))
            n_pairs = max(1, int(mlen * coverage_per_molecule / (2 * read_len)))
            for _ in range(n_pairs):
                fs = mstart + int(rng.integers(0, max(1, mlen - insert_size)))
                fe = min(fs + insert_size, glen)
                frag = g[fs:fe]
                if len(frag) < read_len + 10:
                    continue
                r1 = frag[:read_len].copy()
                r2 = dna.revcomp(frag[-read_len:]).copy()
                q1 = np.full(read_len, base_qual, dtype=np.uint8)
                q2 = np.full(read_len, base_qual, dtype=np.uint8)
                if error_rate > 0:
                    for r, q in ((r1, q1), (r2, q2)):
                        err = rng.random(read_len) < error_rate
                        r[err] = (r[err] + rng.integers(1, 4, err.sum())) % 4
                        q[err] = 11  # low qual at error sites (most errors)
                bc_read = bc.copy()
                bq = np.full(16, base_qual, dtype=np.uint8)
                if bc_error_rate > 0:
                    err = rng.random(16) < bc_error_rate
                    bc_read[err] = (bc_read[err] + rng.integers(1, 4, err.sum())) % 4
                    bq[err] = 11
                sim.r1.append(r1)
                sim.q1.append(q1)
                sim.r2.append(r2)
                sim.q2.append(q2)
                sim.barcode.append(bc_read)
                sim.bc_qual.append(bq)
                sim.truth_pos.append(fs)
                sim.truth_hap.append(hap)
    return sim
