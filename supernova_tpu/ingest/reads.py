"""ReadSet: the ingested, barcode-sorted read store.

Device-friendly analogue of the reference's fastb/qualp/bci file triple
(10X/ParseBarcodedFastqs.cc:174-234): flat base codes + CSR offsets replace
feudal vecbvec, flat quals replace VecPQVec, and `bci` is the same CSR
barcode index: bci[b] = first read of barcode b, with barcode 0 = the
unbarcoded block (bci[1] = end of unbarcoded block; DF.cc:858).

Reads are stored as consecutive pairs (2i, 2i+1 = mates), preserved by the
barcode sort — same invariant as the reference's barcode-sorted FASTH.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.ragged import lengths_to_offsets


@dataclass
class ReadSet:
    codes: np.ndarray  # flat uint8 base codes
    offsets: np.ndarray  # int64 (n_reads+1,)
    quals: np.ndarray  # flat uint8 phred scores, same offsets
    bc: np.ndarray  # int32 (n_reads,) barcode id; 0 = unbarcoded/invalid
    bci: np.ndarray  # int64 (n_barcodes+2,) read-range CSR per barcode id
    barcoded: bool = True  # False => dataset has no barcodes (bc all 0)

    @property
    def n_reads(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_pairs(self) -> int:
        return self.n_reads // 2

    @property
    def n_barcodes(self) -> int:
        return len(self.bci) - 2

    def read(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i] : self.offsets[i + 1]]

    def qual(self, i: int) -> np.ndarray:
        return self.quals[self.offsets[i] : self.offsets[i + 1]]

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def barcode_reads(self, b: int) -> range:
        return range(int(self.bci[b]), int(self.bci[b + 1]))

    def validate(self):
        assert self.offsets[0] == 0 and self.offsets[-1] == len(self.codes)
        assert len(self.quals) == len(self.codes)
        assert len(self.bc) == self.n_reads
        assert self.n_reads % 2 == 0, "reads must be paired"
        # barcode-sorted invariant
        assert np.all(np.diff(self.bc) >= 0), "reads must be barcode-sorted"
        assert self.bci[0] == 0 and self.bci[-1] == self.n_reads

    def save(self, path: str | Path, pack_quals: bool = True):
        """Checkpoint (fastb/qualp/bci analogue).  Quals store PQVec-style
        by default: a 4-entry codebook + 2-bit codes (core/pqvec.py); bases
        store 2-bit packed (fastb analogue).  Uncompressed npz: the packed
        payload is near-incompressible and single-threaded deflate costs
        minutes at 10^9-base scale."""
        from .feudal import pack_codes

        extra = {}
        if pack_quals:
            from ..core import pqvec

            book = pqvec.build_codebook(self.quals)
            extra = {
                "qualp": pqvec.pack(self.quals, book),
                "qual_book": book,
                "n_quals": np.int64(len(self.quals)),
            }
        else:
            extra = {"quals": self.quals}
        np.savez(
            path,
            codesp=pack_codes(self.codes),
            n_codes=np.int64(len(self.codes)),
            offsets=self.offsets,
            bc=self.bc,
            bci=self.bci,
            barcoded=np.array(self.barcoded),
            **extra,
        )

    def save_lazy(self, d: str | Path, block: int = 1 << 26) -> Path:
        """Write the flat stores as raw .npy files for memmap access — the
        VirtualMasterVec analogue (feudal/VirtualMasterVec.h, used
        RunStages.cc:323-327, CP.cc:1279-1283): bases/quals become
        file-backed pages the OS caches and evicts on demand, so host RSS
        stays bounded by the working set instead of the read total.  Copies
        block-wise (bounded RAM even when self.codes is itself lazy)."""
        d = Path(d)
        d.mkdir(parents=True, exist_ok=True)
        for name, src in (("codes", self.codes), ("quals", self.quals)):
            mm = np.lib.format.open_memmap(
                d / f"{name}.npy", mode="w+", dtype=np.uint8,
                shape=(len(src),),
            )
            for s in range(0, len(src), block):
                mm[s : s + block] = src[s : s + block]
            mm.flush()
            del mm
        np.save(d / "offsets.npy", self.offsets)
        np.save(d / "bc.npy", self.bc)
        np.save(d / "bci.npy", self.bci)
        np.save(d / "barcoded.npy", np.array(self.barcoded))
        return d

    @staticmethod
    def load_lazy(d: str | Path) -> "ReadSet":
        """Memmap-backed ReadSet: codes/quals are read-only file views
        (page-cache resident only where touched); the small CSR/barcode
        arrays load into RAM."""
        d = Path(d)
        rs = ReadSet(
            codes=np.load(d / "codes.npy", mmap_mode="r"),
            offsets=np.load(d / "offsets.npy"),
            quals=np.load(d / "quals.npy", mmap_mode="r"),
            bc=np.load(d / "bc.npy"),
            bci=np.load(d / "bci.npy"),
            barcoded=bool(np.load(d / "barcoded.npy")),
        )
        rs.validate()
        return rs

    @property
    def is_lazy(self) -> bool:
        return isinstance(self.codes, np.memmap)

    @staticmethod
    def load(path: str | Path) -> "ReadSet":
        z = np.load(path)
        if "qualp" in z:
            from ..core import pqvec

            quals = pqvec.unpack(z["qualp"], int(z["n_quals"]), z["qual_book"])
        else:
            quals = z["quals"]
        if "codesp" in z:
            from .feudal import unpack_codes

            codes = unpack_codes(z["codesp"], int(z["n_codes"]))
        else:  # pre-packing checkpoints
            codes = z["codes"]
        return ReadSet(
            codes=codes,
            offsets=z["offsets"],
            quals=quals,
            bc=z["bc"],
            bci=z["bci"],
            barcoded=bool(z["barcoded"]),
        )


def build_readset(
    reads: list[np.ndarray],
    quals: list[np.ndarray],
    bc_ids: np.ndarray,
    n_barcodes: Optional[int] = None,
    barcoded: bool = True,
) -> ReadSet:
    """Assemble + barcode-sort a ReadSet from per-read arrays.

    bc_ids is per-READ-PAIR or per-read (len == n_reads): barcode id, 0 for
    invalid.  The stable sort keys on (bc, original pair index), keeping
    mates adjacent — the reference's bucket/sort-fastq contract
    (lib/tada/src/cmd_sort_fastq.rs:354-470).
    """
    n_reads = len(reads)
    assert n_reads % 2 == 0
    bc_ids = np.asarray(bc_ids, dtype=np.int32)
    if len(bc_ids) == n_reads // 2:  # per-pair -> per-read
        bc_ids = np.repeat(bc_ids, 2)
    assert len(bc_ids) == n_reads

    pair_ids = np.arange(n_reads, dtype=np.int64) // 2
    order = np.lexsort((np.arange(n_reads), pair_ids, bc_ids))
    reads = [reads[i] for i in order]
    quals = [quals[i] for i in order]
    bc_sorted = bc_ids[order]

    lens = np.array([len(r) for r in reads], dtype=np.int64)
    offsets = lengths_to_offsets(lens)
    codes = (
        np.concatenate(reads).astype(np.uint8) if reads else np.zeros(0, np.uint8)
    )
    qvals = (
        np.concatenate(quals).astype(np.uint8) if quals else np.zeros(0, np.uint8)
    )

    if n_barcodes is None:
        n_barcodes = int(bc_sorted.max()) if n_reads else 0
    # bci[b] = first read with barcode id b (searchsorted on the sorted bc col)
    bci = np.searchsorted(bc_sorted, np.arange(n_barcodes + 2), side="left").astype(
        np.int64
    )
    rs = ReadSet(codes, offsets, qvals, bc_sorted, bci, barcoded)
    rs.validate()
    return rs


def build_readset_flat(
    codes: np.ndarray,
    offsets: np.ndarray,
    quals: np.ndarray,
    bc_ids: np.ndarray,
    n_barcodes: Optional[int] = None,
    barcoded: bool = True,
) -> ReadSet:
    """build_readset over FLAT storage (codes/quals + CSR offsets) — no
    per-read Python objects; the barcode sort permutes the flat arrays with
    one vectorized gather.  Identical output to build_readset."""
    n_reads = len(offsets) - 1
    assert n_reads % 2 == 0
    bc_ids = np.asarray(bc_ids, dtype=np.int32)
    if len(bc_ids) == n_reads // 2:
        bc_ids = np.repeat(bc_ids, 2)
    assert len(bc_ids) == n_reads

    pair_ids = np.arange(n_reads, dtype=np.int64) // 2
    order = np.lexsort((np.arange(n_reads), pair_ids, bc_ids))
    lens = np.diff(offsets)
    out_lens = lens[order]
    out_offsets = lengths_to_offsets(out_lens)
    total = int(out_offsets[-1])
    # permute the flat base/qual stores read-by-read in bounded chunks:
    # a whole-array gather index is int64 PER BASE (9.6 Gbases at the
    # 100 Mb scale -> 2 x 77 GB just for indices, OOM); chunking keeps the
    # transient index memory ~2 GB while writing into the preallocated
    # outputs
    codes = np.asarray(codes, np.uint8)
    quals = np.asarray(quals, np.uint8)
    codes_s = np.empty(total, np.uint8)
    quals_s = np.empty(total, np.uint8)
    src_starts = offsets[:-1][order]
    chunk = 1 << 20  # reads per chunk (~300 MB of index at 300 b/read)
    for r0 in range(0, n_reads, chunk):
        r1 = min(r0 + chunk, n_reads)
        cl = out_lens[r0:r1]
        o0, o1 = int(out_offsets[r0]), int(out_offsets[r1])
        within = np.arange(o1 - o0, dtype=np.int64) - np.repeat(
            out_offsets[r0:r1] - o0, cl
        )
        idx = np.repeat(src_starts[r0:r1], cl) + within
        codes_s[o0:o1] = codes[idx]
        quals_s[o0:o1] = quals[idx]
    bc_sorted = bc_ids[order]
    if n_barcodes is None:
        n_barcodes = int(bc_sorted.max()) if n_reads else 0
    bci = np.searchsorted(
        bc_sorted, np.arange(n_barcodes + 2), side="left"
    ).astype(np.int64)
    rs = ReadSet(codes_s, out_offsets, quals_s, bc_sorted, bci, barcoded)
    rs.validate()
    return rs
