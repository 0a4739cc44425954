"""Base-code substrate: DNA as small integer codes (A=0,C=1,G=2,T=3).

Device-side analogue of the reference's 2-bit Basevector
(lib/assembly/src/Basevector.h, dna/Bases.h).  In host memory we keep flat
uint8 code arrays + CSR offsets; device kernels pack 16 codes per uint32 word
(see core/kmer_codec.py).  Complement is code ^ 3 (A<->T, C<->G), which keeps
lexicographic order of packed words equal to lexicographic base order.
"""
from __future__ import annotations

import numpy as np

BASES = "ACGT"
_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    _CODE[ord(_b)] = _i
    _CODE[ord(_b.lower())] = _i
# N and other ambiguity codes map to A (code 0), matching the reference's
# GeneralizedBase::random-free CS behavior of treating unknowns as a fixed base;
# callers that care mask them via quals.
_CODE[ord("N")] = 0
_CODE[ord("n")] = 0

_BASE_ARR = np.frombuffer("ACGT".encode(), dtype=np.uint8)


def seq_to_codes(seq: str, n_as: int = 0) -> np.ndarray:
    """ASCII DNA string -> uint8 codes (0..3).  n_as sets the code N
    maps to (default 0 = A; pass 4 to keep scaffold gaps distinct)."""
    raw = np.frombuffer(seq.encode(), dtype=np.uint8)
    codes = _CODE[raw]
    if (codes == 255).any():
        bad = chr(raw[int(np.argmax(codes == 255))])
        raise ValueError(f"invalid base {bad!r}")
    if n_as != 0:
        codes = codes.copy()
        codes[(raw == ord("N")) | (raw == ord("n"))] = n_as
    return codes


def codes_to_seq(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII DNA string."""
    return _BASE_ARR[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (complement = code ^ 3)."""
    return (np.asarray(codes) ^ 3)[::-1]


def comp(codes: np.ndarray) -> np.ndarray:
    return np.asarray(codes) ^ 3
