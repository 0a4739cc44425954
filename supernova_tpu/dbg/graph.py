"""BaseGraph: host-side unipath graph container (HyperBasevector analogue).

Mirrors paths/HyperBasevector.h:34-225: edges are base sequences overlapping
by K-1 at shared vertices, with an involution inv[e] = rc edge and
Kmers(e) = len(e) - K + 1.  Adds the kmer->(edge,pos) dictionary the pather
needs (ReadPather's KmerDict equivalent) and structural Validate() in the
spirit of the reference's Validate(hb, inv, D, dinv) checks (CleanThe.cc).
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..core import dna
from ..core.kmer_codec import K
from ..core.ragged import Ragged


@dataclass
class BaseGraph:
    edges: Ragged  # edge base codes (uint8 values)
    inv: np.ndarray  # (E,) int32
    from_v: np.ndarray  # (E,) int32
    to_v: np.ndarray  # (E,) int32
    n_vertices: int
    is_circle: np.ndarray  # (E,) bool
    # kmer dictionary (for read pathing): sorted canonical kmer words +
    # oriented-node -> (edge, pos) map; row r, dir d -> node 2r+d
    kmer_words: np.ndarray | None = None  # (M,3) uint32 sentinel-padded
    node_edge: np.ndarray | None = None  # (2M,) int32
    node_pos: np.ndarray | None = None  # (2M,) int32
    n_kmers: int = 0

    @property
    def n_edges(self) -> int:
        return self.edges.n_rows

    def edge_len(self, e: int) -> int:
        return int(self.edges.offsets[e + 1] - self.edges.offsets[e])

    def kmers(self, e: int) -> int:
        """#kmers on edge e (HyperBasevector::Kmers)."""
        return self.edge_len(e) - K + 1

    def edge_seq(self, e: int) -> str:
        return dna.codes_to_seq(self.edges.row(e))

    def total_kmers(self) -> int:
        return int((self.edges.lengths() - (K - 1)).sum())

    def checksum(self) -> int:
        """Deterministic FNV-1a over sorted edge sequences (the reference
        keeps an assembly checksum stat: astats/AssemblyStats.cc:726)."""
        h = np.uint64(0xCBF29CE484222325)
        prime = np.uint64(0x100000001B3)
        with np.errstate(over="ignore"):
            for s in sorted(self.edge_seq(e) for e in range(self.n_edges)):
                for b in s.encode():
                    h = (h ^ np.uint64(b)) * prime
        return int(h)

    def device_arrays(self) -> dict:
        """Device-resident dictionary + topology for the pather, transferred
        once per graph and cached on the instance.  path_readset is called
        repeatedly on the same graph (initial pathing, post-patch re-pathing,
        per-block dispatch), and re-uploading the kmer table each call is
        wasted host->device traffic.
        BaseGraphs are immutable after construction (graph edits build new
        instances via from_device/load), so the cache never goes stale."""
        da = self.__dict__.get("_device_arrays")
        if da is None:
            import jax.numpy as jnp

            from ..core import kmer_codec as kcodec

            da = dict(
                words=kcodec.np_to_soa(self.kmer_words),
                node_edge=jnp.asarray(self.node_edge),
                node_pos=jnp.asarray(self.node_pos),
                from_v=jnp.asarray(self.from_v.astype(np.int32)),
                to_v=jnp.asarray(self.to_v.astype(np.int32)),
                edge_kmers=jnp.asarray(
                    (self.edges.lengths() - (K - 1)).astype(np.int32)
                ),
            )
            self.__dict__["_device_arrays"] = da
        return da

    def validate(self):
        E = self.n_edges
        assert len(self.inv) == E and len(self.from_v) == E and len(self.to_v) == E
        lens = self.edges.lengths()
        assert (lens >= K).all(), "edge shorter than K"
        inv = self.inv
        assert ((inv >= 0) & (inv < E)).all()
        assert np.array_equal(inv[inv], np.arange(E)), "inv not an involution"
        for e in range(E):
            re = int(inv[e])
            if self.is_circle[e]:
                # rc of a circular unipath may be emitted at another rotation
                s = self.edge_seq(e)
                core = s[: len(s) - (K - 1)]
                rcs = dna.codes_to_seq(dna.revcomp(self.edges.row(re)))
                rcore = rcs[: len(rcs) - (K - 1)]
                assert len(core) == len(rcore) and rcore in core + core, e
            else:
                assert np.array_equal(
                    self.edges.row(re), dna.revcomp(self.edges.row(e))
                ), f"inv edge {re} is not rc of {e}"
            # vertex pairing under rc: from(e) <-> to(inv[e]) correspond to
            # rc 47-mers, so only degree structure is asserted here
        # K-1 overlap at shared vertices
        starts47 = {}
        for e in range(E):
            starts47.setdefault(int(self.from_v[e]), set()).add(
                self.edge_seq(e)[: K - 1]
            )
        for v, ss in starts47.items():
            assert len(ss) == 1, f"vertex {v} has inconsistent out 47-mers"
        ends47 = {}
        for e in range(E):
            ends47.setdefault(int(self.to_v[e]), set()).add(self.edge_seq(e)[-(K - 1):])
        for v, ss in ends47.items():
            assert len(ss) == 1, f"vertex {v} has inconsistent in 47-mers"

    def save(self, path: str | Path):
        np.savez_compressed(
            path,
            values=self.edges.values,
            offsets=self.edges.offsets,
            inv=self.inv,
            from_v=self.from_v,
            to_v=self.to_v,
            n_vertices=np.int64(self.n_vertices),
            is_circle=self.is_circle,
            kmer_words=self.kmer_words if self.kmer_words is not None else np.zeros((0, 3), np.uint32),
            node_edge=self.node_edge if self.node_edge is not None else np.zeros(0, np.int32),
            node_pos=self.node_pos if self.node_pos is not None else np.zeros(0, np.int32),
            n_kmers=np.int64(self.n_kmers),
        )

    @staticmethod
    def load(path: str | Path) -> "BaseGraph":
        z = np.load(path)
        kw = z["kmer_words"]
        return BaseGraph(
            edges=Ragged(z["values"], z["offsets"]),
            inv=z["inv"],
            from_v=z["from_v"],
            to_v=z["to_v"],
            n_vertices=int(z["n_vertices"]),
            is_circle=z["is_circle"],
            kmer_words=kw if len(kw) else None,
            node_edge=z["node_edge"] if len(z["node_edge"]) else None,
            node_pos=z["node_pos"] if len(z["node_pos"]) else None,
            n_kmers=int(z["n_kmers"]),
        )


def from_device(dg, table=None) -> BaseGraph:
    """DeviceGraph (+ optional KmerTable for the dictionary) -> BaseGraph.
    Slices the bucket-padded device arrays down to the true edge count."""
    n_edges = int(dg.n_edges)
    offsets = np.asarray(dg.edge_offsets).astype(np.int64)[: n_edges + 1]
    flat = int(offsets[-1]) if len(offsets) else 0
    values = np.asarray(dg.edge_codes)[:flat].astype(np.uint8)
    bg = BaseGraph(
        edges=Ragged(values, offsets),
        inv=np.asarray(dg.inv)[:n_edges],
        from_v=np.asarray(dg.from_v)[:n_edges],
        to_v=np.asarray(dg.to_v)[:n_edges],
        n_vertices=int(dg.n_vertices),
        is_circle=np.asarray(dg.is_circle)[:n_edges],
        node_edge=np.asarray(dg.node_edge),
        node_pos=np.asarray(dg.node_pos),
    )
    if table is not None:
        from ..core import kmer_codec as kc

        bg.kmer_words = kc.soa_to_np(table.words)
        bg.n_kmers = int(table.n_valid)
    return bg
