"""Real multi-process (multi-controller) wiring: 2 CPU processes x 2
virtual devices each, joined with jax.distributed, running the DCN-aware
hierarchical count over the global ("host","chip") mesh.  The reference
runs cluster-wide via mrp/SGE (tenkit/bin/common/_mrp:26); this validates
our jax.distributed equivalent end-to-end without multi-host hardware."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_fleet(tmp_path, n_proc: int = 2, local_devices: int = 2):
    port = _free_port()
    procs = []
    for pid in range(n_proc):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)  # worker sets its own device count
        env.update(
            SUPERNOVA_COORDINATOR=f"127.0.0.1:{port}",
            SUPERNOVA_NUM_PROCESSES=str(n_proc),
            SUPERNOVA_PROCESS_ID=str(pid),
            SUPERNOVA_LOCAL_DEVICES=str(local_devices),
            MPW_OUT=str(tmp_path),
            JAX_PLATFORMS="cpu",
            PYTHONPATH=f"{REPO}:{env.get('PYTHONPATH', '')}",
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, str(REPO / "tests" / "multiproc_worker.py")],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    return procs, outs


@pytest.mark.slow
def test_two_process_hier_count_matches_single_process(tmp_path):
    procs, outs = launch_fleet(tmp_path)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"

    r0 = np.load(tmp_path / "rank0.npz")
    r1 = np.load(tmp_path / "rank1.npz")
    # both processes must hold the identical fleet-wide gathered table
    for k in ("wa", "wb", "wc", "count", "nbc", "n_valid"):
        assert np.array_equal(r0[k], r1[k]), f"ranks disagree on {k}"

    # single-process reference: same mesh shape (2x2) on this process's
    # virtual devices, same readset, same program
    from jax.sharding import PartitionSpec as P

    from supernova_tpu.parallel.mesh import CHIP_AXIS, HOST_AXIS, make_mesh2
    from supernova_tpu.parallel.sharded_count import (
        sharded_count_hier,
        split_readset,
    )
    from tests.multiproc_worker import dryrun_readset

    n_dev = int(r0["n_dev"])
    rs = dryrun_readset(n_dev)
    codes, pr, glp, bcp, nbl, rl, url = split_readset(
        rs, n_dev, base_bucket=2048, read_bucket=64
    )
    mesh = make_mesh2(2, 2)
    tables, ovf = sharded_count_hier(
        mesh,
        *map(np.asarray, (codes, pr, glp, bcp)),
        n_hosts=2,
        chips_per_host=2,
        capacity=2 * nbl,
        min_freq=1,
        uniform_rl=url,
    )
    assert int(np.asarray(ovf).sum()) == 0
    ref = {
        "wa": np.asarray(tables.words.a),
        "wb": np.asarray(tables.words.b),
        "wc": np.asarray(tables.words.c),
        "count": np.asarray(tables.count),
        "nbc": np.asarray(tables.nbc),
        "n_valid": np.asarray(tables.n_valid),
    }
    for k, v in ref.items():
        assert np.array_equal(r0[k], v), (
            f"multi-process {k} differs from single-process"
        )

    # ---- distributed build -> path -> nucleate (the full §5.8 story) ----
    # both ranks agree...
    for k in ("graph_checksum", "graph_n_edges", "graph_inv", "path_len",
              "path_edges", "glue_labels", "glue_ovf"):
        assert np.array_equal(r0[k], r1[k]), f"ranks disagree on {k}"
    assert int(r0["glue_ovf"]) == 0

    # ...and match the same chain run single-process on the local 4-device
    # mesh (sharded_count -> sharded_build_graph -> sharded_path -> glue)
    import jax.numpy as jnp

    from supernova_tpu.core import kmer_codec as kcodec
    from supernova_tpu.parallel.mesh import make_mesh
    from supernova_tpu.parallel.sharded_build import sharded_build_graph
    from supernova_tpu.parallel.sharded_count import sharded_count
    from supernova_tpu.parallel.sharded_nucleate import glue_closures_sharded
    from supernova_tpu.parallel.sharded_path import (
        sharded_path,
        split_for_pathing,
    )

    mesh1 = make_mesh(n_dev)
    codes1, pr1, glp1, bcp1, nbl1, rl1, url1 = split_readset(
        rs, n_dev, base_bucket=2048, read_bucket=64
    )
    tables1, ovf1 = sharded_count(
        mesh1, *map(np.asarray, (codes1, pr1, glp1, bcp1)),
        n_dev=n_dev, capacity=2 * nbl1, min_freq=1, uniform_rl=url1,
    )
    assert int(np.asarray(ovf1).sum()) == 0
    bg = sharded_build_graph(mesh1, tables1, n_dev)
    assert int(r0["graph_checksum"]) == bg.checksum()
    assert int(r0["graph_n_edges"]) == bg.n_edges
    assert np.array_equal(r0["graph_inv"], bg.inv)

    pcodes, poff, ppr, prlen, _, _, _ = split_for_pathing(
        rs, n_dev, base_bucket=2048, read_bucket=64
    )
    rp = sharded_path(
        mesh1,
        kcodec.np_to_soa(bg.kmer_words),
        jnp.asarray(bg.node_edge),
        jnp.asarray(bg.node_pos),
        jnp.asarray(bg.from_v.astype(np.int32)),
        jnp.asarray(bg.to_v.astype(np.int32)),
        jnp.asarray((bg.edges.lengths() - (kcodec.K - 1)).astype(np.int32)),
        jnp.asarray(pcodes), jnp.asarray(poff), jnp.asarray(ppr),
        jnp.asarray(prlen),
    )
    assert np.array_equal(r0["path_len"], np.asarray(rp.path_len))
    assert np.array_equal(r0["path_edges"], np.asarray(rp.edges))

    from supernova_tpu.asm.nucleate import sanitize_closures

    pe, pl = np.asarray(rp.edges), np.asarray(rp.path_len)
    walks = [
        [int(e) for e in pe[r, : int(pl[r])]]
        for r in range(pe.shape[0]) if int(pl[r]) > 0
    ]
    cls = sanitize_closures(bg, walks)
    labels, govf = glue_closures_sharded(
        mesh1, bg, cls, min_over_bases=100, adaptive=False
    )
    assert govf == 0
    assert np.array_equal(r0["glue_labels"], labels)
