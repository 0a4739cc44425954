"""Multi-process (multi-host) wiring.

The reference runs cluster-wide through mrp/SGE (tenkit/bin/common/_mrp:26:
one martian runtime per cluster job).  The JAX equivalent is
multi-controller: one Python process per host, all processes joined through
`jax.distributed.initialize`, every jit/shard_map program spanning the
global ("host", "chip") mesh with DCN collectives over the host axis
(SURVEY.md §5.8).

Environment contract (mirrors the standard JAX pod env, with SUPERNOVA_*
overrides so CPU dryruns can fake a fleet):

    SUPERNOVA_COORDINATOR   host:port of process 0 (required when faking)
    SUPERNOVA_NUM_PROCESSES total process count
    SUPERNOVA_PROCESS_ID    this process's rank
    SUPERNOVA_LOCAL_DEVICES optional device count per process (CPU dryruns:
                            also sets xla_force_host_platform_device_count)

Nothing on a GPU host tells JAX of a cluster, so every multi-process run
states all three: SUPERNOVA_COORDINATOR, SUPERNOVA_NUM_PROCESSES and
SUPERNOVA_PROCESS_ID (a single host's coordinator is `localhost:<port>`).

`init_from_env` must run BEFORE first jax use in the process.
"""
from __future__ import annotations

import os

import numpy as np


def init_from_env() -> bool:
    """Join the multi-process fleet described by the environment.

    Returns True if `jax.distributed.initialize` was called (multi-process
    mode), False for plain single-process runs.  Call before first jax use.
    """
    n = os.environ.get("SUPERNOVA_NUM_PROCESSES")
    if n is None:
        return False
    n = int(n)
    if n <= 1:
        return False
    coord = os.environ["SUPERNOVA_COORDINATOR"]
    pid = int(os.environ["SUPERNOVA_PROCESS_ID"])
    local = os.environ.get("SUPERNOVA_LOCAL_DEVICES")
    if local is not None:
        # CPU dryrun fleet: give each process `local` virtual host devices
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={local}"
            ).strip()
    import jax

    if local is not None:
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception:
            pass
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=n, process_id=pid
    )
    return True


def fleet_mesh():
    """("host", "chip") mesh over the whole fleet: rows = processes (DCN),
    columns = each process's local devices (ICI).  jax.devices() orders
    devices process-major, so mesh rows coincide with processes."""
    import jax

    from .mesh import make_mesh2

    return make_mesh2(jax.process_count(), jax.local_device_count())


def to_global(mesh, spec, arr: np.ndarray):
    """Host array -> global jax.Array with NamedSharding(mesh, spec).

    Single-process: returns the array unchanged (jit lays it out).
    Multi-process: every process holds the SAME full host array (the
    replicated-host-input model — ingest is deterministic per process) and
    this assembles the global Array by slicing out each locally-addressable
    shard (jax.make_array_from_callback)."""
    import jax
    from jax.sharding import NamedSharding

    if jax.process_count() == 1:
        return arr
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sh, lambda idx: arr[idx])


def from_global(x) -> np.ndarray:
    """Global sharded jax.Array -> full host numpy on EVERY process
    (all-gather of the non-addressable shards over DCN)."""
    import jax

    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def ensure_global(mesh, spec, x):
    """to_global for host/local arrays under a multi-process fleet;
    pass-through for already-global (non-fully-addressable) jax.Arrays and
    for single-process runs.  Lets the sharded kernels accept either a
    host-built input (replicated-host model) or an upstream stage's global
    output without caring which."""
    import jax

    if jax.process_count() == 1:
        return x
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        return x
    return to_global(mesh, spec, np.asarray(x))


def host_fetch(x) -> np.ndarray:
    """np.asarray that also works on non-addressable global Arrays (DCN
    all-gather under a multi-process fleet, plain pull otherwise)."""
    import jax

    if (
        jax.process_count() > 1
        and isinstance(x, jax.Array)
        and not x.is_fully_addressable
    ):
        return from_global(x)
    return np.asarray(x)


def local_rows(x) -> tuple[np.ndarray, list[int]]:
    """This process's addressable shard rows of a global Array ->
    (stacked host rows, shard indices along axis 0).  For per-shard result
    checking without a DCN gather."""
    import jax

    shards = sorted(
        (s for s in x.addressable_shards), key=lambda s: s.index[0].start or 0
    )
    del jax
    idx = [s.index[0].start or 0 for s in shards]
    return np.stack([np.asarray(s.data) for s in shards]), idx
