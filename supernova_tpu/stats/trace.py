"""Stage tracing + memory checkpoints.

Analogue of the reference's wall-clock tracing (`Date()`-stamped stage
logging, WallClockTime/TimeSince around stages — DF.cc:83,711), the STAGE()
macro (RunStages.h:109: stage entry with mem/peak) and MEM() checkpoints
(DfTools.h:6-10), with device-memory stats from the JAX runtime in place
of jemalloc's host numbers.

Peaks are process high-water marks read at the end of each stage: the
device's `memory_stats()["peak_bytes_in_use"]` (the most the program's
arrays ever took on the device) and the host's `ru_maxrss`.  Both only
grow, so a stage's value is the peak of that stage and every stage before
it.  The CPU backend reports no device stats and records host memory only;
an accelerator without `memory_stats()` is an error, not a zero.
"""
from __future__ import annotations

import logging
import resource
import time
from contextlib import contextmanager

log = logging.getLogger("supernova_tpu")


def device_peak_bytes() -> int | None:
    """Largest `peak_bytes_in_use` over the local devices; None on the CPU
    backend.  Raises on an accelerator whose runtime keeps no stats."""
    import jax

    from ..core.jaxconfig import on_accelerator

    if not on_accelerator():
        return None
    peaks = []
    for d in jax.local_devices():
        ms = d.memory_stats()
        if not ms or "peak_bytes_in_use" not in ms:
            raise RuntimeError(
                f"{d} ({d.platform}) reports no memory_stats()"
                "['peak_bytes_in_use']; device memory cannot be traced"
            )
        peaks.append(int(ms["peak_bytes_in_use"]))
    return max(peaks)


def host_peak_bytes() -> int:
    """Host resident-set high-water mark of this process (ru_maxrss, KiB
    on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


@contextmanager
def stage(name: str, stats=None):
    """STAGE(x) analogue: logs entry/exit with elapsed time + memory peaks;
    optionally records etime_/mem_peak_ stats into a StatLogger.

    Reference analogue: per-stage `etime_*_h` / `mem_peak_*_gb` stats
    (DF.cc:705-707, CP.cc:1925-1933)."""
    t0 = time.time()
    log.info("STAGE %s: begin", name)
    try:
        yield
    finally:
        dt = time.time() - t0
    dev = device_peak_bytes()
    host = host_peak_bytes() / 2**30
    log.info(
        "STAGE %s: done in %.2fs (device peak %s, host peak %.2f GiB)",
        name, dt, "n/a" if dev is None else f"{dev / 2**30:.2f} GiB", host,
    )
    if stats is not None:
        stats.log(f"etime_{name}_h", dt / 3600.0, stage=name)
        if dev is not None:
            stats.log(f"mem_peak_{name}_gb", round(dev / 2**30, 3), stage=name)
        stats.log(f"mem_peak_host_{name}_gb", round(host, 3), stage=name)

