"""Card-only tests: the device programs on the GPU agree exactly with the
same programs on the CPU device of the same process.  Marked `gpu`; each
takes the `gpu` fixture, which skips where JAX has no GPU.  chip_smoke.py
runs them on the card (phase 5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supernova_tpu.core import kmer_codec as kc
from supernova_tpu.kmer import count as kcount
from supernova_tpu.ops import segments as seg

pytestmark = pytest.mark.gpu


def _on(dev, fn, *args, **kw):
    return jax.tree.map(
        np.asarray, fn(*jax.device_put(args, dev), **kw)
    )


def _equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _reads(rng, n_reads=2048, rl=150, genome=20_000):
    g = rng.integers(0, 4, genome)
    starts = rng.integers(0, genome - rl, n_reads)
    codes = g[starts[:, None] + np.arange(rl)[None, :]].reshape(-1)
    nb = n_reads * rl
    codes_ext = np.zeros(nb + 128, np.int32)
    codes_ext[:nb] = codes
    pos_read = np.repeat(np.arange(n_reads, dtype=np.int32), rl)
    glen = np.full(nb, rl, np.int32)
    bc = np.repeat(rng.integers(1, 64, n_reads).astype(np.int32), rl)
    return codes_ext, pos_read, glen, bc


def test_gpu_count_matches_cpu(gpu, rng):
    args = _reads(rng)
    cpu = jax.devices("cpu")[0]
    got = _on(gpu, kcount.count_kmers, *args, uniform_rl=150)
    ref = _on(cpu, kcount.count_kmers, *args, uniform_rl=150)
    assert int(got.n_valid) > 0
    _equal(got, ref)


def test_gpu_compaction_matches_cpu(gpu, rng):
    n = 1 << 20
    keep = rng.random(n) < 0.3
    cols = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(5)]
    cpu = jax.devices("cpu")[0]
    got = _on(gpu, seg.stable_compact, keep, *cols)
    ref = _on(cpu, seg.stable_compact, keep, *cols)
    _equal(got, ref)
    assert np.array_equal(got[1][0][: keep.sum()], cols[0][keep])


def test_gpu_sort_by_words_matches_cpu(gpu, rng):
    n = 1 << 20
    w = kc.W3(*(rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(3)))
    extra = rng.integers(0, 2**32, n, dtype=np.uint32)
    cpu = jax.devices("cpu")[0]

    def srt(a, b, c, e):
        ws, (es,), _ = kc.sort_by_words(kc.W3(a, b, c), extra_keys=(e,),
                                        stable=False)
        return ws, es

    _equal(_on(gpu, srt, *w, extra), _on(cpu, srt, *w, extra))


def test_gpu_memory_stats_report_peak(gpu):
    x = jax.device_put(jnp.ones((1 << 20,), jnp.float32), gpu)
    jax.block_until_ready(x * 2)
    ms = gpu.memory_stats()
    assert ms and ms["peak_bytes_in_use"] >= 4 << 20


def test_gpu_ragged_all_to_all_lowers(gpu):
    """ragged_all_to_all compiles and runs on one GPU (a 1-device mesh):
    each device sends its first `n` rows to itself."""
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.array([gpu]), ("d",))

    def body(x, out):
        n = jnp.array([5], jnp.int32)
        z = jnp.array([0], jnp.int32)
        return jax.lax.ragged_all_to_all(x, out, z, n, z, n, axis_name="d")

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("d"), P("d")),
                               out_specs=P("d")))
    x = jnp.arange(8, dtype=jnp.uint32)
    out = np.asarray(fn(x, jnp.zeros((8,), jnp.uint32)))
    assert out[:5].tolist() == [0, 1, 2, 3, 4] and out[5:].tolist() == [0, 0, 0]
