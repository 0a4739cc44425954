"""stats/trace.stage: per-stage wall and memory peaks from the runtime."""
import pytest

from supernova_tpu.core import jaxconfig
from supernova_tpu.stats import trace
from supernova_tpu.stats.logger import StatLogger


class _Dev:
    platform = "gpu"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _fake_accelerator(monkeypatch, devices):
    import jax

    monkeypatch.setattr(jaxconfig, "on_accelerator", lambda: True)
    monkeypatch.setattr(jax, "local_devices", lambda: devices)


def test_stage_records_device_peak(monkeypatch):
    _fake_accelerator(monkeypatch, [
        _Dev({"peak_bytes_in_use": 3 << 30, "bytes_in_use": 1 << 30}),
        _Dev({"peak_bytes_in_use": 5 << 29}),
    ])
    st = StatLogger()
    with trace.stage("count", st):
        pass
    assert st.get("mem_peak_count_gb") == 3.0
    assert st.get("etime_count_h") >= 0
    assert st.get("mem_peak_host_count_gb") > 0


def test_stage_raises_without_memory_stats(monkeypatch):
    _fake_accelerator(monkeypatch, [_Dev(None)])
    with pytest.raises(RuntimeError, match="memory_stats"):
        with trace.stage("count", StatLogger()):
            pass


def test_stage_on_cpu_records_host_only():
    st = StatLogger()
    with trace.stage("graph", st):
        pass
    assert st.get("mem_peak_graph_gb") is None
    assert st.get("mem_peak_host_graph_gb") > 0
