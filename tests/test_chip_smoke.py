"""chip_smoke.py off the card: it refuses anything but a GPU and prints no
result line; its result line has the one fixed shape."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(script: Path, cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_ok_line(stdout: str) -> bool:
    return any('"ok"' in line for line in stdout.splitlines())


def test_smoke_refuses_cpu_platform():
    r = _run(ROOT / "chip_smoke.py", ROOT)
    assert r.returncode != 0
    assert not _has_ok_line(r.stdout)
    assert "needs an NVIDIA GPU" in r.stderr


def test_smoke_refuses_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert not _has_ok_line(r.stdout)


def test_smoke_ok_line_shape():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    line = chip_smoke.ok_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
