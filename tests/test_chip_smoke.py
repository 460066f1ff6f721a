"""``chip_smoke.py`` and ``bench.py`` refuse to run without a GPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_fails_without_gpu(script):
    proc = _run(REPO / script, REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "gs360x" in proc.stderr
