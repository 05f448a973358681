"""The driver-facing entry points: __graft_entry__.entry() and
dryrun_multichip(8) on the 8-device CPU mesh, and chip_smoke.py's refusal
to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def test_entry_step_shapes():
    sys.path.insert(0, str(ROOT))
    import __graft_entry__ as g

    fn, args = g.entry()
    fd, xre, xim, hr, hi = fn(*args)
    assert fd.shape == (3, 16)
    assert xre.shape == xim.shape == (16, 10, 1)
    assert hr.shape == hi.shape == (4, 399)
    assert np.isfinite(np.asarray(fd)).all()


def test_dryrun_multichip_8_devices():
    sys.path.insert(0, str(ROOT))
    import jax

    import __graft_entry__ as g

    assert len(jax.devices()) == 8
    g.dryrun_multichip(8)


def _run_smoke(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _assert_no_result(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            assert not json.loads(line).get("ok")


def test_chip_smoke_refuses_cpu():
    """Under JAX_PLATFORMS=cpu the smoke test stops before any phase."""
    proc = _run_smoke(ROOT, {"JAX_PLATFORMS": "cpu"})
    _assert_no_result(proc)
    assert "no GPU" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo, the script fails instead of finding some other copy."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path, {"JAX_PLATFORMS": "cpu", "PYTHONPATH": ""})
    _assert_no_result(proc)
