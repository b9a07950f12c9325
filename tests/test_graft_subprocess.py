"""Fresh-process validation of ``__graft_entry__.dryrun_multichip``.

The conftest pre-forces 8 CPU devices, so an in-process test of
``dryrun_multichip`` would pass even if the function queried the backend
before its platform config updates (which freezes the knobs). This test
runs it the way a caller does: a fresh subprocess with only the repo on
PYTHONPATH and no platform pre-selected in the environment — the function
must select the CPU virtual mesh itself.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    # The point of the test is that dryrun_multichip must win even when the
    # environment does NOT pre-select CPU.
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


def test_dryrun_multichip_fresh_process():
    proc = subprocess.run(
        [sys.executable, "-c",
         "from __graft_entry__ import dryrun_multichip\n"
         "dryrun_multichip(8)\n"
         "print('DRYRUN_OK')\n"],
        env=_fresh_env(),
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, (
        f"dryrun_multichip failed in a fresh process:\n"
        f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-2000:]}"
    )
    assert "DRYRUN_OK" in proc.stdout
