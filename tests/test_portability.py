"""The package imports and flies with only jax, numpy and scipy, and the
compile cache goes exactly where ``utils.cache`` says."""

import json
import os
import subprocess
import sys

import pytest

from erpl_monte_carlo_sim_tpu.utils.cache import default_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **env_overrides):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_overrides)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()[-1]


def test_import_and_fly_without_flax_or_matplotlib():
    out = _run(
        "import sys\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import jax\n"
        "import erpl_monte_carlo_sim_tpu as sim\n"
        "from erpl_monte_carlo_sim_tpu.engine import (InitialConditions,\n"
        "    SimConfig, simulate_summary)\n"
        "s = jax.jit(simulate_summary, static_argnums=2)(\n"
        "    sim.nominal_scene(sim.liquid_motor()),\n"
        "    InitialConditions.vertical_launch(), SimConfig(max_time=2.0))\n"
        "print(float(s.max_speed))\n"
    )
    assert float(out) > 40.0  # past rail exit (42 m/s) within 2 s


_CACHE = ("import json\n"
          "import jax\n"
          "from erpl_monte_carlo_sim_tpu.utils.cache import "
          "enable_persistent_cache\n"
          "got = enable_persistent_cache()\n"
          "print(json.dumps([got, jax.config.jax_compilation_cache_dir]))\n")


def test_cache_follows_env_var(tmp_path):
    want = str(tmp_path / "cache")
    got, configured = json.loads(_run(_CACHE, JAX_COMPILATION_CACHE_DIR=want))
    assert got == configured == want


def test_cache_default_is_inside_checkout():
    got, configured = json.loads(_run(_CACHE))
    assert got == configured == default_cache_dir(cpu=True)
    assert os.path.dirname(got) == REPO
    assert os.path.basename(got).startswith(".jax_compile_cache-")


@pytest.mark.parametrize("cpu", [False, True])
def test_default_cache_dir_is_fixed(cpu):
    path = default_cache_dir(cpu)
    assert path == default_cache_dir(cpu)
    assert os.path.dirname(path) == REPO
    assert (path == os.path.join(REPO, ".jax_compile_cache")) != cpu


def test_struct_dataclass_is_a_frozen_pytree():
    import dataclasses

    import jax

    from erpl_monte_carlo_sim_tpu.utils import struct

    @struct.dataclass
    class Params:
        a: float
        name: str = struct.field(pytree_node=False, default="x")
        b: float = 2.0

    p = Params(1.0)
    leaves, treedef = jax.tree.flatten(p)
    assert leaves == [1.0, 2.0]  # children in declaration order
    assert jax.tree.unflatten(treedef, [4.0, 5.0]) == Params(4.0, "x", 5.0)
    assert jax.tree.structure(Params(1.0, "y")) != treedef  # static field
    q = p.replace(b=3.0)
    assert (q.b, p.b) == (3.0, 2.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = 5.0
