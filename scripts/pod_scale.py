"""Pod-scale Monte Carlo: N dispersed lanes sharded over a device mesh.

BASELINE.json config 5 (10M dispersions over a device mesh). The lane axis
is the only parallelism in this domain (SURVEY.md §2): lanes shard across
the mesh with zero communication until the statistics reduction, which
runs as shard_map psum/all_gather collectives (NCCL between GPUs, the
network across hosts).

Scales with whatever devices exist — one GPU, several GPUs of one host,
several hosts (``jax.distributed``), or a virtual CPU mesh for validation:

  JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/pod_scale.py 4096 --devices 8
  PYTHONPATH=. python scripts/pod_scale.py 10000000

Multi-host (one command per process; the three flags are required):

  python scripts/pod_scale.py 8192 --devices 4 \
      --coordinator localhost:9911 --num-processes 2 --process-id 0 &
  python scripts/pod_scale.py 8192 --devices 4 \
      --coordinator localhost:9911 --num-processes 2 --process-id 1

Lanes are processed in per-call slabs (bounded device time + memory); each
slab's dispersions come from its own fold of the run key (and each host's
from a further fold of its process id), so the result is independent of
slab size. This replaces the reference's single-host process-pool scaling
(`/root/reference/rocket_simulation/monte_carlo.py:92-154`).
"""

import json
import sys
import time

import numpy as np


def main(total_lanes: int, n_devices: int | None = None,
         slab: int = 262_144, steps_cfg: float = 6.0, seed: int = 0,
         coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None) -> dict:
    import jax

    if n_devices is not None:
        # Must happen before ANY backend query (device_count initializes the
        # backend, after which these knobs are immutable).
        try:
            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_num_cpu_devices", n_devices)
        except Exception:
            pass

    from erpl_monte_carlo_sim_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    from erpl_monte_carlo_sim_tpu.engine import (
        InitialConditions, SimConfig, simulate_summary_batch,
    )
    from erpl_monte_carlo_sim_tpu.mc import sample_dispersions
    from erpl_monte_carlo_sim_tpu.mc.stats import FootprintAccumulator
    from erpl_monte_carlo_sim_tpu.parallel import (
        collective_footprint_moments, collective_stats,
        collective_tail_carry, init_distributed,
        make_global_batch, make_mesh,
        run_sharded_summaries, tail_reservoir_from_carry,
    )
    from erpl_monte_carlo_sim_tpu.models import liquid_motor, nominal_scene
    from erpl_monte_carlo_sim_tpu.utils.logging import configure, get_logger

    configure()
    log = get_logger("pod_scale")

    pid = init_distributed(coordinator, num_processes, process_id)
    nproc = jax.process_count()

    mesh = make_mesh()  # all global devices
    n_dev = mesh.devices.size
    lanes_q = n_dev * nproc if nproc > 1 else n_dev  # per-call multiple
    slab = max(lanes_q, (slab // lanes_q) * lanes_q)
    cfg = SimConfig(max_time=steps_cfg)
    scene = nominal_scene(liquid_motor())
    ic = InitialConditions.vertical_launch()

    key = jax.random.PRNGKey(seed)
    done_lanes = 0
    # global apogee moments accumulated from collective (exact) stats
    s0 = s1 = s2 = 0.0
    fp_acc = FootprintAccumulator()
    tail_carry = None  # device-resident global apogee extremes (top/bot-k)
    t_start = time.time()
    slab_idx = 0
    while done_lanes < total_lanes:
        n = min(slab, total_lanes - done_lanes)
        n = max(lanes_q, (n // lanes_q) * lanes_q)
        slab_key = jax.random.fold_in(key, slab_idx)

        if nproc > 1:
            # Each host samples ITS shard of the slab and contributes it to
            # one global sharded array (make_array_from_process_local_data).
            local_n = n // nproc
            scene_l, ic_l, _ = sample_dispersions(
                jax.random.fold_in(slab_key, pid), scene, ic, n=local_n
            )
            host = jax.tree.map(np.asarray, (scene_l, ic_l))
            # base_tree: batched-leaf classification by gained dim (not by
            # the local_n shape coincidence — a shared 100-knot grid with
            # local_n=100 lanes must stay replicated, not concatenated).
            scene_g, ic_g = make_global_batch(
                host, mesh, local_n, base_tree=(scene, ic)
            )
            summary = simulate_summary_batch(scene_g, ic_g, cfg)
        else:
            scene_b, ic_b, _ = sample_dispersions(slab_key, scene, ic, n=n)
            summary = run_sharded_summaries(scene_b, ic_b, None, cfg, mesh, n)

        st = collective_stats(summary.rail.rail_exit_speed, None, mesh)
        # None mask: all lanes; non-finite lanes are excluded internally
        apo = collective_stats(summary.apogee_altitude, None, mesh)
        fp_acc.add(*collective_footprint_moments(
            summary.landing_position, None, mesh))
        # fold this slab's collective top-k/bottom-k into the DEVICE-side
        # carry (exact order-statistics merge; no per-slab candidate
        # readback — scalars only cross the host link inside the loop)
        _, tail_carry = collective_tail_carry(
            summary.apogee_altitude, None, mesh, tail_carry
        )
        k = float(apo["n"])
        mean_k = float(apo["mean"])
        std_k = float(apo["std"])
        s0 += k
        s1 += mean_k * k
        s2 += (std_k * std_k + mean_k * mean_k) * k
        done_lanes += n
        slab_idx += 1
        if pid == 0:
            log.info(
                "slab %d: %d/%d lanes (rail-exit mean %.2f m/s across "
                "%d devices / %d processes)", slab_idx, done_lanes,
                total_lanes, float(st["mean"]), n_dev, nproc,
            )
    wall = time.time() - t_start
    mean = s1 / max(s0, 1)
    # ONE end-of-run readback of the device-side tail carry
    tail_acc = tail_reservoir_from_carry(tail_carry, int(s0))
    result = {
        "lanes": done_lanes,
        "devices": n_dev,
        "processes": nproc,
        # global apogee order statistics (collective_tail_carry):
        # ready for mc.tail.gpd_tail range-safety queries at pod scale
        "apogee_extremes": {
            "n": tail_acc.n,
            "max": float(tail_acc.hi[-1]) if tail_acc.hi.size else None,
            "min": float(tail_acc.lo[0]) if tail_acc.lo.size else None,
        },
        "wall_s": round(wall, 1),
        "traj_per_s": round(done_lanes / wall, 1),
        "apogee_mean_at_cutoff": round(mean, 1),
        "apogee_std_at_cutoff": round(
            (max(s2 / max(s0, 1) - mean**2, 0.0)) ** 0.5, 1
        ),
        # position dispersion at the step-budget cutoff (full-flight runs
        # land; short-window runs disperse in-flight) — psum'd moments,
        # no per-lane gather
        "footprint_at_cutoff": fp_acc.footprint(),
    }
    print(json.dumps(result), flush=True)
    return result


def _flag(name, cast=str):
    if name in sys.argv:
        return cast(sys.argv[sys.argv.index(name) + 1])
    return None


if __name__ == "__main__":
    args = [a for i, a in enumerate(sys.argv[1:], 1)
            if not a.startswith("--") and not sys.argv[i - 1].startswith("--")]
    total = int(args[0]) if args else 1_048_576
    main(
        total,
        n_devices=_flag("--devices", int),
        steps_cfg=_flag("--max-time", float) or 6.0,
        coordinator=_flag("--coordinator"),
        num_processes=_flag("--num-processes", int),
        process_id=_flag("--process-id", int),
    )
