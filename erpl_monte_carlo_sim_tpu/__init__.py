"""erpl_monte_carlo_sim_tpu — accelerator-batched 6DOF Monte Carlo flight dynamics.

A from-scratch JAX/XLA rebuild of the capabilities of
``smcconoughey/erpl_monte_carlo_sim``:

  * scene = frozen pytree dataclasses (Rocket / Motor / Atmosphere / Wind),
  * single flight = one jitted RK4 loop with branch-free masked events
    (rail exit, burnout ramp, parachute latch, apogee, tiered coast timeout,
    ground impact),
  * Monte Carlo = ``vmap`` over a dispersion pytree sampled with
    ``jax.random`` keys (reproducible by construction),
  * scale-out = sharding the batch axis over a ``jax.sharding.Mesh``
    (XLA collectives between devices replace the reference's process
    pool).
"""

__version__ = "0.1.0"

from . import engine, mc, models, ops, parallel, reporting, utils  # noqa: F401
from .models import (  # noqa: F401
    AtmosphereParams,
    MotorParams,
    RocketParams,
    Scene,
    WindField,
    WindModelParams,
    liquid_motor,
    nominal_scene,
    solid_motor,
)
