"""Scene = the full simulation configuration as one pytree.

The reference composes four mutable objects into FlightSimulator
(`simulator.py:12-16`). Here the scene is a single frozen pytree so that:

  * a Monte Carlo batch is just a Scene whose leaves carry a leading batch
    axis (built by ``mc.dispersions``), consumed directly by ``vmap``,
  * sharding a run over a device mesh is a ``NamedSharding`` on those same
    leaves — no pickling, no process pool.
"""

from __future__ import annotations

from ..utils import struct

from .atmosphere import AtmosphereParams
from .motor import MotorParams
from .rocket import RocketParams
from .wind import WindField, WindModelParams

__all__ = ["Scene", "nominal_scene"]


@struct.dataclass
class Scene:
    rocket: RocketParams
    motor: MotorParams
    atmosphere: AtmosphereParams
    wind: WindField
    wind_model: WindModelParams


def nominal_scene(motor: MotorParams, wind: WindField | None = None) -> Scene:
    """Convenience constructor mirroring `example.py:16-23`."""
    return Scene(
        rocket=RocketParams.create(),
        motor=motor,
        atmosphere=AtmosphereParams.create(),
        wind=wind if wind is not None else WindField.zero(),
        wind_model=WindModelParams(),
    )
