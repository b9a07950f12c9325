"""Flight state and initial-condition pytrees.

The reference packs a 14-vector ``[pos(3), vel(3), quat(4 wxyz), omega(3),
prop_frac]`` (`simulator.py:130-161`). We keep the same physical content in a
named struct — identical memory under vmap ([B,3]/[B,4] leaves), clearer
code, and event flags live OUTSIDE the integrated state (they are carried by
the integrator as masks, per SURVEY.md §7's branch-free state-machine design).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import struct
from ..ops.quaternion import euler_to_quaternion

__all__ = ["FlightState", "InitialConditions", "initial_state"]


@struct.dataclass
class FlightState:
    position: jnp.ndarray  # [3] inertial ENU-ish, z up
    velocity: jnp.ndarray  # [3] inertial
    quaternion: jnp.ndarray  # [4] wxyz, body->inertial
    angular_velocity: jnp.ndarray  # [3] body
    propellant_fraction: jnp.ndarray  # scalar

    def __mul__(self, k):
        return FlightState(
            self.position * k, self.velocity * k, self.quaternion * k,
            self.angular_velocity * k, self.propellant_fraction * k,
        )

    __rmul__ = __mul__

    def __add__(self, other: "FlightState"):
        return FlightState(
            self.position + other.position,
            self.velocity + other.velocity,
            self.quaternion + other.quaternion,
            self.angular_velocity + other.angular_velocity,
            self.propellant_fraction + other.propellant_fraction,
        )


@struct.dataclass
class InitialConditions:
    """Launch initial conditions (`simulator.py:131-161` defaults).

    ``attitude`` is intrinsic-xyz Euler [roll, pitch, yaw]; a vertical launch
    is pitch ~ -pi/2 (body +x maps to inertial +z). See `example.py:34-39`.
    """

    position: jnp.ndarray
    velocity: jnp.ndarray
    attitude: jnp.ndarray
    angular_velocity: jnp.ndarray

    @classmethod
    def create(cls, position=(0.0, 0.0, 0.0), velocity=(0.0, 0.0, 0.0),
               attitude=(0.0, 0.0, 0.0), angular_velocity=(0.0, 0.0, 0.0),
               dtype=None) -> "InitialConditions":
        mk = lambda v: jnp.asarray(v, dtype=dtype)
        return cls(mk(position), mk(velocity), mk(attitude), mk(angular_velocity))

    @classmethod
    def vertical_launch(cls, altitude=10.0, pitch_offset=0.02, dtype=None
                        ) -> "InitialConditions":
        """The canonical example ICs (`example.py:34-39`)."""
        return cls.create(
            position=(0.0, 0.0, altitude),
            attitude=(0.0, -jnp.pi / 2 + pitch_offset, 0.0),
            dtype=dtype,
        )


def initial_state(ic: InitialConditions) -> FlightState:
    """Build the t=0 state: full propellant, quaternion from Euler ICs.

    Shape-polymorphic (``[..., i]`` component indexing) so it runs per-lane
    under vmap AND on an already-batched [B] lane axis.
    """
    quat = euler_to_quaternion(
        ic.attitude[..., 0], ic.attitude[..., 1], ic.attitude[..., 2]
    )
    return FlightState(
        position=ic.position,
        velocity=ic.velocity,
        quaternion=quat,
        angular_velocity=ic.angular_velocity,
        propellant_fraction=jnp.ones_like(ic.position[..., 0]),
    )
