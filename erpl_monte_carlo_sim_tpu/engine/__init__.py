"""Flight engine: rail phase, 6DOF RK4 integration, masked events."""

from .batch import simulate_flight_batch, simulate_summary_batch
from .config import SimConfig
from .diff import (apogee_and_grad, metric_and_grad, simulate_apogee_diff,
                   simulate_metrics_diff)
from .dynamics import rocket_dynamics
from .integrator import EventState, StepCarry, advance, init_carry, rk4_step
from .rail import RailInfo, simulate_rail
from .simulate import (FlightSummary, Trajectory, simulate_batch_chunked,
                       simulate_flight, simulate_summary)
from .state import FlightState, InitialConditions, initial_state

__all__ = [
    "SimConfig", "rocket_dynamics", "EventState", "StepCarry", "advance",
    "init_carry", "rk4_step", "RailInfo", "simulate_rail", "FlightSummary",
    "apogee_and_grad", "metric_and_grad", "simulate_apogee_diff",
    "simulate_metrics_diff",
    "Trajectory", "simulate_flight", "simulate_summary",
    "simulate_summary_batch", "simulate_flight_batch",
    "simulate_batch_chunked", "FlightState",
    "InitialConditions", "initial_state",
]
