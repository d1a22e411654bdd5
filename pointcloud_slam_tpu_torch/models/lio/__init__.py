"""LIO odometry: ESKF on the 24-dim manifold, IMU propagation and
preintegration, the frame step."""

from . import eskf, imu, preintegration, state
from .pipeline import LIOConfig, LIOFrame, LIOOutput, LIOState, create_state, lio_step, reset

__all__ = ["eskf", "imu", "preintegration", "state", "LIOConfig", "LIOFrame", "LIOOutput", "LIOState",
           "create_state", "lio_step", "reset"]
