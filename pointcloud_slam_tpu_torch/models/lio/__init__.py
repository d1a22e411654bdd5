"""LIO odometry: ESKF on the 24-dim manifold, IMU propagation, the frame step."""

from . import eskf, imu, state
from .pipeline import LIOConfig, LIOFrame, LIOOutput, LIOState, create_state, lio_step, reset

__all__ = ["eskf", "imu", "state", "LIOConfig", "LIOFrame", "LIOOutput", "LIOState",
           "create_state", "lio_step", "reset"]
