"""LIO odometry: ESKF on the 24-dim manifold, IMU propagation and
preintegration, lidar preprocessing, the frame step, IMU-rate pose fusion."""

from . import eskf, fusion, imu, preintegration, preprocess, state
from .pipeline import LIOConfig, LIOFrame, LIOOutput, LIOState, create_state, lio_step, reset

__all__ = ["eskf", "fusion", "imu", "preintegration", "preprocess", "state", "LIOConfig", "LIOFrame", "LIOOutput", "LIOState",
           "create_state", "lio_step", "reset"]
