"""The `hall_lap` generator: `make_box_world`'s hall, a sensor walking a
closed elliptical lap in it with a gait's sway, and the sweeps, IMU samples
and prior map it records (`harness/world.py` holds the arithmetic).

A traffic mix names its generator (`"generator"` in `traffic/<mix>.json`),
and the pipelines reach the world and the walk only through that module, so
a mix of another world or another walk (a tiled campus, a traverse, a
teleport) is a new `generators/<name>.py` with these functions and a new
`traffic/<mix>.json`, and no file that is there changes:

- `world(traffic)`: the scene the rays are cast in;
- `path(traffic, seed)`: the walk, with the seed's start and direction;
- `period_s(path)`: the time after which the walk repeats itself;
- `imu_state(path, t)`, `lidar_pose(path, sensor, t)`: the true poses;
- `sweeps(world, path, sensor, t_start, sweep_s, deskewed, gen)`,
  `imu_samples(path, t_start, sweep_s, per_sweep)`: what the sensors record;
- `prior_map(world, density_per_m2, noise_m, gen, device)`: a surveyed map.
"""

from portbench.harness import world as W

imu_state = W.imu_state
lidar_pose = W.lidar_pose
sweeps = W.sweeps
imu_samples = W.imu_samples
prior_map = W.prior_map


def world(traffic: dict):
    return W.make_box_world(traffic["hall_seed"])


def path(traffic: dict, seed: int) -> W.Lap:
    return W.make_lap(traffic, seed)


def period_s(path: W.Lap) -> float:
    return path.period_s
