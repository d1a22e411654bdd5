"""Scheduling of the test suite under pytest-xdist.

`tests/conftest.py` sets the suite up (the CPU mesh, the `heavy` gate); this
file only decides the order in which test files are handed to the workers.
"""

# The heaviest test files, heaviest first: each file's summed test time in
# the junit of four whole tier-1 runs (`-n 6 --dist loadfile`, 8 cores),
# averaged; every file here took >= ~150 s. xdist hands these out first, so
# no worker starts one near the end of the run. A new test file above
# ~100 s goes in, at its place by time.
HEAVY_FILES_FIRST = (
    "test_registration.py",
    "test_liosam.py",
    "test_capacity.py",
    "test_slam.py",
    "test_parallel.py",
    "test_voxel_grid.py",
    "test_slam_async.py",
    "test_feature_localization.py",
    "test_hard_worlds.py",
    "test_lio.py",
    "test_torch_gicp.py",
    "test_tuning.py",
    "test_backend_oracle.py",
    "test_oracle_trajectory.py",
    "test_torch_register.py",
)


def pytest_configure(config):
    # xdist's default hands out files by their number of tests, which sends
    # heavy files of few tests out last; keep the order the items come in.
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(config, items):
    rank = {name: i for i, name in enumerate(HEAVY_FILES_FIRST)}
    items.sort(key=lambda item: rank.get(item.path.name, len(rank)))  # stable
