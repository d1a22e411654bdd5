"""Share of the window's time a frame in which no operation ran on the
device: 100 (1 - busy / wall), busy the union of the device intervals a
frame in the profiler's trace (the traced frames after the window), wall the
unprofiled window's time a frame (the profiler slows the host, not the
device's work). Closed-loop cells."""

UNIT = "%"


def read(run):
    if run.loop != "closed" or not run.profile or not run.profile["frames"] or not run.frames:
        return None
    busy = run.profile["busy_s"] / run.profile["frames"]
    wall = (run.frames[-1].pose - run.window_start) / len(run.frames)
    return 100.0 * (1.0 - busy / wall)
