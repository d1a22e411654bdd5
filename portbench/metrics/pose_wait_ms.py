"""Mean time from the pipeline call's return to the pose on the host, over
the window's frames: the device work left when the host has queued the
frame, plus the copy. Closed-loop cells only."""

UNIT = "ms"


def read(run):
    if run.loop != "closed" or not run.frames:
        return None
    return 1e3 * sum(f.pose - f.returned for f in run.frames) / len(run.frames)
