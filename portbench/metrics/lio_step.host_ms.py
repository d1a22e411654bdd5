"""Mean host time of one `lio_step` call over the window's frames: the
harness's span from the hand-off to the call's return, which comes once
the frame's work is queued (and after any read the call makes itself).
Closed-loop cells only."""

UNIT = "ms"


def read(run):
    if run.call_name != "lio_step" or run.loop != "closed" or not run.frames:
        return None
    return 1e3 * sum(f.returned - f.handed for f in run.frames) / len(run.frames)
