"""Frames whose pose reached the host inside the window, over the window's
seconds (host clock)."""

UNIT = "frames/s"


def read(run):
    end = run.window_end()
    done = sum(f.pose <= end for f in run.frames)
    return done / run.seconds
