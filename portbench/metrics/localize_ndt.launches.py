"""CUDA kernel launches a frame inside the harness's span around each
`localize_ndt` call, counted from the profiler's runtime launch calls over
the traced frames."""

UNIT = "launches/frame"


def read(run):
    if run.call_name != "localize_ndt" or not run.profile or not run.profile["frames"]:
        return None
    return run.profile["launches"] / run.profile["frames"]
