"""Synchronizing operations a frame inside `lio_step` (the device -> host
reads that stall the host's launch queue), counted by the CUDA sync
debugger over frames after the traced ones; the harness's pose read lies
outside the count."""

UNIT = "syncs/frame"


def read(run):
    if run.call_name != "lio_step" or run.syncs is None:
        return None
    return run.syncs
