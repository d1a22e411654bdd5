"""Process start to the first timed frame: imports and the card's
start-up, the kernel library's build or load, the traffic's generation,
the maps and the set-up sweeps (host clock)."""

UNIT = "s"


def read(run):
    return run.setup_s
