"""Kernel K6's share of its roofline (%): the least time its launches could
take (`harness/roofline.py`, from each launch's shapes as the traced frames
recorded them) over the device time the profiler gives the
`small_eigh_kernel` records in the same frames. The profiler may keep only
some of a short kernel's records, so the share is the mean bound a launch
over the mean time a kept record. Nothing when no K6 record is found."""

from portbench.harness.roofline import k6_bound_s

UNIT = "%"


def read(run):
    if not run.profile:
        return None
    times = run.profile["kernels"].get("k6") or []
    calls = run.kernel_calls.get("k6") or []
    if not times or not calls:
        return None
    bound = sum(k6_bound_s(*c)[0] for c in calls) / len(calls)
    return 100.0 * bound / (sum(times) / len(times))
