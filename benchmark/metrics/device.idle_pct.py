"""The share of the traced span in which no operation ran on the device:
100 (1 - busy / window), busy the union of the device's events over all
streams (``arpobench.trace``). The profiler stretches the host's side of a
step, so this is a traced-run number. Layer: the device (one H100)."""

UNIT = "%"


def read(run):
    t = run.trace
    if t is None or t["agg"]["device"] is None:
        return None
    return 100.0 * t["agg"]["device"]["idle_share"]
