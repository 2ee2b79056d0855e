"""The whole traced span's share of the card's float32 peak: the operations
the span's alive solves need in ``eig_chunk`` (nearly all of a step's
arithmetic), at the published 67 TFLOP/s, over the span's length on the
trace's clock. It bounds ``eig_chunk_roofline`` from the step's side: a
change that takes work off the kernel without shortening the step does not
raise it. Layer: the device (one H100)."""

from arpobench import counts

UNIT = "%"


def read(run):
    t = run.trace
    if t is None or t["span_done"] is None or not run.sizes:
        return None
    dev = t["agg"]["device"]
    if dev is None or dev["window_ms"] <= 0:
        return None
    s = run.sizes
    ops = counts.eig_chunk_ops(t["span_done"], counts.eig_chunk_terms(
        s["m"], s["nz"], s["K"], s["gw"]))
    return 100.0 * ops / counts.PEAK_FP32 / (dev["window_ms"] / 1e3)
