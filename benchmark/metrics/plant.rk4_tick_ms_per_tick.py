"""``rk4_tick``'s device time a tick over the traced span, from the trace:
the 500 RK4 substeps of the two-body plant between two control ticks.
Layer: the plant tick kernel (``ops/rk4_tick.py`` -> ``csrc/rk4_tick.cu``);
read only where the span launched it (the continuous loop)."""

from arpobench import trace

UNIT = "ms"


def read(run):
    t = run.trace
    if t is None or not t["launches"].get("rk4_tick"):
        return None
    return trace.kernel_ms(t["events"], "rk4_tick_kernel") / t["n_steps"]
