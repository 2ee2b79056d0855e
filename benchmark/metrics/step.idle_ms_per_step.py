"""Device idle a step inside a step but outside its solve over the traced
span: the idle gaps whose midpoint lies in a ``loop.*`` span of the
program and in no ``solve`` span (``arpobench.spans``). Layer: the
closed loop (the step's estimator, bounds, controller and plant, and the
host's work between them)."""

from arpobench import spans

UNIT = "ms"


def read(run):
    t = run.trace
    if t is None:
        return None
    idle = spans.idle_ms(t["events"])
    return None if idle is None else idle["step"] / t["n_steps"]
