"""Device idle a step inside the solve over the traced span: the idle gaps
whose midpoint lies in a ``solve`` span of the program (``arpobench.spans``).
With ``step.idle_ms_per_step`` and the idle outside every step it sums to
the span's idle. Layer: the solve and chunk loop; the host's launches and
reads of the chunk loop leave the card idle here."""

from arpobench import spans

UNIT = "ms"


def read(run):
    t = run.trace
    if t is None:
        return None
    idle = spans.idle_ms(t["events"])
    return None if idle is None else idle["solve"] / t["n_steps"]
