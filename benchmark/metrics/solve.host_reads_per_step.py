"""Device-to-host reads a step of the solve over the traced span: the
program's ``solve.read`` spans (one a chunk of the chunk loop, and those of
the refresh decisions and the solve's set-up) over the span's steps.
Layer: the solve and chunk loop; each read holds the host until the card
has caught up, and a device-side chunk loop has fewer."""

from arpobench import spans

UNIT = "reads/step"


def read(run):
    t = run.trace
    if t is None:
        return None
    n = spans.count(t["events"], "solve.read")
    return None if n is None else n / t["n_steps"]
