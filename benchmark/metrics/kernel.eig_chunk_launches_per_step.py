"""``eig_chunk`` launches a step over the traced span, from the kernel
wrapper's launch counter. Layer: the chunk kernel; each launch is one
chunk of 25 iterations on the live slots, and fewer, fuller launches move
the throughput."""

UNIT = "launches/step"


def read(run):
    t = run.trace
    if t is None or not t["launches"].get("eig_chunk"):
        return None
    return t["launches"]["eig_chunk"] / t["n_steps"]
