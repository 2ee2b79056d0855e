"""Device time a step of every operation other than the two hand-written
kernels (``eig_chunk``, ``rk4_tick``): torch's glue kernels of the step
(``rollout/*``, ``ops/constraints.py``, ``ops/ukf.py``) and of the chunk
loop (``ops/admm.py``), copies and sets, from the trace. Layer: the step and
chunk-loop glue."""

from arpobench import trace

UNIT = "ms"


def read(run):
    t = run.trace
    if t is None or t["agg"]["device"] is None:
        return None
    hand = (trace.kernel_ms(t["events"], "eig_chunk_kernel")
            + trace.kernel_ms(t["events"], "rk4_tick_kernel"))
    return (t["agg"]["device"]["device_ms"] - hand) / t["n_steps"]
