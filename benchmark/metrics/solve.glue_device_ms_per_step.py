"""Device time a step of the kernels, copies and sets launched inside a
``solve`` span of the program, other than ``eig_chunk``, over the traced
span (``arpobench.spans``): the chunk loop's torch glue, the Woodbury
refresh, the compaction, the set-up and the scatter back. With
``step.glue_device_ms_per_step`` and what is launched outside every step it
sums to ``glue.device_ms_per_step``. Layer: the step and chunk-loop glue,
its chunk-loop part."""

from arpobench import spans

UNIT = "ms"


def read(run):
    t = run.trace
    if t is None:
        return None
    glue = spans.glue_ms(t["events"])
    return None if glue is None else glue["solve"] / t["n_steps"]
