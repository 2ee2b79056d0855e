"""Device time a step of the kernels, copies and sets launched inside a
``loop.*`` span of the program and outside its ``solve``, other than
``rk4_tick``, over the traced span (``arpobench.spans``): the step's
glue (the estimator, the bounds, the controller, the plant, the freeze of
dead scenarios). Layer: the step and chunk-loop glue, its step part."""

from arpobench import spans

UNIT = "ms"


def read(run):
    t = run.trace
    if t is None:
        return None
    glue = spans.glue_ms(t["events"])
    return None if glue is None else glue["step"] / t["n_steps"]
