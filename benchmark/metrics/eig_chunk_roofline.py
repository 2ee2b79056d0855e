"""``eig_chunk``'s share of its roofline over the traced span: the
operations the span's alive solves need in the kernel (each solve's
iterations and the end of each chunk it ran, ``arpobench.counts``) at the
published 67 TFLOP/s of float32, over the kernel's device time in the
trace. Bound by operations: the bytes a chunk needs take less time at
3.35 TB/s. Layer: the chunk kernel (``ops/admm_eig.py`` ->
``csrc/eig_chunk.cu``)."""

from arpobench import counts, trace

UNIT = "%"


def read(run):
    t = run.trace
    if t is None or t["span_done"] is None or not run.sizes:
        return None
    ms = trace.kernel_ms(t["events"], "eig_chunk_kernel")
    if ms <= 0:
        return None
    s = run.sizes
    ops = counts.eig_chunk_ops(t["span_done"], counts.eig_chunk_terms(
        s["m"], s["nz"], s["K"], s["gw"]))
    return 100.0 * ops / counts.PEAK_FP32 / (ms / 1e3)
