"""The span metrics (``arpobench.spans`` and the five readers of the
program's spans) on a synthetic trace: their values, the idle and the glue
split into the solve, the step and what lies outside every step, each
summing to the whole, and no reading from a trace without the spans."""

import pytest

from harness_helpers import BENCH  # noqa: F401 (puts arpobench on the path)

from arpobench import cells, harness, spans, trace

HOST, CARD = 1, 2
N_STEPS = 2
NEW = ("solve.host_reads_per_step", "solve.idle_ms_per_step",
       "step.idle_ms_per_step", "solve.glue_device_ms_per_step",
       "step.glue_device_ms_per_step")


def _x(pid, cat, name, ts, end, corr=None):
    e = dict(ph="X", pid=pid, tid=pid, cat=cat, name=name, ts=ts,
             dur=end - ts)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic(with_spans=True):
    """Two steps over 1000 us. Spans: step A [0, 410] with its solve
    [50, 300] (a chunk [100, 250] holding a read [200, 250]) and its bounds
    [320, 380]; step B [505, 910] with its solve [520, 800] (a chunk
    [540, 700] holding a read [680, 700], and a read [750, 760]). Launches
    (correlation: host start -> device event, us): 5: 20 -> mul 20; 1: 60
    -> glue 20; 2: 110 -> eig_chunk 70; 3: 210 -> copy 5; 4: 330 -> where
    30; 6: 425 (between the steps) -> cat 10; 7: 550 -> eig_chunk 100; 8:
    690 -> copy 5; 9: 820 -> rk4_tick 20; and a kernel of 10 with no launch
    in the trace. Busy 290 us, idle 710: solve 365, step 185, outside 160.
    Glue (less the hand kernels): solve 30, step 50, outside 20."""
    host = [
        _x(HOST, "cuda_runtime", "cudaLaunchKernel", 20, 23, 5),
        _x(HOST, "cuda_runtime", "cudaLaunchKernel", 60, 63, 1),
        _x(HOST, "cuda_driver", "cuLaunchKernel", 110, 113, 2),
        _x(HOST, "cuda_runtime", "cudaMemcpyAsync", 210, 213, 3),
        _x(HOST, "cuda_runtime", "cudaLaunchKernel", 330, 333, 4),
        _x(HOST, "cpu_op", "aten::cat", 420, 430),
        _x(HOST, "cuda_runtime", "cudaLaunchKernel", 425, 428, 6),
        _x(HOST, "cuda_runtime", "cudaLaunchKernel", 550, 553, 7),
        _x(HOST, "cuda_runtime", "cudaMemcpyAsync", 690, 693, 8),
        _x(HOST, "cuda_runtime", "cudaLaunchKernel", 820, 823, 9),
        _x(HOST, "cpu_op", "aten::empty", 990, 1000),
        _x("Spans", "Trace", "PyTorch Profiler (0)", -50, 1100),
    ]
    device = [
        _x(CARD, "kernel", "mul_kernel", 25, 45, 5),
        _x(CARD, "kernel", "elementwise_kernel", 70, 90, 1),
        _x(CARD, "kernel", "void eig_chunk_kernel<float, 1>", 120, 190, 2),
        _x(CARD, "gpu_memcpy", "Memcpy DtoH", 215, 220, 3),
        _x(CARD, "kernel", "where_kernel", 340, 370, 4),
        _x(CARD, "kernel", "cat_kernel", 430, 440, 6),
        _x(CARD, "kernel", "void eig_chunk_kernel<float, 8>", 560, 660, 7),
        _x(CARD, "gpu_memcpy", "Memcpy DtoH", 690, 695, 8),
        _x(CARD, "kernel", "rk4_tick_kernel", 830, 850, 9),
        _x(CARD, "kernel", "stray_kernel", 950, 960, 99),
    ]
    program = [
        ("loop.step", 0, 410), ("solve", 50, 300), ("solve.chunk", 100, 250),
        ("solve.read", 200, 250), ("step.bounds", 320, 380),
        ("loop.step", 505, 910), ("solve", 520, 800),
        ("solve.chunk", 540, 700), ("solve.read", 680, 700),
        ("solve.read", 750, 760)]
    marks = [_x(HOST, "user_annotation", n, s, e) for n, s, e in program]
    # the profiler draws each span on the device's track too
    drawn = [_x(CARD, "gpu_user_annotation", n, s, e) for n, s, e in program]
    return host + device + (marks + drawn if with_spans else [])


def view(events):
    t = dict(events=events, n_steps=N_STEPS, launches={"eig_chunk": 2},
             agg=trace.aggregate(events, N_STEPS, 40), span_done=None)
    return harness.RunView({}, t, None, None)


def test_the_parts_of_the_idle_and_the_glue():
    ev = synthetic()
    assert spans.idle_ms(ev) == pytest.approx(
        dict(solve=0.365, step=0.185, outside=0.16), abs=1e-12)
    assert spans.glue_ms(ev) == pytest.approx(
        dict(solve=0.03, step=0.05, outside=0.02), abs=1e-12)
    assert spans.count(ev, "solve.read") == 3
    assert spans.count(ev, "solve.chunk") == 2


def test_the_readers_values_and_their_sums():
    run = view(synthetic())
    readers = cells.metric_readers()
    got = {n: readers[n].read(run) for n in NEW}
    assert got == pytest.approx({
        "solve.host_reads_per_step": 1.5,
        "solve.idle_ms_per_step": 0.1825, "step.idle_ms_per_step": 0.0925,
        "solve.glue_device_ms_per_step": 0.015,
        "step.glue_device_ms_per_step": 0.025}, abs=1e-12)
    # the idle: the parts sum to the traced span's idle a step
    d = run.trace["agg"]["device"]
    idle = readers["device.idle_pct"].read(run) / 100 * d["window_ms"]
    outside = spans.idle_ms(run.trace["events"])["outside"]
    assert (got["solve.idle_ms_per_step"] + got["step.idle_ms_per_step"]
            + outside / N_STEPS) == pytest.approx(idle / N_STEPS, rel=1e-12)
    # the glue: the parts sum to glue.device_ms_per_step
    outside = spans.glue_ms(run.trace["events"])["outside"]
    assert (got["solve.glue_device_ms_per_step"]
            + got["step.glue_device_ms_per_step"] + outside / N_STEPS) == \
        pytest.approx(readers["glue.device_ms_per_step"].read(run), rel=1e-12)


def test_no_spans_no_reading():
    run = view(synthetic(with_spans=False))
    readers = cells.metric_readers()
    assert all(readers[n].read(run) is None for n in NEW)
    # the parent's other readers still read the same trace
    assert readers["glue.device_ms_per_step"].read(run) == pytest.approx(
        0.05, abs=1e-12)
    # a trace with the spans but no device event: reads, no device figures
    host_only = [e for e in synthetic() if e["pid"] != CARD]
    assert spans.count(host_only, "solve.read") == 3
    assert spans.idle_ms(host_only) is None
    assert spans.glue_ms(host_only) is None
