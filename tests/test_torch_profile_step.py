"""The port's ``tools/profile_step`` against the JAX tool
(``tools/profile_step.py``): the engine it builds, its tables on one
stand-in trace, its idle figures, its traced window and its command line.

The JAX tool needs a TPU trace to print anything, so it runs here with its
engine build, noise, rollout, profiler, ``glob`` and ``rm -rf`` stood in
for; it reads the stand-in trace as it would read its own."""

import dataclasses
import functools
import gzip
import json
import os
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_arpo_project_tpu.rollout import discrete as jdisc
from mpc_arpo_project_tpu_torch.ops import admm_eig
from mpc_arpo_project_tpu_torch.rollout import discrete as tdisc
from mpc_arpo_project_tpu_torch.tools import profile_step as ps
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from tools import profile_step as jtool

# the JAX tool's jax.config settings, restored after each of its runs
JAX_CONFIG = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_compile_time_secs")


class _Sentinel(Exception):
    pass


def _capture(store):
    def build_engine(*args, **kw):
        store.update(args=args, kw=kw)
        raise _Sentinel
    return build_engine


def _fake_jax_rollout(engine, noise, seg=10, progress=None):
    carry = types.SimpleNamespace(i_term=np.zeros(1))
    if progress is not None:
        for done in range(seg, 300 + 1, seg):
            progress(done, 300, carry)
    return types.SimpleNamespace(i_term=jnp.zeros(1))


@pytest.fixture
def jax_tool(monkeypatch, tmp_path):
    """Runs ``tools/profile_step.main`` with ``argv`` and its JAX cache
    under ``tmp_path``; restores the jax.config values it sets."""
    # compiled before the tool points the persistent cache at tmp_path, so
    # that this process never takes that cache up
    jax.block_until_ready(jnp.zeros(1) + 1)
    jax.block_until_ready(jax.random.fold_in(jax.random.key(0), 1))
    saved = {k: getattr(jax.config, k) for k in JAX_CONFIG}
    monkeypatch.setenv("JAX_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.delenv("BENCH_BATCH", raising=False)

    def run(argv):
        monkeypatch.setattr(sys, "argv", ["profile_step.py"] + argv)
        return jtool.main()

    yield run
    for k, v in saved.items():
        jax.config.update(k, v)


def _same(j, t, where="config"):
    """The JAX package's config object ``j`` equals the port's ``t``, field
    for field (dataclasses, dicts, sequences, arrays, numbers, strings)."""
    if dataclasses.is_dataclass(j):
        assert type(j).__name__ == type(t).__name__, where
        names = [f.name for f in dataclasses.fields(j)]
        assert names == [f.name for f in dataclasses.fields(t)], where
        for n in names:
            _same(getattr(j, n), getattr(t, n), f"{where}.{n}")
    elif isinstance(j, dict):
        assert j.keys() == t.keys(), where
        for k in j:
            _same(j[k], t[k], f"{where}[{k!r}]")
    elif isinstance(j, np.ndarray) or isinstance(t, np.ndarray):
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j),
                                      err_msg=where)
        assert np.shape(t) == np.shape(j), where
    elif isinstance(j, (tuple, list)):
        assert len(j) == len(t), where
        for i, (a, b) in enumerate(zip(j, t)):
            _same(a, b, f"{where}[{i}]")
    else:  # NaN equals NaN (the plant's T_cont when unset)
        np.testing.assert_equal(t, j, err_msg=where)


def test_engine_arguments_match_the_jax_tool(jax_tool, monkeypatch):
    jargs, targs = {}, {}
    monkeypatch.setattr(jdisc, "build_engine", _capture(jargs))
    with pytest.raises(_Sentinel):
        jax_tool([])
    monkeypatch.setattr(tdisc, "build_engine", _capture(targs))
    with pytest.raises(_Sentinel):
        ps.flagship_engine(1024, device="cpu")
    assert len(jargs["args"]) == len(targs["args"]) == 4
    for name, j, t in zip(("sim", "mpc", "fail", "debris"), jargs["args"],
                          targs["args"]):
        _same(j, t, name)
    jkw, tkw = jargs["kw"], targs["kw"]
    assert set(tkw) == set(jkw) | {"device"}
    assert tkw["settings"]._asdict() == jkw["settings"]._asdict()
    assert jkw["dtype"] == jnp.float32 and tkw["dtype"] == torch.float32
    assert tkw["device"] == torch.device("cpu")
    sim = targs["args"][0]
    assert (sim.T_final, sim.noise.noise_std, sim.noise.noise_length) == (
        150.0, (0.75, 0.75), 50)
    assert targs["args"][1].horizons["Nx"] == 50


# ---------------------------------------------------------------------------
# the stand-in trace
# ---------------------------------------------------------------------------

HOST, CARD = 1, 2


def _x(pid, tid, cat, name, ts, end):
    return dict(ph="X", pid=pid, tid=tid, cat=cat, name=name, ts=ts,
                dur=end - ts)


def _meta(pid, name):
    return dict(ph="M", name="process_name", pid=pid, tid=0,
                args=dict(name=name))


def _stand_in(annotation=False):
    """A trace of 1000 us: the host's ops on one track, the device's
    events on two streams of another (named so that the JAX tool's filter,
    a track name holding "device", takes it too) and the profiler's own
    span on a track without a name; with ``annotation``, a host annotation
    drawn on the device's track over the whole window too (the JAX tool
    would count it as a device op; the port counts it neither as host nor
    as device).

    Device (us): stream 7 runs [120, 300], [440, 500] and a copy [600,
    650]; stream 8 runs [130, 200] and [250, 350]. Busy is their union:
    [120, 350], [440, 500], [600, 650] = 340 us of 1000; the sum of the
    events is 460 us. The idle gaps, longest first: [650, 1000] under the
    profiler's own work inside aten::add (its midpoint 825), [0, 120] under
    cudaLaunchKernel (60), [500, 600] under no host op (550), [350, 440]
    under the innermost of aten::item > aten::_local_scalar_dense >
    cudaStreamSynchronize (395)."""
    long_name = "void eig_chunk_kernel<float, 8>(Args<float>)" + "_" * 100
    return [
        _meta(HOST, "python3"), _meta(CARD, "/device:GPU:0"),
        dict(ph="M", name="thread_name", pid=HOST, tid=11,
             args=dict(name="main")),
        _x(HOST, 11, "cpu_op", "aten::empty", 0, 5),
        _x(HOST, 11, "cuda_runtime", "cudaLaunchKernel", 40, 60),
        _x(HOST, 11, "cpu_op", "aten::item", 300, 520),
        _x(HOST, 11, "cpu_op", "aten::_local_scalar_dense", 310, 515),
        _x(HOST, 11, "cuda_runtime", "cudaStreamSynchronize", 320, 420),
        _x(HOST, 11, "cpu_op", "aten::mul", 700, 760),
        _x(HOST, 11, "cpu_op", "aten::add", 800, 850),
        _x(HOST, 11, "overhead", "Activity Buffer Request", 820, 830),
        _x(HOST, 11, "cuda_runtime", "cudaDeviceSynchronize", 960, 1000),
        _x(CARD, 7, "kernel", long_name, 120, 300),
        _x(CARD, 8, "kernel", "elementwise_kernel", 130, 200),
        _x(CARD, 8, "kernel", "elementwise_kernel", 250, 350),
        _x(CARD, 7, "gpu_memset", "Memset (Device)", 440, 500),
        _x(CARD, 7, "gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 600,
           650),
        _x("Spans", "PyTorch Profiler", "Trace", "PyTorch Profiler (0)", -50,
           1100),
        dict(ph="i", s="g", name="Record Window End", pid="", tid="",
             ts=1200),
    ] + ([_x(CARD, 7, "gpu_user_annotation", "step", 0, 1000)]
         if annotation else [])


@pytest.mark.parametrize("top", [40, 2])
def test_tables_match_the_jax_tool(jax_tool, monkeypatch, tmp_path, capsys,
                                   top):
    path = tmp_path / "stand_in.trace.json.gz"
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": _stand_in()}, fh)
    monkeypatch.setattr(jdisc, "build_engine", lambda *a, **k: None)
    monkeypatch.setattr(jdisc, "make_noise_sequence", lambda *a: None)
    monkeypatch.setattr(jdisc, "rollout_chunked", _fake_jax_rollout)
    calls = []
    monkeypatch.setattr(jax.profiler, "start_trace",
                        lambda *a, **k: calls.append("start"))
    monkeypatch.setattr(jax.profiler, "stop_trace",
                        lambda: calls.append("stop"))
    monkeypatch.setattr(jtool, "glob", types.SimpleNamespace(
        glob=lambda pat, recursive=False: [str(path)] if "json.gz" in pat
        else []))
    monkeypatch.setattr(os, "system", lambda cmd: calls.append(cmd))
    jax_tool(["--top", str(top)])
    assert calls == ["rm -rf /tmp/jxprof", "start", "stop"]
    printed = capsys.readouterr().out
    ps.print_tables(ps.aggregate(_stand_in(), 20, top))
    mine = capsys.readouterr().out
    assert mine == printed
    assert "/device:GPU:0" in mine and "elementwise_kernel" in mine


def test_idle_figures_are_exact():
    agg = ps.aggregate(_stand_in(annotation=True), 2, 40)
    dev = agg["device"]
    assert dev["window_ms"] == 1.0
    assert dev["busy_ms"] == 0.34
    assert dev["device_ms"] == 0.46
    assert dev["idle_share"] == pytest.approx(0.66, rel=0, abs=1e-15)
    assert dev["n_gaps"] == 4 and dev["n_events"] == 5
    assert dev["gaps"] == [(0.35, "profiler: Activity Buffer Request"),
                           (0.12, "cudaLaunchKernel"),
                           (0.1, "(no host op)"),
                           (0.09, "cudaStreamSynchronize")]
    assert dev["idle_by_host_op"] == [
        ("profiler: Activity Buffer Request", 0.175, 1),
        ("cudaLaunchKernel", 0.06, 1),
        ("(no host op)", 0.05, 1), ("cudaStreamSynchronize", 0.045, 1)]
    # the tables: the device's events by name, cut at 110 characters
    assert [(n[:20], c) for n, _, c in agg["ops"]] == [
        ("void eig_chunk_kerne", 1), ("elementwise_kernel", 2),
        ("Memset (Device)", 1), ("Memcpy DtoH (Device ", 1)]
    assert len(agg["ops"][0][0]) == 110
    assert ps.kernel_events(_stand_in(), "eig_chunk_kernel") == 1
    # a trace without device events (a CPU run) has no idle figures
    host_only = [e for e in _stand_in() if e.get("pid") != CARD]
    assert ps.aggregate(host_only, 2, 40)["device"] is None


def _spanned():
    """Two steps over 1000 us with the program's spans: step A [0, 410]
    (solve [50, 300] > chunk [100, 250] > read [200, 250]; bounds [320,
    380]) and step B [505, 910] (solve [520, 800] > chunk [540, 700] > read
    [680, 700]; read [750, 760] in the solve). Launches (host start ->
    device us): 20 -> 20, 60 -> 20, 110 -> 70, 210 -> 5 (a copy), 330 ->
    30, 425 (between the steps) -> 10, 550 -> 100, 690 -> 5 (a copy), 820
    -> 20; and a kernel of 10 at [950, 960] launched before the trace."""
    launches = [(20, 25, 45), (60, 70, 90), (110, 120, 190), (210, 215, 220),
                (330, 340, 370), (425, 430, 440), (550, 560, 660),
                (690, 690, 695), (820, 830, 850)]
    ev = []
    for corr, (ts, d0, d1) in enumerate(launches):
        ev.append(dict(_x(HOST, 11, "cuda_runtime", "cudaLaunchKernel", ts,
                          ts + 3), args=dict(correlation=corr)))
        cat = "gpu_memcpy" if d1 - d0 == 5 else "kernel"
        ev.append(dict(_x(CARD, 7, cat, "k", d0, d1),
                       args=dict(correlation=corr)))
    ev.append(dict(_x(CARD, 7, "kernel", "k", 950, 960),
                   args=dict(correlation=99)))
    ev.append(_x(HOST, 11, "cpu_op", "aten::empty", 990, 1000))
    for name, s, e in [
            ("loop.step", 0, 410), ("solve", 50, 300),
            ("solve.chunk", 100, 250), ("solve.read", 200, 250),
            ("step.bounds", 320, 380), ("loop.step", 505, 910),
            ("solve", 520, 800), ("solve.chunk", 540, 700),
            ("solve.read", 680, 700), ("solve.read", 750, 760)]:
        ev.append(_x(HOST, 11, "user_annotation", name, s, e))
        ev.append(_x(CARD, 7, "gpu_user_annotation", name, s, e))
    return ev


def test_span_table_on_a_synthetic_trace(capsys):
    """Per span a step: the count, the host self time (less the child
    spans), the device ms launched under it and the idle ms under it."""
    rows = ps.span_table(_spanned(), 2)
    want = [("loop.step", 1.0, 0.1125, 0.135, 0.275),
            ("solve", 1.0, 0.105, 0.1, 0.1825),
            ("solve.chunk", 1.0, 0.12, 0.09, 0.0425),
            ("solve.read", 1.5, 0.04, 0.005, 0.0125),
            ("step.bounds", 0.5, 0.03, 0.015, 0.0)]
    assert [r[0] for r in rows] == [w[0] for w in want]
    for r, w in zip(rows, want):
        assert r[1:] == pytest.approx(w[1:], abs=1e-12), r[0]
    # without device events the device columns are not measured
    host_only = [e for e in _spanned() if e["pid"] != CARD]
    rows = ps.span_table(host_only, 2)
    assert [r[3:] for r in rows] == [(None, None)] * 5
    ps.print_spans(rows, 2)
    out = capsys.readouterr().out
    assert "not measured" in out and "solve.read" in out
    assert ps.span_table(_stand_in(), 2) == []


class _StubProfiler:
    """Stands in for ``torch.profiler.profile``: records when it starts and
    stops and writes an empty trace."""

    log = None

    def __init__(self, activities):
        pass

    def __enter__(self):
        self.log.append("start")
        return self

    def __exit__(self, *exc):
        self.log.append("stop")

    def export_chrome_trace(self, path):
        with open(path, "w") as fh:
            json.dump({"traceEvents": []}, fh)


@pytest.mark.parametrize("start_seg", [6, 0])
def test_window_starts_and_stops_after_a_sync(monkeypatch, tmp_path,
                                              start_seg):
    log = []

    def rollout(engine, noise, seg, progress):
        for done in range(1, engine.nsim + 1):
            admm_eig.eig_chunk.launches += 3
            if done % seg == 0:
                log.append(done)
                progress(done, engine.nsim, None)

    monkeypatch.setattr(_StubProfiler, "log", log)
    monkeypatch.setattr(torch.profiler, "profile", _StubProfiler)
    monkeypatch.setattr(ps, "_sync", lambda device: log.append("sync"))
    monkeypatch.setattr(tdisc, "rollout_chunked", rollout)
    monkeypatch.setattr(admm_eig.eig_chunk, "launches", 0)
    engine = types.SimpleNamespace(nsim=150, device=torch.device("cpu"))
    prof = ps.profile(engine, None, start_seg=start_seg, log_dir=str(tmp_path))
    lo = 10 * start_seg
    if lo:
        i = log.index("start")
        assert log[i - 2:i] == [lo, "sync"]
    else:
        assert log[:2] == ["sync", "start"]
    i = log.index("stop")
    assert log[i - 2:i] == [lo + 20, "sync"]
    assert log.count("start") == log.count("stop") == 1
    assert prof.n_steps == 20 and prof.launches == {"eig_chunk": 60}
    assert prof.events == [] and prof.trace_s >= 0
    assert len(prof.seg_ms) == 15 and min(prof.seg_ms) >= 0
    assert prof.wall_s == pytest.approx(
        sum(prof.seg_ms[start_seg:start_seg + 2]) / 100, rel=1e-12)
    assert prof.path == str(tmp_path / "trace.json")
    with pytest.raises(ValueError):
        ps.profile(engine, None, start_seg=14, log_dir=str(tmp_path))


def test_cli_runs_on_the_cpu_and_refuses_without_a_card(monkeypatch,
                                                        tmp_path, capsys):
    """The command line end to end at B=4 on the CPU: 10 steps (T_final
    5 s), the first segment traced, the solver capped at one chunk of 25
    iterations a step so that the trace stays small."""
    build = tdisc.build_engine

    def capped(*a, settings, **k):
        return build(*a, settings=settings._replace(max_iter=25), **k)

    monkeypatch.setattr(tdisc, "build_engine", capped)
    monkeypatch.setattr(ps, "flagship_engine",
                        functools.partial(ps.flagship_engine, T_final=5.0))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc = ps.main(["--cpu", "--batch", "4", "--start-seg", "0", "--segs", "1",
                  "--top", "5"])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.startswith("device cpu\n")
    assert "== total X-event ms by process track ==" in out
    assert "python (CPU)" in out or "python3 (CPU)" in out
    assert "== device ops over 10 steps" in out
    assert "(no device events: a CPU run)" in out
    assert "== program spans over 10 steps" in out
    assert "loop.step" in out and "solve.chunk" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.main([])
