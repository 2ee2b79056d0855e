"""The program's spans (``utils.timing.span``) in a profiled closed loop on
the CPU: one ``loop.step`` (``loop.tick``) and one ``solve`` a step, every
span inside the one its layer nests in, a host read at least every chunk,
in each solve mode; the outputs bit-identical with the profiler on and off;
and with the profiler off no ``record_function`` at all."""

import json

import numpy as np
import pytest
import torch

from mpc_arpo_project_tpu_torch.config import Noise, SimConditions
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.rollout import continuous, discrete
from tests.torch_helpers import flagship_parts, sim_conditions
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

LOOP = ("loop.step", "loop.tick")
SOLVE_INNER = ("solve", "solve.setup", "solve.refresh", "solve.chunk")
# the span each span nests in directly (None: no program span)
PARENTS = {
    "loop.step": (None,), "loop.tick": (None,),
    "step.estimate": LOOP, "step.bounds": LOOP, "step.control": LOOP,
    "step.plant": LOOP, "solve": LOOP,
    "solve.setup": ("solve",), "solve.chunk": ("solve",),
    "solve.compact": ("solve",), "solve.finish": ("solve",),
    "solve.refresh": ("solve.setup", "solve.chunk"),
    "kernel.eig_chunk": ("solve.chunk",),
    "solve.read": SOLVE_INNER,
}
# (loop, solve mode, max_iter): two steps or ticks each, a few chunks
ARMS = {"discrete-eig": ("discrete", "eig", 100),
        "continuous-eig": ("continuous", "eig", 100),
        "discrete-chol": ("discrete", "chol", 50),
        "discrete-pallas": ("discrete", "pallas", 50)}


def _rollout(loop, mode, max_iter):
    """A closure running the arm's rollout: B=4, fp64, on the CPU; the
    continuous plant at 10 substeps a tick."""
    mpc, fail, debris = flagship_parts()
    st = admm.ADMMSettings(max_iter=max_iter, solve_mode=mode, pallas_tile=4)
    gen = torch.Generator().manual_seed(7)
    if loop == "continuous":
        sim = SimConditions(
            np.array([100.0, 10.0, 0.0, 0.0]), np.array([2.5, 0.0, 0.0, 0.0]),
            2.5, 10 * np.pi / 180, 1.5, 1.107e-3, 0.5, True, (0.2, 45.0),
            Noise((0.0012, 0.0012), 50), False, T_cont=0.05, T_final=1.5)
        eng = continuous.build_engine(sim, mpc, fail, debris, settings=st,
                                      dtype=torch.float64, device="cpu")
        draws = continuous.make_noise_draws(eng, gen, 4)
        return lambda: continuous.rollout(eng, draws)
    sim = sim_conditions(noise=Noise((0.4, 0.4), 20), T_final=1.0)
    eng = discrete.build_engine(sim, mpc, fail, debris, settings=st,
                                dtype=torch.float64, device="cpu")
    noise = discrete.make_noise_sequence(eng, gen, 4)
    return lambda: discrete.rollout(eng, noise)


def _refuse(name):
    raise AssertionError(f"record_function({name!r}) with no profiler")


@pytest.fixture(scope="module", params=sorted(ARMS))
def arm(request, tmp_path_factory):
    """(name, outputs with the profiler off, outputs and program spans
    (start, end, name) with it on)."""
    run = _rollout(*ARMS[request.param])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _refuse)
        off = run()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = run()
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"),
                   key=lambda sp: (sp[0], -sp[1]))
    return request.param, off, on, spans


def test_outputs_identical_with_the_profiler_on_and_off(arm):
    _, off, on, _ = arm
    for name, a, b in zip(off._fields, off, on):
        if a is None:
            assert b is None, name
        else:
            assert torch.equal(a, b), name


def test_a_loop_span_and_a_solve_a_step(arm):
    name, off, _, spans = arm
    count = {n: sum(1 for *_, m in spans if m == n) for n in PARENTS}
    loop = "loop.tick" if name.startswith("continuous") else "loop.step"
    n_steps = off.status.shape[0]
    assert n_steps == 2
    assert count[loop] == count["solve"] == n_steps
    for n in ("step.estimate", "step.bounds", "step.control", "step.plant"):
        assert count[n] == n_steps, n
    assert count["solve.chunk"] >= n_steps
    assert count["solve.read"] >= count["solve.chunk"]
    if name.endswith("eig"):
        assert count["solve.setup"] == count["solve.finish"] == n_steps
        assert count["solve.compact"] >= 1 and count["solve.refresh"] >= 1
    else:
        assert count["solve.setup"] == count["solve.compact"] == 0
    assert {m for *_, m in spans} <= set(PARENTS)


def test_every_span_nests_in_its_layer(arm):
    _, _, _, spans = arm
    stack = []
    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        parent = stack[-1] if stack else None
        assert (parent and parent[2]) in PARENTS[name], (name, parent)
        if parent:
            assert parent[0] <= s and e <= parent[1], (name, parent)
        stack.append((s, e, name))
