"""The precision control, put in the program's place, comes out not
correct, and so does a run with the timed path broken underneath: a step
that returns its state unchanged, half of the batch left out, and an answer
altered where it is produced (the UKF's estimate; the solver's answer
negated or zeroed, its status forced to SOLVED, or the solve given up
early). One chip: there is no exchange between chips to leave out."""

import numpy as np
import pytest
import torch

from harness_helpers import cpu_run, small_cell
from test_harness_reference import run  # noqa: F401 (fixture)

from arpobench.reference import compare
from mpc_arpo_project_tpu_torch.ops import admm, ukf
from mpc_arpo_project_tpu_torch.rollout import continuous, discrete


def test_the_precision_control_fails(run):  # noqa: F811
    sc, smp, limits = run
    ours = compare.compare(sc, smp)
    ctl = compare.compare(sc, compare.control_outputs(sc, smp))
    assert not compare.verdict(ctl, limits)
    # it fails the plant's number and the solve's, and reads far above the
    # program there
    for k in ("plant", "solve", "solve_u"):
        assert not ctl[k] <= limits[k], k
        assert not ctl[k] <= 3 * ours[k], k


def test_a_run_reads_the_control():
    """``--control`` of a run: the control's readings fail beside a correct
    run, and the checks come last."""
    line, _ = cpu_run(small_cell("flagship_radial.b1024_h20"), control=True)
    assert line["correct"] is True
    assert line["control"]["correct"] is False
    assert list(line)[-1] == "checks"


def _unchanged(step):
    def wrapped(engine, carry, *a, **k):
        _, out = step(engine, carry, *a, **k)
        return carry, out
    return wrapped


def _half_batch(step):
    def wrapped(engine, carry, *a, **k):
        new, out = step(engine, carry, *a, **k)
        B = carry.alive.shape[0]
        keep = torch.arange(B) >= B // 2

        def mix(n, o):
            if not torch.is_tensor(n) or n.dim() == 0 or n.shape[0] != B:
                return n
            return torch.where(keep.reshape((B,) + (1,) * (n.dim() - 1)), o, n)
        st = type(new.admm_state)(*(mix(n, o) for n, o in zip(
            new.admm_state, carry.admm_state)))
        fields = [mix(n, o) for n, o in zip(new, carry)]
        fields[list(new._fields).index("admm_state")] = st
        return type(new)(*fields), out
    return wrapped


def _estimate_altered(step):
    """The UKF with two metres added to the x position it estimates."""
    def wrapped(*a, **k):
        st = step(*a, **k)
        return st._replace(x=st.x + torch.tensor(
            [2.0, 0, 0, 0, 0, 0], dtype=st.x.dtype, device=st.x.device))
    return wrapped


def _answer(change):
    """The solver's result with its answer changed by ``change(x)`` where it
    is produced: the unscaled solution and the iterates it carries."""
    def fault(solve):
        def wrapped(*a, **k):
            res = solve(*a, **k)
            st = res.state
            return res._replace(x=change(res.x), state=st._replace(
                xbar=change(st.xbar), ybar=change(st.ybar),
                zbar=change(st.zbar)))
        return wrapped
    return fault


def _forced_solved(solve):
    def wrapped(*a, **k):
        res = solve(*a, **k)
        return res._replace(status=torch.full_like(res.status, admm.SOLVED))
    return wrapped


def _given_up(solve):
    """MAX_ITER after one check, whatever the solve reached."""
    def wrapped(*a, **k):
        res = solve(*a, **k)
        every = a[5].check_every if len(a) > 5 else k["settings"].check_every
        return res._replace(
            status=torch.full_like(res.status, admm.MAX_ITER),
            done_iters=torch.full_like(res.done_iters, every))
    return wrapped


SOLVE_FAULTS = {
    "answer_negated": _answer(lambda t: -t),
    "answer_zeroed": _answer(torch.zeros_like),
    "status_forced_solved": _forced_solved,
    "solve_given_up": _given_up,
}

FAULTS = {
    "state_unchanged": lambda mp, loop: mp.setattr(
        loop, *(("_tick", _unchanged(loop._tick)) if loop is continuous
                else ("_step", _unchanged(loop._step)))),
    "half_batch": lambda mp, loop: mp.setattr(
        loop, *(("_tick", _half_batch(loop._tick)) if loop is continuous
                else ("_step", _half_batch(loop._step)))),
    "estimate_altered": lambda mp, loop: mp.setattr(
        ukf, "step", _estimate_altered(ukf.step)),
    **{name: (lambda mp, loop, f=f: mp.setattr(
        admm, "admm_solve", f(admm.admm_solve)))
       for name, f in SOLVE_FAULTS.items()},
}


# a status forced to SOLVED changes a run only where a solve ends otherwise:
# the small radialC window solves every QP
CASES = [(name, fault) for name in ("flagship_radial.b1024_h20",
                                    "radialC.b1024_t70")
         for fault in sorted(FAULTS)
         if (name, fault) != ("radialC.b1024_t70", "status_forced_solved")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    loop = continuous if name.startswith("radialC") else discrete
    FAULTS[fault](monkeypatch, loop)
    line, check_lines = cpu_run(small_cell(name))
    assert line["correct"] is False, check_lines
