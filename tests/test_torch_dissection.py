"""The sigma=0.01 docking-gap dissection tools of the port
(``mpc_arpo_project_tpu_torch/tools/first_divergence.py`` and
``probe_stall.py``) and the 'near' rho rescue, against the JAX package on
the CPU, on the JAX package's recorded captures in ``artifacts/``:

* ``compare`` of ``fd_prod_r5.npz`` (production on the TPU) and
  ``fd_oracle_r5.npz`` (the fp64 oracle on its 45 gap columns): the same
  records as the JAX tool's; a file of the oracle's columns compares
  with itself column by column, and ``summary`` reads its counts;
* ``resolve`` of a 4-row slice of the step-65 capture (the captured
  scenario and three recorded MAX_ITER rows): fp64 'chol' statuses and
  iterations equal to the JAX tool's, fp32 'eig' statuses equal;
* ``analyze`` of ``stall_probe_r5.npz``: the fp64 'chol' statuses and
  iterations of the JAX tool and of ``probe_analyze_r5.log``, the fp32
  'eig' statuses of both;
* a capture written by the port has the JAX tools' keys and dtypes, and
  re-solved it gives its recorded statuses on every alive row;
* 'near' in fp64 on the fixture of ``tests/test_admm_eig.py`` at the
  production stall settings: statuses and ``done_iters`` equal to the JAX
  package's, and another outcome than 'dual' on a row; on 8 recorded
  MAX_ITER rows of the step-67 capture (the primal-plateau class 'near'
  was built for) the fp32 SOLVED count within one of the JAX package's.
"""

import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.tools import first_divergence as tfd
from mpc_arpo_project_tpu_torch.tools import probe_stall as tps
from tests.test_admm_eig import _build_setup
from tools import first_divergence as jfd
from tools import probe_stall as jps
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "artifacts")
STALL_LOG = os.path.join(ART, "probe_analyze_r5.log")


def _slice(path, rows, **extra):
    """The batch fields of a full capture at ``rows``."""
    d = np.load(path)
    out = {k: d[k][rows] if d[k].ndim and d[k].shape[0] == d["l"].shape[0]
           else d[k] for k in d.files}
    out.update(extra)
    return out


def test_compare_matches_jax(capsys):
    prod, oracle = (os.path.join(ART, f) for f in ("fd_prod_r5.npz",
                                                   "fd_oracle_r5.npz"))
    got, ref = tfd.compare(prod, oracle), jfd.compare(prod, oracle)
    capsys.readouterr()
    assert got == ref
    assert len(got) == 45 and sum(r["oracle_success"] for r in got) == 36
    assert tfd.flip_kinds(got)["prod=MAX_ITER where oracle=SOLVED"] == 32
    # another arm's file of the oracle's columns compares column by column
    assert tfd.flip_kinds(tfd.compare(oracle, oracle)) == {
        "identical-status-sequences": 45}
    rep = tfd.summary(oracle)
    assert (rep["runs"], rep["n_success"], rep["alive_steps"]) == (45, 36,
                                                                  7586)
    capsys.readouterr()


_RESOLVE_LINE = re.compile(r"^(fp32 eig|fp64 chol) \(\w+\) scen (\d+): "
                           r"status (\w+) iters (\d+)", re.M)


@pytest.fixture(scope="module")
def cap65_slice(tmp_path_factory):
    """The captured scenario and three recorded MAX_ITER rows of the
    step-65 capture, as a capture file of four rows."""
    d = np.load(os.path.join(ART, "fd_cap65_r5.npz"))
    scen = int(d["scen"])
    mi = [int(r) for r in np.nonzero(d["alive"] & (d["status"] == 2))[0]
          if r != scen][:3]
    path = str(tmp_path_factory.mktemp("cap") / "cap65_4.npz")
    np.savez(path, **_slice(os.path.join(ART, "fd_cap65_r5.npz"),
                            [scen] + mi, scen=np.asarray(0)))
    return path


def test_resolve_matches_jax(cap65_slice, capsys):
    got = tfd.resolve(cap65_slice, "cpu")
    capsys.readouterr()
    jfd.resolve(cap65_slice)
    ref = {}
    for arm, b, status, iters in _RESOLVE_LINE.findall(capsys.readouterr().out):
        ref.setdefault(arm, {})[int(b)] = (status, int(iters))
    assert got["rows"] == [0, 1, 2, 3]
    assert [ref["fp64 chol"][b] for b in got["rows"]] == list(
        zip(got["fp64 chol"]["status"], got["fp64 chol"]["iters"]))
    assert [ref["fp32 eig"][b][0] for b in got["rows"]] == \
        got["fp32 eig"]["status"]
    # the fp64 evaluation of the fp32 iterate: finite, one per row
    ev = got["fp64 re-evaluation of fp32"]
    assert np.isfinite(ev["rp_tol"] + ev["rd_tol"]).all()


def _arrays(out, label):
    m = re.search(label + r": status \[([\d ]+)\] iters \[([\d ]+)\]", out)
    return [int(v) for v in m.group(1).split()], [int(v) for v in
                                                  m.group(2).split()]


def test_analyze_matches_jax_and_its_log(capsys):
    path = os.path.join(ART, "stall_probe_r5.npz")
    got = tps.analyze(path, "cpu")
    capsys.readouterr()
    jps.analyze(path)
    jax_out = capsys.readouterr().out
    with open(STALL_LOG) as fh:
        log = fh.read()
    assert got["steps"] == [70, 70, 100, 120, 120, 120, 130, 140]
    assert (got["status_fp64"], got["iters_fp64"]) == (
        [1, 1, 2, 2, 2, 2, 2, 2], [25, 25, 400, 525, 700, 875, 875, 375])
    for out in (jax_out, log):
        assert _arrays(out, "fp64 chol warm") == (got["status_fp64"],
                                                  got["iters_fp64"])
        assert _arrays(out, "fp32 eig warm")[0] == got["status_fp32"]
    assert len(got["pviol_fp32"]) == len(got["du"]) == 8


def test_port_capture_is_exact_and_readable(tmp_path):
    """A short production rollout (2 scenarios, 5 s, fp32 'eig' on the
    CPU): the carry entering step 6, written by ``dump_full``, has the JAX
    capture's keys and dtypes, and re-solved from the file gives the
    recorded status of every alive row; ``probe_stall.dump``'s file has the
    JAX dump's keys per scenario."""
    run = tps.rollout_run(2, steps=[6], device="cpu", T_final=5.0)
    path = str(tmp_path / "full.npz")
    tps.dump_full(path, 6, run=run)
    ours = np.load(path)
    ref = np.load(os.path.join(ART, "fd_cap65_r5.npz"))
    assert sorted(ours.files) == sorted(set(ref.files) - {"scen"})
    for k in ours.files:
        assert ours[k].dtype == ref[k].dtype, k
        assert ours[k].shape[1:] == ref[k].shape[1:], k
    rep = tps.resolve_full(path, "cpu")
    assert rep["agreement"] == 1.0 and rep["n_alive"] == 2
    cap = str(tmp_path / "cap.npz")
    assert tfd.capture(cap, 1, 6, run=run) == tps.STATUS_NAME[
        int(ours["status"][1])]
    assert np.load(cap)["scen"] == 1
    # dump's per-scenario keys on a forged MAX_ITER step
    status = run.out.status.clone()
    status[6, 0] = 2
    forged = tps.Run(run.engine, run.out._replace(status=status),
                     {6: run.carries[6]})
    rep = tps.dump(str(tmp_path / "probe.npz"), seg=2, run=forged)
    assert rep["chosen"] == [(6, 0)]
    probe = np.load(str(tmp_path / "probe.npz"))
    keys = {k.split("_", 1)[1] for k in np.load(
        os.path.join(ART, "stall_probe_r5.npz")).files if k[0].isdigit()}
    assert sorted(probe.files) == sorted({f"0_{k}" for k in keys}
                                         | {"scenarios"})


# ----------------------------- 'near' ------------------------------------

NEAR_KW = dict(solve_mode="eig", pallas_tile=4, max_iter=4000,
               stall_exit_chunks=12, stall_tighten_chunks=24)


@pytest.fixture(scope="module")
def fixture():
    p = _build_setup()
    t = lambda a: torch.as_tensor(np.array(a))
    return p, tadmm.problem_from_numpy(p["prob"], dtype=torch.float64,
                                       device="cpu"), \
        tuple(t(c) for c in p["coeffs"]), t(p["l"]), t(p["u"])


def test_near_rescue_matches_jax(fixture):
    p, prob, coeffs, l, u = fixture
    got = {}
    for mode in ("dual", "near"):
        st = tadmm.ADMMSettings(**NEAR_KW, eig_rescue_mode=mode)
        got[mode] = tadmm.admm_solve(prob, coeffs, l, u,
                                     tadmm.init_state(prob, p["B"], st), st)
    js = jadmm.ADMMSettings(**NEAR_KW, eig_rescue_mode="near")
    ref = jadmm.admm_solve(p["prob"], p["coeffs"], p["l"], p["u"],
                           jadmm.init_state(p["prob"], p["B"], js), js)
    near, dual = got["near"], got["dual"]
    np.testing.assert_array_equal(near.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(near.done_iters.numpy(),
                                  np.asarray(ref.done_iters))
    # the gate fires here: another outcome than 'dual' on some row
    assert not (torch.equal(near.status, dual.status)
                and torch.equal(near.done_iters, dual.done_iters))


def _jax_cap_solve(d, **changes):
    eng, _ = jps.build()
    st = eng.settings._replace(pallas_tile=4, **changes)
    f = lambda a: jnp.asarray(a, jnp.float32)
    state = jadmm.init_state(eng.prob, d["l"].shape[0], st)._replace(
        xbar=f(d["xbar"]), ybar=f(d["ybar"]), zbar=f(d["zbar"]),
        rho_scale=f(d["rho"]), minv=f(d["minv"]), ref_coef=f(d["ref"]),
        minv_ok=jnp.ones((), dtype=bool))
    r = jadmm.admm_solve(eng.prob, (f(d["c1"]), f(d["c2"]), f(d["s"])),
                         f(d["l"]), f(d["u"]), state, st,
                         active=jnp.asarray(d["alive"]))
    return np.asarray(r.status)


def test_near_rescue_on_primal_plateaus_matches_jax():
    path = os.path.join(ART, "fd_cap67_r5.npz")
    d0 = np.load(path)
    rows = np.nonzero(d0["alive"] & (d0["status"] == 2))[0][:8]
    d = _slice(path, rows)
    solved = {}
    for mode in ("dual", "near"):
        eng, _ = tps.build(device="cpu", eig_rescue_mode=mode, pallas_tile=4)
        t = lambda a: torch.as_tensor(a, dtype=torch.float32)
        r = tadmm.admm_solve(
            eng.prob, (t(d["c1"]), t(d["c2"]), t(d["s"])), t(d["l"]),
            t(d["u"]), tps.load_state(eng.prob, eng.settings, d,
                                      torch.float32, "cpu"),
            eng.settings, active=torch.as_tensor(d["alive"]))
        solved[mode] = int((r.status == tadmm.SOLVED).sum())
    ref = int((_jax_cap_solve(d, eig_rescue_mode="near") == 1).sum())
    assert abs(solved["near"] - ref) <= 1, (solved, ref)
    assert solved["near"] > solved["dual"], solved
