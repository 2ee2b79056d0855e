"""The port's ``graft_entry`` against the repository's ``__graft_entry__.py``:
the counterparts of ``tests/test_parallel.py``'s ``test_graft_entry_compiles``
and ``test_graft_dryrun_multichip``. ``entry()``'s step equals the JAX
step on the same carry and noise, and ``dryrun_multichip`` runs over gloo
ranks on the CPU and gives the statistics of its slices run in one
process."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as ge
from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu.rollout import discrete as jdisc
from mpc_arpo_project_tpu_torch import graft_entry as tg
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.parallel import mc
from mpc_arpo_project_tpu_torch.rollout import discrete as tdisc
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one fp64 step on the same carry through the same iteration map: the
# states agree to round-off of a few hundred ADMM iterations on ~100 m
STATE_ATOL = 1e-9


@pytest.fixture(scope="module")
def jax_step():
    """The JAX ``entry()`` step, built with ``_flagship(dtype=float64)``
    and the solver profile of ``__graft_entry__.py:80-82``."""
    jeng = ge._flagship(dtype=jnp.float64,
                        settings=jadmm.ADMMSettings(**tg.PROFILE))
    carry0 = jdisc._init_carry(jeng, 8, jnp.broadcast_to(jeng.x0, (8, 4)))
    step = jax.jit(lambda c, s: jdisc._step(jeng, c, s))
    return jeng, carry0, step


@pytest.mark.parametrize("noise", ["zero", "drawn"])
def test_entry_step_matches_jax(jax_step, noise):
    jeng, jcarry0, jstep = jax_step
    fn, (carry0, (i, noise0)) = tg.entry(device="cpu", dtype=torch.float64)
    assert i == 0 and tuple(noise0.shape) == (8, 4) and not noise0.any()
    assert carry0.x_true.dtype == torch.float64
    draws = np.zeros((8, 4))
    if noise == "drawn":
        draws = np.random.default_rng(4).standard_normal((8, 4)) \
            * np.asarray(jeng.sig_diag)
    carry, out = fn(carry0, (i, torch.as_tensor(draws)))
    jcarry, jout = jax.tree.map(np.asarray, jstep(
        jcarry0, (jnp.int32(0), jnp.asarray(draws))))
    # statuses, controller codes, done_iters and the step's iterations
    for k, name in ((5, "status"), (4, "ctrl_seq"), (7, "done_iters")):
        np.testing.assert_array_equal(out[k].numpy(), jout[k], err_msg=name)
    assert int(out[6]) == int(jout[6])
    assert (out[5] >= 1).all()
    for name in ("x_true", "xest", "xest_stored", "prev_u"):
        np.testing.assert_allclose(getattr(carry, name).numpy(),
                                   getattr(jcarry, name), rtol=0,
                                   atol=STATE_ATOL, err_msg=name)
    for name in ("alive", "i_term", "succ"):
        np.testing.assert_array_equal(getattr(carry, name).numpy(),
                                      getattr(jcarry, name), err_msg=name)


def test_entry_builds_the_flagship_at_horizon_40():
    fn, (carry0, _) = tg.entry(device="cpu")
    assert carry0.x_true.dtype == torch.float32
    eng = tg._flagship(T_final=2.5, device="cpu")
    assert (eng.dims.Nx, eng.nsim) == (40, 5)
    assert eng.settings == tadmm.ADMMSettings()


def test_refuses_a_missing_card_or_group(monkeypatch):
    """Without a CUDA device ``entry()`` and the command line raise; the
    dry run raises without an initialised process group or with another
    world size."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.main()
    with pytest.raises(RuntimeError, match="process group"):
        tg.dryrun_multichip(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="need 2 ranks, have 1"):
            tg.dryrun_multichip(2)
    finally:
        dist.destroy_process_group()


# imports nothing of JAX and not tests/conftest.py
_WORKER = textwrap.dedent(
    """
    import json, sys
    sys.path.insert(0, {repo!r})
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank = int(sys.argv[1])
    dist.init_process_group("gloo", store=dist.FileStore({store!r}, {n}),
                            rank=rank, world_size={n})
    from mpc_arpo_project_tpu_torch import graft_entry
    st = graft_entry.dryrun_multichip({n})
    bad = sorted(m for m in sys.modules if m == "jax"
                 or m.startswith(("jax.", "mpc_arpo_project_tpu."))
                 or m == "mpc_arpo_project_tpu")
    if bad:
        raise SystemExit(f"imported {{bad}}")
    if rank == 0:
        with open({out!r}, "w") as fh:
            json.dump(st._asdict(), fh)
    dist.destroy_process_group()
    """
)


@pytest.mark.parametrize("n,mesh", [(2, "{'data': 2}"),
                                    (4, "{'dcn': 2, 'ici': 2}")])
def test_dryrun_multichip_over_gloo_ranks(tmp_path, n, mesh):
    """``dryrun_multichip(n)`` over n gloo ranks that meet in a FileStore:
    the flat mesh at n=2, the (2, n/2) ("dcn", "ici") mesh at n=4. Its
    statistics are those of the ranks' slices run in one process and
    combined as the reduction says (sums added, per step the most ADMM
    iterations), and their outcome counts are the whole batch's. The
    batch's fp32 iterations are not: a stalled row can exit a few chunks
    apart in another batch on the CPU, so ``sum_iters`` is not held to
    the whole batch's."""
    out = str(tmp_path / "stats.json")
    code = _WORKER.format(repo=REPO, store=str(tmp_path / "store"), n=n,
                          out=out)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              cwd=str(tmp_path), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-3000:]}"
    assert f"dryrun_multichip ok: mesh={mesh} scenarios={2 * n} " in outs[0]
    with open(out) as fh:
        got = json.load(fh)

    eng = tg._flagship(T_final=2.5, settings=tadmm.ADMMSettings(**tg.PROFILE),
                       device="cpu")
    noise = tdisc.make_noise_sequence(
        eng, torch.Generator().manual_seed(0), 2 * n)
    parts = [mc._out_stats(eng, tdisc.rollout(eng, noise[:, 2 * r:2 * r + 2]))
             for r in range(n)]
    combined = {k: sum(int(getattr(st, k)) for st, _ in parts)
                for k in mc.SweepStats._fields[:-1] if k != "sum_final_dist"}
    combined["sum_iters"] = int(torch.stack([it for _, it in parts])
                                .amax(0).sum())
    fd = sum(float(st.sum_final_dist) for st, _ in parts)
    assert got.pop("sum_final_dist") == pytest.approx(fd, rel=1e-12)
    assert got == combined
    whole = mc.sharded_stats_fn(eng, None)(eng, noise)._asdict()
    assert fd == pytest.approx(whole.pop("sum_final_dist"), rel=1e-6)
    whole.pop("sum_iters")
    assert {k: v for k, v in got.items() if k != "sum_iters"} == whole
