"""Two ``torch.distributed`` ranks (gloo, CPU) must give the sweep and the
fused disturbance-rejection study of one process: the port's counterpart
of ``tests/test_distributed.py``. Each rank
runs its half of every chunk and the stats meet in one ``all_gather``, so this
also holds the closed loop to batch-composition independence: a scenario's
outcome must not depend on the scenarios beside it in the batch ('eig'
packs slots, compacts stragglers and caps its refresh by batch). Also the
weak-scaling tool ``tools/scaling_bench.py`` of the port over gloo
ranks."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import torch

from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.parallel import mc
from tests.torch_helpers import SWEEP_SETTINGS, sweep_configs, sweep_engine
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# imports nothing of JAX and not tests/conftest.py
_WORKER = textwrap.dedent(
    """
    import json, sys
    sys.path[:0] = [{repo!r}, {tests!r}]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank = int(sys.argv[1])
    dist.init_process_group("gloo", store=dist.FileStore({store!r}, 2),
                            rank=rank, world_size=2)
    from torch_helpers import SWEEP_SETTINGS, sweep_configs, sweep_engine
    from mpc_arpo_project_tpu_torch.ops import admm
    from mpc_arpo_project_tpu_torch.parallel import mc, mesh as mesh_lib

    mesh = mesh_lib.make_mesh(hybrid=True)
    assert mesh.mesh_dim_names == ("dcn", "ici") and mesh.shape == (1, 2)
    assert mesh_lib.batch_slice(mesh, 8) == slice(4 * rank, 4 * rank + 4)
    res = mc.run_sweep(sweep_engine({mode!r}), total=16, chunk=8, seed=7,
                       mesh=mesh)
    _, ratios = mc.disturbance_rejection_study_fused(
        *sweep_configs(), [5, 10], 2, 9, mesh=mesh,
        settings=admm.ADMMSettings(**SWEEP_SETTINGS[{mode!r}]),
        dtype=torch.float64, device="cpu")
    res["study_ratios"] = ratios.tolist()
    if rank == 0:
        with open({out!r}, "w") as fh:
            json.dump(res, fh)
    dist.destroy_process_group()
    print("worker", rank, "ok", flush=True)
    """
)


@pytest.mark.parametrize("mode", ["chol", "eig"])
def test_two_process_sweep_matches_single_process(tmp_path, mode):
    out = str(tmp_path / "dist_stats.json")
    code = _WORKER.format(repo=_REPO, tests=os.path.join(_REPO, "tests"),
                          store=str(tmp_path / "store"), out=out, mode=mode)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)], env=env,
                              cwd=str(tmp_path), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{o[-3000:]}"
    with open(out) as fh:
        dist_res = json.load(fh)

    ref = mc.run_sweep(sweep_engine(mode), total=16, chunk=8, seed=7)
    assert dist_res["n"] == ref["n"] == 16
    assert dist_res["ctrl_usage"] == ref["ctrl_usage"]
    assert dist_res["success_rate"] == ref["success_rate"]
    np.testing.assert_allclose(dist_res["mean_final_dist"],
                               ref["mean_final_dist"], rtol=1e-9)
    np.testing.assert_allclose(dist_res["mean_i_term"], ref["mean_i_term"],
                               rtol=1e-12)
    # per step the most iterations of the whole chunk, as in one process
    assert dist_res["total_admm_iters"] == ref["total_admm_iters"]
    # the fused study: 2 arms x 2 hold lengths x 2 runs, 4 scenarios a rank
    _, ratios = mc.disturbance_rejection_study_fused(
        *sweep_configs(), [5, 10], 2, 9,
        settings=admm.ADMMSettings(**SWEEP_SETTINGS[mode]),
        dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(dist_res["study_ratios"], ratios, rtol=1e-9)


def test_scaling_bench_over_gloo_ranks(capsys):
    """``tools/scaling_bench.py`` of the port at W = 1 and 2 gloo ranks on
    the CPU (2 scenarios a rank, 2 control steps): one line per W, each
    sweep over the whole batch, W = 1 the efficiency's base."""
    from mpc_arpo_project_tpu_torch.tools import scaling_bench

    res = scaling_bench.main(["--cpu", "--devices", "1", "2",
                              "--per-device", "2", "--T", "1.0"])
    out = capsys.readouterr().out
    assert [r["devices"] for r in res] == [1, 2]
    assert [r["batch"] for r in res] == [r["scenarios_run"] for r in res] \
        == [2, 4]
    assert res[0]["efficiency"] == 1.0
    for r in res:
        assert r["seconds"] > 0 and r["sims_per_s"] == r["batch"] / r["seconds"]
        assert f"devices={r['devices']:2d} batch={r['batch']:4d}:" in out
