"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program. Each check runs the imports
in a fresh interpreter and compares every loaded module's top-level name
whole: the program's name begins with the JAX package's."""

import json
import subprocess
import sys

import pytest

from harness_helpers import BENCH, ROOT
from test_harness_cells import WORKLOADS

BANNED = ("jax", "jaxlib", "flax", "mpc_arpo_project_tpu")
PROGRAM = "mpc_arpo_project_tpu_torch"


def _loaded(code):
    script = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.', 1)[0] "
              "for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", WORKLOADS)
def test_the_harness_of_each_cell_loads_no_jax(name):
    top = _loaded(
        "from arpobench import cells, harness, samples, study, trace\n"
        "from arpobench.reference import compare\n"
        f"cell = cells.load_cell({name!r})\n"
        "cells.metric_readers()\n"
        "study.build_engine(cell.config, 1.0, 'cpu')")
    assert PROGRAM in top
    assert not top & set(BANNED), top & set(BANNED)


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("from arpobench.reference import admm, compare, model, "
                  "precision, qp_build")
    assert not top & set(BANNED + (PROGRAM, "torch")), top


def test_banned_names_are_compared_whole():
    sys.path[:0] = [BENCH]
    from arpobench import harness

    sys.modules.setdefault("mpc_arpo_project_tpu_torch_like", sys)
    try:
        found = harness.banned_modules()
        assert "mpc_arpo_project_tpu_torch_like" not in found
        assert not any(n.split(".")[0] == PROGRAM for n in found)
    finally:
        del sys.modules["mpc_arpo_project_tpu_torch_like"]
