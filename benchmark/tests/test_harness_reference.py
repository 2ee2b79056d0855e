"""The plain reference agrees with the program run on the CPU at a small
size, and disagrees with a deliberately perturbed output."""

import numpy as np
import pytest
import torch

from harness_helpers import SEED, small_cell

from arpobench import samples, study
from arpobench.reference import compare, model

CELLS = ("flagship_radial.b1024_h20", "radialC.b1024_t70")


def window_samples(name, seconds=20.0):
    """(scenario, samples, limits) of a small CPU window."""
    torch.set_num_threads(2)
    cell = small_cell(name)
    cfg, traffic = cell.config, cell.traffic
    device = torch.device("cpu")
    shape = study.shape_of(cfg, traffic)
    engine = study.build_engine(cfg, traffic["horizon_s"], device)
    win = study.run_window(engine, cfg, traffic, shape, SEED, seconds, device)
    assert win.raised is None, win.raised
    sc = model.Scenario(cfg)
    return sc, samples.collect(cfg, shape, win, sc.initial), cell.limits


@pytest.fixture(scope="module", params=CELLS)
def run(request):
    return window_samples(request.param)


def test_the_reference_holds_the_program_within_the_limits(run):
    sc, smp, limits = run
    numbers = compare.compare(sc, smp)
    assert len(smp.j) > 0
    for k in compare.NUMBERS:
        assert numbers[k] <= limits[k], (k, numbers[k], limits[k])
    assert compare.verdict(numbers, limits)


def _perturbed(smp, where, key, rel):
    d = {k: v.copy() for k, v in getattr(smp, where).items()}
    d[key] = d[key] * (1 + rel)
    return smp._replace(**{where: d})


@pytest.mark.parametrize("where,key,number", [
    ("out", "x", "plant"), ("out", "xest", "ukf_x"), ("out", "P", "ukf_P"),
    ("out", "l", "qp_data")])
def test_a_perturbed_output_fails(run, where, key, number):
    """The output scaled by three times its number's limit fails it."""
    sc, smp, limits = run
    bad = compare.compare(sc, _perturbed(smp, where, key, 3 * limits[number]))
    assert bad[number] > limits[number]
    assert not compare.verdict(bad, limits)


def test_a_control_that_is_not_finite_fails(run):
    sc, smp, limits = run
    bad = compare.compare(sc, smp._replace(ctrl=np.full_like(smp.ctrl, np.nan)))
    assert not compare.verdict(bad, limits)


def test_the_fallback_control_perturbed_fails(run):
    sc, smp, limits = run
    fb = smp.code != 1
    if not fb.any():
        pytest.skip("no fallback step in the sample")
    ctrl = np.where(fb[:, None], smp.ctrl * 1.01, smp.ctrl)
    bad = compare.compare(sc, smp._replace(ctrl=ctrl))
    assert bad["fallback"] > limits["fallback"]


def test_a_wrong_controller_code_fails(run):
    sc, smp, limits = run
    code = np.where(smp.code == 1, 2, 1)
    bad = compare.compare(sc, smp._replace(code=code))
    assert bad["flags"] > limits["flags"]
