"""The window's answers as the reference reads them: the sampled rows'
carries before and after each step of every whole batch (after it, with
the solver's scaled iterates), with the step's code, status, iterations,
applied control and inputs, moved to the host in float64."""

from __future__ import annotations

import numpy as np
import torch

from arpobench.reference.compare import Samples
from arpobench import study

# the carry fields under the names the reference reads
_ENT = {"x_true": "x", "xest": "xest", "xest_stored": "xest_stored", "P": "P",
        "xintf": "xintf", "prev_u": "prev_u", "succ": "succ", "alive": "alive"}
_OUT = dict(_ENT, c1="c1", c2="c2", s="s", l="l", u="u", xbar="xbar",
            ybar="ybar", zbar="zbar")


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.numpy() if t.dtype == torch.bool else t.double().numpy()


def _split(flat: np.ndarray, layout: list) -> dict:
    """The (steps, R, columns) record as field -> (steps, R, *shape)."""
    out, i = {}, 0
    for name, shp in layout:
        n = int(np.prod(shp)) if shp else 1
        out[name] = flat[:, :, i:i + n].reshape(flat.shape[:2] + tuple(shp))
        i += n
    return out


def collect(cfg: dict, shape: study.Shape, window: study.Window, initial):
    """Every sampled row's alive step of every whole batch of ``window``, as
    ``Samples`` (None where no batch completed); ``initial(rows)`` is the
    reference's state entering the first step (``Scenario.initial``)."""
    parts = []
    for b in window.batches:
        if b.out is None:
            continue
        R = len(b.rows)
        car = _split(_np(b.carries), b.layout)
        for f in ("alive", "succ"):
            car[f] = car[f] != 0
        ini = initial(R)
        ini.update(xest_stored=ini["xest"], succ=np.zeros(R, bool),
                   alive=np.ones(R, bool))
        inputs = _np(study.program_inputs(cfg, shape, b.draws))
        out = b.out
        off = 2 if shape.loop == "continuous" else 1
        rows = torch.as_tensor(b.rows)
        code = _np(out.ctrl_seq.cpu()[:, rows]).astype(int)
        status = _np(out.status.cpu()[:, rows]).astype(int)
        iters = _np(out.done_iters.cpu()[:, rows]).astype(int)
        ctrl = _np(out.ctrls.cpu()[off:off + shape.n_steps][:, rows])
        for k in range(shape.n_steps):
            if k == 0:
                ent = {_ENT[f]: ini[_ENT[f]] for f in _ENT}
            else:
                ent = {_ENT[f]: car[f][k - 1] for f in _ENT}
            o = {_OUT[f]: car[f][k] for f in _OUT}
            live = ent["alive"].astype(bool)
            if not live.any():
                continue
            if shape.loop == "continuous":
                noise, j = inputs[:, b.rows].transpose(1, 0, 2), k + 1
            else:
                noise, j = inputs[k, b.rows], k
            parts.append(dict(
                ent={n: v[live] for n, v in ent.items()},
                out={n: v[live] for n, v in o.items()},
                code=code[k][live], status=status[k][live],
                ctrl=ctrl[k][live], noise=noise[live],
                j=np.full(int(live.sum()), j), iters=iters[k][live]))
    if not parts:
        return None
    cat = lambda key: np.concatenate([p[key] for p in parts])
    catd = lambda key: {n: np.concatenate([p[key][n] for p in parts])
                        for n in parts[0][key]}
    ent, out = catd("ent"), catd("out")
    for d in (ent, out):
        d["alive"] = d["alive"].astype(bool)
        d["succ"] = d["succ"].astype(bool)
    return Samples(ent, out, cat("code"), cat("status"), cat("ctrl"),
                   cat("noise"), cat("j"), cat("iters"))
