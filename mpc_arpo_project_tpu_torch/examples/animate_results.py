"""Re-animate archived runs (reference ``test/animations_results.py``):
loads ``RunObjs/Run*.pkl`` archives and exports animations, GIF by default,
or the interactive HTML scene (camera follow/rotate/zoom and live strip
charts, the VPython-parity renderer) with --html. Port of
``examples/animate_results.py``; needs matplotlib.

    python -m mpc_arpo_project_tpu_torch.examples.animate_results [--glob 'RunObjs/Run*.pkl'] [--html]
"""

from __future__ import annotations

import argparse
import glob as globmod
import os

from mpc_arpo_project_tpu_torch.utils.archive import load_run


def export(pattern="RunObjs/Run*.pkl", out_dir="RunFigs", html=False):
    """Animate every archive that ``pattern`` matches into ``out_dir``;
    returns [(archive, animation file)]. Archives are unpickled: load only
    ones this program wrote."""
    from mpc_arpo_project_tpu_torch.viz import animate_trajectory, export_html

    done = []
    for p in sorted(globmod.glob(pattern)):
        sim, run, debris = load_run(p)
        stem = os.path.splitext(os.path.basename(p))[0]
        if html:
            out = export_html(sim, run, debris,
                              out_path=os.path.join(out_dir, f"{stem}.html"))
        else:
            out = os.path.join(out_dir, f"{stem}.gif")
            animate_trajectory(sim, run, debris, out_path=out)
        done.append((p, out))
    return done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--glob", default="RunObjs/Run*.pkl")
    ap.add_argument("--out-dir", default="RunFigs")
    ap.add_argument("--html", action="store_true",
                    help="export the interactive HTML scene instead of a GIF")
    args = ap.parse_args(argv)
    done = export(args.glob, args.out_dir, args.html)
    if not done:
        print(f"no archives match {args.glob}")
    for p, out in done:
        print(f"{p} -> {out}")
    return done


if __name__ == "__main__":
    main()
