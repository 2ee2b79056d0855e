"""The drivers users run, ported from the top-level ``examples/``: the
reference's canonical configurations (``common``), single runs with report
figures (``traj_eval_radial``, ``traj_eval_in_track``,
``traj_eval_radialC``), the Monte-Carlo studies (``success_rates``,
``success_curve``, ``disturb_rej_comp``, ``pod_sweep``,
``mixed_sweep_10k``) and re-animation of archived runs
(``animate_results``). Run one as a module, for example

    python -m mpc_arpo_project_tpu_torch.examples.success_rates --cpu

Each runs on the CUDA device unless given ``--cpu`` (then on the CPU in
fp64) and splits into compute functions, which return the numbers, and
``main(argv=None)``, which prints and plots. Only ``main`` needs
matplotlib (through ``mpc_arpo_project_tpu_torch.viz``).
"""
