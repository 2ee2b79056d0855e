"""Closed-loop rollouts: the reference's simulation loops over a scenario
batch (``discrete``: the linear CW plant; ``continuous``: the nonlinear
two-body plant with sample-and-hold)."""
