"""The port's benchmarks (the counterparts of the repo's ``benchmarks/``).

Each runs its paper grid through :mod:`repro_torch.experiments` on the card
(``device="cpu"`` runs the kernels' plain versions) and prints the
reference's ``name,us_per_call,derived`` CSV rows:

    python -m repro_torch.benchmarks.fig4_ipc [--device cuda]
    python -m repro_torch.benchmarks.sched_bench [--device cuda]
"""
