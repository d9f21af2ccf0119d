"""The port's benchmarks (the counterparts of the repo's ``benchmarks/``).

Each runs its paper grid through :mod:`repro_torch.experiments` (or the
simulator's entry points, as its reference does) on the card
(``device="cpu"`` runs the kernels' plain versions) and prints the
reference's ``name,us_per_call,derived`` CSV rows. :mod:`.run` runs them as
suites into one ``repro.bench/v1`` artifact under ``artifacts/torch/``, and
:mod:`.validate` checks it:

    python -m repro_torch.benchmarks.run --list
    python -m repro_torch.benchmarks.run [--suite paper,sens] [--device cuda]
    python -m repro_torch.benchmarks.fig4_ipc [--device cuda]
"""
