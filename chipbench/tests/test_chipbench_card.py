"""The harness on the card at a small size: the kernels' answers equal the
frozen reference's (run with ``-m cuda`` on a machine with a card)."""
from __future__ import annotations

import time

import pytest

from chipbench.harness import main


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fig4-1core", "sched-4core"])
def test_small_run_on_the_card_is_correct(card, cell):
    bench, c, config, traffic = main.load_cell(cell)
    small = (dict(workloads=["gamess", "gups"], instructions=20000)
             if cell == "fig4-1core" else dict(n_requests=256))
    rec = main.run_cell(config, dict(traffic, **small), seed=2 ** 31 + 1,
                        seconds=0.5, trace=True, device="cuda",
                        t_start=time.perf_counter())
    line = main.result_line(bench, c, rec, trace=True)
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
