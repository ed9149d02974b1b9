"""On the card: the harness's whole run at the tiny sizes, the program
correct and the control not. Run there with

    python -m pytest -m cuda benchmark/tests
"""

import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_the_card_is_correct_and_the_control_is_not(tiny_base, tiny_bench,
                                                    card, cell):
    import time

    c = harness.find_cell(tiny_bench, cell)
    res = harness.run_cell(tiny_bench, c, seed=2**31 + 101, seconds=1.0,
                           trace=True, device=card, t0=time.perf_counter(),
                           bases=(tiny_base, harness.HERE), control=True)
    line = harness.result_line(tiny_bench, c, res, trace=True, device=card,
                               bases=(tiny_base, harness.HERE))
    assert line["correct"], line["checks"]
    assert any(v > lim for v, lim in res["control"].values())
    assert line["device"]["busy_s"] > 0
    idle = harness.plugin("metrics", "device_idle_pct").read(res["run"])
    assert 0 < idle < 100
