"""The control: the reference put in the program's place and computed in
bfloat16, below the configurations' float32, fails every cell's limits,
while the program passes them on the same calls. At a size a test run
holds; benchmark/control.py reads the same at the cells' own sizes on the
card."""

import pytest

from benchmark import manifest
from benchmark.control import COMPARED
from benchmark.tests import cpu_runs


@pytest.mark.parametrize("name", sorted(cpu_runs.SMALL))
def test_control_fails_the_limits(name):
    res = cpu_runs.run(name, seconds=0.2, controls=("bfloat16", "float32"))
    limits = cpu_runs.cell(name).limits
    assert res["correct"] is True
    low = res["control"]["bfloat16"]
    assert any(low[n] > limits[n] for n in COMPARED), low
    # A float32 reference sits inside every limit, as the program does.
    assert all(res["control"]["float32"][n] <= limits[n] for n in COMPARED)
