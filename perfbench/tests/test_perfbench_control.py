"""Each cell's control, and each fault the cell can have, comes out not
correct at a small size on the CPU, held to the cell's own limits; the
harness's look for a card is skipped, the rest of a run is driven.

Controls: the program's int8 towers (serving); the plain step in TF32 in
the program's place (training). Faults (``perfbench/faults.py``), planted
under the timed path: a step that leaves the state unchanged, half of the
batch left out with the mean over the rest, an answer altered where it is
produced, a schedule never stepped."""

import pytest

from perfbench import faults, registry
from perfbench.tests import small

CELLS = [w["name"] for w in small.bench()["workloads"]]


def driver_of(cell):
    b = small.bench()
    return registry.traffic(registry.workload(b, cell)["traffic"])["driver"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    assert registry.limits(cell), "a cell without limits compares nothing"
    line = small.run(cell, control=True)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in faults.FAULTS[driver_of(c)]])
def test_a_planted_fault_is_not_correct(cell, fault):
    with faults.planted(driver_of(cell), fault):
        line = small.run(cell)
    assert not line["correct"], line["checks"]
