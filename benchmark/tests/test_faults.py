"""The comparison that decides ``correct``, driven through a whole run
of each cell at test size on the CPU (the harness's look for a card
skipped): sound runs come out correct; the control and each fault
planted in the program (``benchmark/faults.py``) come out not correct,
also where the fault is planted only for the timed window, after
set-up."""

import pytest

from benchmark import faults, spec as spec_mod
from benchmark.tests.conftest import ROOT, cells

CELLS = cells()


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, trace, cpu_run):
    res = cpu_run(cell, trace=trace)
    assert res["correct"], res["checks"]
    assert res["_forbidden"] == []
    assert res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cpu_run):
    res = cpu_run(cell, control=True)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, cpu_run):
    with faults.planted(fault):
        res = cpu_run(cell)
    assert not res["correct"], res["checks"]


# ``half`` changes the gradient function, which the program captures
# once per grower and refuses to change after set-up
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_in_the_window_only_is_not_correct(cell, fault, cpu_run,
                                                 monkeypatch):
    spec = spec_mod.Spec(ROOT)
    loop = spec.loop(spec.mix(spec.workload(cell)["traffic"])["loop"])
    window = loop.window

    def planted_window(self, seconds):
        with faults.planted(fault):
            return window(self, seconds)

    monkeypatch.setattr(loop, "window", planted_window)
    res = cpu_run(cell)
    assert not res["correct"], res["checks"]
