"""``correct`` comes out false when the timed path is broken underneath:
a smoke run of each training cell, the program's run and the check after
it (the card's readings left out), with each fault a training cell can
have planted in the program; and the
control, the fp8 reference in the program's place, reads further from the
reference than the program does."""

import pytest
import torch

from chipbench import faults, harness, smoke, train


@pytest.fixture(autouse=True, scope="module")
def _program_on_path():
    harness.boot()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = torch.device("cpu")
CELLS = [w["name"] for w in harness.load_manifest()["workloads"]
         if harness.Cell(harness.load_manifest(), w["name"]).traffic["kind"]
         == "train"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(name, fault):
    cell = smoke.smoke_cell(name)
    with faults.FAULTS[fault]():
        rec = train.run_program(cell, 11, 0.0, False, CPU)
    ok, compared = train.judge(cell, train.check(cell, 11, rec, CPU)[0])
    assert ok is False, compared
    assert any(v > lim for v, lim in compared.values())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_step_is_correct(name):
    cell = smoke.smoke_cell(name)
    rec = train.run_program(cell, 12, 0.0, False, CPU)
    ok, compared = train.judge(cell, train.check(cell, 12, rec, CPU)[0])
    assert ok is True, compared


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_above_the_program(name):
    cell = smoke.smoke_cell(name)
    rec = train.run_program(cell, 13, 0.0, False, CPU)
    prog = train.check(cell, 13, rec, CPU)[0]
    low = train.reference_readings(cell, 13, CPU, quant="fp8")
    ref_c = train.reference_readings(cell, 13, CPU,
                                     against=low.pop("grad_host"),
                                     follow=low["iters"] or None)
    ctrl = train.compare(low, ref_c)
    assert ctrl["loss_gap"] > 3 * prog["loss_gap"]
    assert ctrl["grad_diff"] > 3 * prog["grad_diff"]
