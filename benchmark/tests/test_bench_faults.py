"""The check fails what it must fail.

A whole run on the CPU (no look for a card) of each kind of cell, cut to
a small size: with each fault a cell can have planted in the program
underneath it, it comes out not correct; the float8 control in the
program's place reads above the program. (One chip:
no exchange between chips to leave out.)"""

import pytest

from benchmark import control
from benchmark.harness import check
from benchmark.tests.bench_common import cells_of, tiny_cell

CELLS = {"train": cells_of("train")[0], "rollout": cells_of("rollout")[0]}


@pytest.mark.parametrize("mode", ["train", "rollout"])
def test_a_sound_run_reads_below_its_control(mode):
    """At this size the numbers are not the cell's (its limits were set
    at its own size, on the card): the program reads finite and below
    the float8 control."""
    name = CELLS[mode]
    numbers, ctrl, limits = control.readings(
        name, 2**31 + 5, 1.0, device="cpu", control=True,
        cell=tiny_cell(name))
    assert all(v == v for v in numbers.values()), numbers
    assert max(ctrl[k] / v for k, v in limits.items()) > \
        max(numbers[k] / v for k, v in limits.items())


@pytest.mark.parametrize("how", control.FAULTS)
@pytest.mark.parametrize("mode", ["train", "rollout"])
def test_each_fault_is_not_correct(mode, how):
    name = CELLS[mode]
    numbers, _, limits = control.readings(
        name, 2**31 + 5, 1.0, device="cpu", how=how, cell=tiny_cell(name))
    assert not check.judge(numbers, limits), numbers


@pytest.mark.cuda
def test_the_control_at_the_cells_size_fails_on_the_card():
    """On the card, at a cell's own size: the float8 control is not
    correct on three seeds (the program's readings beside it)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own size")
    for name in cells_of("train") + cells_of("rollout"):
        for seed in (11, 12, 13):
            numbers, ctrl, limits = control.readings(
                name, seed, 3.0, control=True)
            assert check.judge(numbers, limits), (name, seed, numbers)
            assert not check.judge(ctrl, limits), (name, seed, ctrl)
