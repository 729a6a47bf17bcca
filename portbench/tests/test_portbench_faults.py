"""A run of each cell, driven on the CPU at a small size past the harness's
look for a chip, with the timed path broken underneath: the check has to
come out false for each fault the cell can have (a step that returns its
state unchanged, half of the batch left out and the mean taken over the
rest, an answer altered where it is produced; no cell spans chips; for a
sampling cell also an answer altered in the timed runners alone), and true
for the program as it is."""

import json
import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import common, faults  # noqa: E402
from portbench.run import run_cell  # noqa: E402

SMALL = {
    "tsdiff8.campaign": dict(shard=8, shards=1, batch=4, respacing=12, members=2),
    "geodiff.conformers": dict(shard=1, shards=1, batch=10),
    "tsdiff.train": dict(shard=24, batch=8),
}


def small_spec(workload: str) -> dict:
    spec = common.cell_spec(workload)
    spec["traffic"].update(SMALL[workload])
    if "check" in spec["traffic"]:
        spec["traffic"]["check"].update(walks=1, steps=3)
    return spec


def correct(workload: str) -> bool:
    line = run_cell(small_spec(workload), 2 ** 31 + 77, 0.01, False, "cpu", time.monotonic())
    return json.loads(line)["correct"]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    assert correct(workload)


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_fault_is_not_correct(workload, fault):
    with faults.plant(fault):
        assert not correct(workload)


@pytest.mark.parametrize("workload", ["geodiff.conformers", "tsdiff8.campaign"])
def test_fault_in_the_timed_runner_alone_is_not_correct(workload):
    with faults.plant("timed_runner_altered"):
        assert not correct(workload)
