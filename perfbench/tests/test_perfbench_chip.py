"""Checks on the card, at the cells' own sizes: the profiler sees a
CUDA graph replay's kernels, and each cell's limit lies between the
program and the control. Skipped without a card; on the card:

    python3 -m pytest perfbench/tests -m chip
"""

import pytest

from perfbench import calibrate
from perfbench.manifest import Manifest

CELLS = ("ff.score16k", "xformer.s16k")
SEED = 2 ** 31 + 99


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_profiler_sees_a_replayed_request(card, cell):
    got = calibrate.trace_probe(Manifest(), cell, SEED)
    # a replay launches what the eager run did, less the copies the
    # first call makes of its inputs; its device time is the eager run's
    assert got["replay_ops"] >= got["eager_ops"] - 2
    assert got["replay_device_ms"] == pytest.approx(got["eager_device_ms"],
                                                    rel=0.1)


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_limit_lies_between_the_program_and_the_control(card, cell):
    man = Manifest()
    limit = man.cell_file(cell)["limits"]["max_abs_err"]
    got = calibrate.control(man, cell, [SEED], [SEED], 1.0)
    assert got["program_all_correct"]
    assert got["program_max_abs_err_max"] <= limit
    assert got["control_tf32_max_abs_err_min"] > 3 * limit
