"""On the card: the fp8 control, put in the program's place at a serving
cell's own size, comes out not correct by the cell's limits while the
program's own run is correct.  ``python -m pytest -m gpu
bench/tests`` from the root of the repository on a machine with an H100;
it skips elsewhere."""
import time

import pytest
import torch

from bench import harness

CELL = "stablelm_3b.long_answer_c16"


@pytest.mark.gpu
def test_the_control_fails_at_the_cell_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.load_cell(harness.BENCH.parent, CELL, False)
    rec = harness.driver("serve_closed").run(harness.Run(
        cell, 2 ** 31 + 4242, 30.0, False, time.perf_counter(),
        hooks={"control": True}))
    assert rec["correct"], rec["checks"]
    assert rec["control_correct"] is False, rec["control_checks"]
