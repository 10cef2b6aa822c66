"""The control on the card, at a size a test run holds: the reference one
precision below the configuration's, put in the program's place, and each
planted fault of a training cell, must each fail one of the cell's
limits.  ``python3 port_bench/control.py`` reads the same numbers at the
cells' own sizes.

    python -m pytest port_bench/tests/test_control.py -m gpu -q
"""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from port_bench import harness  # noqa: E402
from port_bench.control import readings  # noqa: E402

CELLS = ["length_100.train", "two_qubit_d2_kak.train", "length_100.score", "length_100.serve"]


def _smaller(run: harness.Run) -> None:
    """Published widths; a smaller batch, fewer samples, fewer requests."""
    run.traffic = copy.deepcopy(run.traffic)
    run.config = copy.deepcopy(run.config)
    if "training" in run.config and run.traffic["entry"] == "train":
        run.config["training"].update(batch_size=16, monte_carlo=128)
        run.traffic.update(minibatches=3)
    elif run.traffic["entry"] == "score":
        run.traffic.update(monte_carlo=1 << 16, checked=2)
    else:
        run.traffic["sweep"].update(monte_carlo=2000)
        run.traffic.update(checked=2)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with open(REPO / "BENCHMARK.json") as f:
        run = harness.resolve(json.load(f), cell, REPO, 3 + len(cell), torch.device("cuda", 0))
    _smaller(run)
    drv = harness.entry(run)
    for name, numbers in readings(run, drv).items():
        failed = [k for k, v in numbers.items() if v > run.limits[k]]
        if name == "control" or drv.UNIT == "step":
            assert failed, (name, numbers, run.limits)
