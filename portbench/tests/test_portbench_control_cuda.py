"""On the card: the TF32 control, the reference computed in the precision
below the configuration's and put in the program's place, comes out not
correct, and the program as it is comes out correct, at a size a test run
holds (the cells' limits; the tiny widths of the fault tests, CLIP at its
own).  The cells' own sizes: `python3 -m portbench.control`."""

import pytest
import torch

from portbench import run as R
from portbench.tests.test_portbench_faults import _overrides

CELLS = ["coda-sunrgbd.stage1-train", "baseline-sunrgbd.train", "baseline-sunrgbd.clip-eval"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("mode", ["program", "control"])
def test_control_fails_program_holds(cell, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32, which only the card has")
    ov = _overrides(cell)
    # kernel D takes head widths of 16 to 128: 4 heads of 16 and of 32
    ov["config"]["flags"] += ["--enc_dim", "64", "--dec_dim", "128"]
    ov["config"]["widths"]["detector"].update(enc_dim=64, dec_dim=128)
    ov["traffic"].update(batch=8, points=20000, image_hw=[531, 730], scenes=5285)
    result, _ = R.run_cell(cell, 2 ** 31 + 23, 2.0, 0, torch.device("cuda", 0),
                           fault="control" if mode == "control" else None, overrides=ov)
    assert result["correct"] is (mode == "program"), result["checks"]
