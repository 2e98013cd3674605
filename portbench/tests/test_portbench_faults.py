"""The whole harness on the CPU at a tiny size (the look for a card
skipped, the plain paths under the loop): `correct` holds for the program as
it is, and comes out false with a fault planted under the timed path:
a step that leaves its state unchanged, half of each batch left out (the
mean taken over the rest), an answer altered where it is produced.  The
limits are the cells' own."""

import pytest

from portbench import run as R

TINY = ["--enc_dim", "32", "--dec_dim", "64", "--nqueries", "16", "--preenc_npoints", "64",
        "--enc_nlayers", "1", "--dec_nlayers", "2", "--distillation_box_num", "2",
        "--dataset_num_workers", "2", "--dataset_num_workers_test", "2"]


def _overrides(cell):
    spec = R.load_cell(cell)
    # the text tower over CLIP's extra prompts is minutes on a CPU
    flags = [f for f in spec.config["flags"] if f != "--if_clip_more_prompts"] + TINY
    w = spec.config["widths"]
    w["detector"].update(preenc_npoints=64, enc_dim=32, enc_nlayers=1, dec_dim=64,
                         dec_nlayers=2, nqueries=16)
    train = spec.traffic["kind"] == "train"
    return {"config": {"flags": flags, "widths": w},
            "traffic": {"scenes": 64, "points": 1024, "image_hw": [40, 56], "batch": 2,
                        "crops_per_scene": 2 if train else 16, "trace_steps": 1,
                        "warmup_batches": 1, "check_batches": 1}}


CASES = [("baseline-sunrgbd.train", None, True),
         ("baseline-sunrgbd.train", "frozen_state", False),
         ("baseline-sunrgbd.train", "half_batch", False),
         ("coda-sunrgbd.stage1-train", None, True),
         ("coda-sunrgbd.stage1-train", "half_batch", False),
         ("baseline-sunrgbd.clip-eval", None, True),
         ("baseline-sunrgbd.clip-eval", "altered_answer", False),
         ("baseline-sunrgbd.clip-eval", "half_batch", False)]


@pytest.mark.parametrize("cell,fault,correct", CASES,
                         ids=[f"{c}-{f}" for c, f, _ in CASES])
def test_check_catches_fault(cell, fault, correct):
    result, run = R.run_cell(cell, 2 ** 31 + 17, 1.0, 1, "cpu", fault=fault,
                             overrides=_overrides(cell))
    assert result["correct"] is correct, result["checks"]
    assert set(result["checks"]) == set(R.load_cell(cell).cell["limits"])
    assert run["steps"] >= 1
