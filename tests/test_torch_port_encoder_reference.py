"""The port's detector against the benchmark's plain reference
(`portbench/reference/`) on the CPU, for the masked encoder (--enc_type
masked, 3DETR-m's) and the vanilla one, and the masked encoder's spans.

Both sides are built from the same flags (`3detrmulticlasshead` at enc 32,
dec 64 over 2 decoder layers, 16 queries, 256 pre-encoder points, so 128
after the interim set abstraction: at 64 points the interim SA's BatchNorm
variance is ill-conditioned) and filled with the same seeded weights
(`portbench.weights.load_seeded`).  On two scenes of the benchmark's
generator they are held to:

  * the eval forward's last decoder layer, every key of EVAL_KEYS;
  * one training step (dropout at its rate, drawn from one step generator):
    the loss, every parameter's gradient, AdamW's update of every
    parameter, and every BatchNorm's running statistics, the interim SA's
    included.

Every tolerance is zero, bit for bit: on a CPU tensor each of the port's
ops takes its plain PyTorch path (no kernel), the reference is a copy of
those plain paths, and at one intra-op thread the two run the same ops in
the same order.  Any gap is the reference departing from the port's path,
which the benchmark's `correct` would then misjudge on the card.

The spans (utils/spans.py): a masked forward opens `encoder:masked` once,
inside it `encoder:interim` once and `encoder:radius` three times (one a
radius-masked attention call), all with the enclosing step's index; a
vanilla forward opens none of them.
"""

import numpy as np
import pytest
import torch

from coda_neurips2023_tpu_torch import engine
from coda_neurips2023_tpu_torch.criterion import build_criterion
from coda_neurips2023_tpu_torch.datasets import build_dataset
from coda_neurips2023_tpu_torch.main import make_args_parser
from coda_neurips2023_tpu_torch.models import build_model
from coda_neurips2023_tpu_torch.optimizer import build_optimizer
from coda_neurips2023_tpu_torch.utils import spans
from coda_neurips2023_tpu_torch.utils.spans import RING, span

from portbench import weights
from portbench.reference import build as R
from portbench.scenes import SceneDataset

from torch_one_thread import one_intra_op_thread  # noqa: F401

SEED = 2 ** 31 + 23
LR = 1e-3
FLAGS = ["--dataset_name", "sunrgbd_anonymous_aligned_image", "--model_name",
         "3detrmulticlasshead", "--if_input_image", "--enc_dim", "32", "--dec_dim", "64",
         "--nqueries", "16", "--preenc_npoints", "256", "--dec_nlayers", "2",
         "--num_semcls", "2", "--train_range_max", "10", "--test_range_max", "46",
         "--test_num_semcls", "46", "--loss_sem_cls_softmax_skip_none_gt_sample_weight", "1",
         "--seed", "5"]
ENC_SPANS = ("encoder:masked", "encoder:interim", "encoder:radius")


def _args(enc_type):
    return make_args_parser().parse_args(FLAGS + ["--enc_type", enc_type])


def _batch():
    data = SceneDataset(8, 1024, 4, (40, 56), 64, 12, seed=5)
    scenes = [data[i] for i in range(2)]
    return {k: torch.from_numpy(np.stack([s[k] for s in scenes])) for k in scenes[0]}


def _program(args):
    _, cfg, _, _ = build_dataset(args)
    model, _ = build_model(args, cfg, device="cpu")
    weights.load_seeded(model, SEED, weights.DETECTOR)
    return model, cfg


def _batchnorm_stats(model) -> dict:
    return {n: b.clone() for n, b in model.named_buffers() if "running_" in n}


@pytest.fixture(scope="module", params=["masked", "vanilla"])
def pair(request):
    """Both sides' eval outputs and one training step's readings."""
    args = _args(request.param)
    prog, cfg = _program(args)
    ref = R.build(args, "cpu", with_clip=False)
    weights.load_seeded(ref.model, SEED, weights.DETECTOR)
    batch = _batch()
    with torch.no_grad():
        evals = (R.last_layer(prog.eval()(batch)), R.eval_outputs(ref, batch))

    opt, sched = build_optimizer(args, prog, 10)
    step = engine.make_train_step(prog, build_criterion(args, cfg), opt, lr_schedule=sched)
    theta0 = [p.detach().clone() for p in prog.parameters()]
    loss_p = step(dict(batch, curr_epoch=0, all_epoch=0, lr=LR),
                  engine.step_generator(SEED, 0, "cpu"))["loss"]
    loss_r = R.train_step(ref, args, None, dict(batch, curr_epoch=0, all_epoch=0), LR,
                          R.step_generator(SEED, 0, "cpu"))
    sides = [{"loss": loss.detach(),
              "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
              "params": {n: p.detach().clone() for n, p in model.named_parameters()},
              "bn": _batchnorm_stats(model)}
             for model, loss in ((prog, loss_p), (ref.model, loss_r))]
    return request.param, evals, sides, theta0


def test_eval_forward_equals_the_reference(pair):
    _, (prog, ref), _, _ = pair
    for k in R.EVAL_KEYS:
        assert torch.equal(prog[k], ref[k]), k


def test_training_step_equals_the_reference(pair):
    """The loss, every gradient and AdamW's update of every parameter."""
    _, _, (prog, ref), theta0 = pair
    assert torch.equal(prog["loss"], ref["loss"])
    assert list(prog["grads"]) == list(ref["grads"])
    for (n, g), p0 in zip(prog["grads"].items(), theta0):
        assert torch.equal(g, ref["grads"][n]), n
        update = prog["params"][n] - p0
        assert update.abs().max() > 0, n  # AdamW moved it
        assert torch.equal(update, ref["params"][n] - p0), n


def test_batchnorm_statistics_equal_the_reference(pair):
    enc_type, _, (prog, ref), _ = pair
    interim = [n for n in prog["bn"] if n.startswith("encoder.interim_downsampling.")]
    assert bool(interim) == (enc_type == "masked")
    assert list(prog["bn"]) == list(ref["bn"])
    for n, stats in prog["bn"].items():
        assert torch.equal(stats, ref["bn"][n]), n


# ---------------------------------------------------------------- spans


@pytest.fixture
def empty_ring():
    RING.clear()
    yield
    RING.clear()


def _inside(child, parent):
    return parent.t0 <= child.t0 <= child.t1 <= parent.t1


@pytest.mark.parametrize("mode,outer", [("train", "train:forward"), ("eval", "eval:detector")])
def test_masked_forward_opens_its_spans(empty_ring, mode, outer):
    model, _ = _program(_args("masked"))
    model.train(mode == "train")
    top = "train:step" if mode == "train" else "eval:step"
    with torch.no_grad(), span(top, step=7), span(outer):
        model(_batch(), generator=torch.Generator().manual_seed(0))
    got = [s for s in RING if s.name in ENC_SPANS]
    assert [s.name for s in got].count("encoder:radius") == 3
    (masked,) = [s for s in got if s.name == "encoder:masked"]
    (interim,) = [s for s in got if s.name == "encoder:interim"]
    (parent,) = [s for s in RING if s.name == outer]
    assert masked.parent == outer and _inside(masked, parent)
    for s in got:
        assert s.step == 7 and s.worker is None
        if s is not masked:
            assert s.parent == "encoder:masked" and _inside(s, masked)
    radius = sorted((s for s in got if s.name == "encoder:radius"), key=lambda s: s.t0)
    # layer 0's attention, then the interim SA, then layers 1 and 2's
    assert radius[0].t1 <= interim.t0 <= interim.t1 <= radius[1].t0


def test_vanilla_forward_opens_none(empty_ring):
    model, _ = _program(_args("vanilla"))
    with torch.no_grad(), span("eval:detector", step=0):
        model.eval()(_batch())
    assert [s.name for s in RING] == ["eval:detector"]


def test_encoder_span_names():
    assert set(ENC_SPANS) <= set(spans.NAMES)
    assert len(set(spans.NAMES)) == len(spans.NAMES)
    for a in spans.NAMES:
        for b in spans.NAMES:
            assert a == b or not b.startswith(a), (a, b)
