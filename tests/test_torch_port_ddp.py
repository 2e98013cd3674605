"""The PyTorch port's data parallelism against the JAX package's mesh, on the CPU.

Two gloo processes (`parallel.ddp.launch`, both ranks on the CPU) against
the JAX package on a mesh of 2 of conftest's 8 virtual CPU devices
(`make_mesh(2)`), on the same inputs made from a seed, at the tiny widths
of tests/test_torch_port_model.py with dropout 0.  One launch runs every
rank-side part (tests/torch_ddp_ranks.py :: primitives):

  * the loader: each rank's batches are rows [r*B, (r+1)*B) of the batch the
    JAX package's loader builds at B x 2, bit for bit, for 2 epochs: SUN
    RGB-D fixture scans of the train split (augmentation and images drawn
    from each batch's generator, shuffle, drop_last) and of the val split
    (pad_last: a tail whose second rank holds padding only, and its masks);
  * BatchNorm in training mode at R = 2: the output, the running statistics
    and the gradients of the input, the scale and the bias (summed over the
    ranks) against flax's BatchNorm over the mesh-2 global batch, 1e-5;
  * the criterion on a batch whose second replica holds only empty scenes,
    where the per-replica normalizer of the skip-none-gt softmax differs
    from the global one, with every ported loss on (each of its
    normalizers): the ranks' shares summed against
    SetCriterion(per_replica_norm=2), and under --if_global_batch_loss_norm
    against the global normalizer, 1e-5 (of the loss, where it exceeds 1);
  * one baseline training step at R = 2 against the JAX train step under
    make_mesh(2): the loss within 1e-4, the weights after the update within
    the training loop test's WEIGHT_TOL of their norm, bit-equal across the
    ranks.

Beside them: the world-size and row rules; a NaN loss on one rank stops
both ranks at the same step with exit code 1; and the build lock (two
processes that build the host library at once into one empty build
directory both load it, after one build).
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from coda_neurips2023_tpu import criterion as jcriterion
from coda_neurips2023_tpu import engine as jengine
from coda_neurips2023_tpu import optimizer as joptimizer
from coda_neurips2023_tpu.datasets import loader as jloader
from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig
from coda_neurips2023_tpu.datasets.config import SunrgbdImageConfig as JaxImageConfig
from coda_neurips2023_tpu.datasets.sunrgbd import SunrgbdDetectionDataset as JaxSunrgbd
from coda_neurips2023_tpu.engine import _TARGET_KEYS as JAX_TARGET_KEYS
from coda_neurips2023_tpu.models import model_3detr as jmodel
from coda_neurips2023_tpu.parallel.mesh import make_mesh, replicate, shard_batch

from coda_neurips2023_tpu_torch.parallel import ddp
from coda_neurips2023_tpu_torch.utils.weights import state_dict_from_flax

import torch_ddp_ranks
from test_torch_port_eval import _assert_batches_equal, _sunrgbd_fixture
from test_torch_port_model import TINY, _perturb
from test_torch_port_train import (
    ALL_WEIGHTS,
    BASELINE_ARGS,
    NO_DROPOUT,
    _outputs_near_targets,
    _scenes,
)
from test_torch_port_train_loop import WEIGHT_TOL

WORLD = 2
PER_RANK = 2
EPOCHS = 2
BN_TOL = 1e-5
LOSS_TOL = 1e-5
STEP_LOSS_TOL = 1e-4
# the learning rate of the step: the size of the training loop test's (whose
# LR warms up from 1e-6 to 2e-5 over its 8 steps).  AdamW's first update is
# about lr * sign(g), so a gradient at the two packages' rounding noise moves
# its weight by 2 * lr the other way: the weights' difference grows with lr
STEP_LR = 2e-5
N_CLASSES = 10
# every ported loss with a normalizer of its own
CRITERION_WEIGHTS = dict(
    ALL_WEIGHTS, loss_predicted_region_embed_l1_weight=1.0,
    loss_predicted_region_embed_l1_only_last_layer_weight=2.0,
    loss_predicted_region_embed_cos_weight=0.5, loss_region_embed_weight=0.3,
    loss_contrast_object_text=0.7,
    loss_feat_seen_softmax_weakly_loss_with_novel_cate_confi_weight=1.0,
)
NORMALIZERS = {
    "per_replica": dict(if_per_replica_loss_norm=True, if_global_batch_loss_norm=False),
    "global": dict(if_per_replica_loss_norm=True, if_global_batch_loss_norm=True),
}


def _loader_cases(tmp_path):
    """SUN RGB-D fixture scans: 9 of the train split (2 global batches of 4,
    one scan dropped) and 5 of val (a tail of 1 scan padded to 4)."""
    cases = {}
    for split, n, seed in (("train", 9, 5), ("val", 5, 6)):
        root, calib, image = _sunrgbd_fixture(tmp_path, split, n, seed=seed, with_images=True)
        train = split == "train"
        cases[split] = dict(
            split=split, config="SunrgbdAnonymousConfig" if train else "SunrgbdImageConfig",
            dataset=dict(root_dir=root, calib_dir=calib, image_dir=image, num_points=1024,
                         augment=train, if_input_image=True, if_image_augment=train,
                         anonymous=train),
            loader=dict(shuffle=train, seed=3, drop_last=train, pad_last=not train),
            per_rank=PER_RANK, epochs=EPOCHS, first_epoch=1)
    return cases


def _bn_case():
    rng = np.random.default_rng(0)
    c = 24
    return dict(
        x=(rng.standard_normal((2 * WORLD, 5, 16, c)) * 2.0 + 5.0).astype(np.float32),
        gout=rng.standard_normal((2 * WORLD, 5, 16, c)).astype(np.float32),
        state=dict(weight=rng.uniform(0.5, 1.5, c).astype(np.float32),
                   bias=rng.normal(0, 0.1, c).astype(np.float32),
                   running_mean=rng.normal(0, 0.1, c).astype(np.float32),
                   running_var=rng.uniform(0.5, 1.5, c).astype(np.float32),
                   num_batches_tracked=np.asarray(0, np.int64)))


def _criterion_case():
    """4 scenes, the second replica's two without ground truth, outputs near
    the targets with text embeddings, and the stage-1/2 targets."""
    batch = _scenes(2 * WORLD, seed=4)
    for k in ("gt_box_present", "gt_box_corners", "gt_box_centers_normalized",
              "gt_box_sizes_normalized", "gt_angle_class_label", "gt_angle_residual_label"):
        batch[k][PER_RANK:] = 0
    b, nq = 2 * WORLD, 16
    outs = _outputs_near_targets(batch, num_layers=3, nq=nq, seed=5)
    rng = np.random.default_rng(6)
    outs["text_correlation_embedding"] = rng.standard_normal((3, b, nq, 512)).astype(np.float32)
    mask = (rng.uniform(size=(b, nq, 1)) < 0.4).astype(np.float32)
    weak_w = rng.uniform(0.2, 1.0, (b, nq)).astype(np.float32)
    weak_w[rng.uniform(size=(b, nq)) < 0.4] = 0.0
    text = rng.standard_normal((N_CLASSES + 1, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    targets = {k: batch[k] for k in ("gt_box_corners", "gt_box_centers_normalized",
                                     "gt_box_sizes_normalized", "gt_box_angles",
                                     "gt_angle_class_label", "gt_angle_residual_label",
                                     "gt_box_sem_cls_label", "gt_box_present",
                                     "gt_box_seen_sem_cls_confi")}
    targets.update(
        gt_box_seen_sem_cls_label=rng.integers(0, N_CLASSES, batch["gt_box_present"].shape),
        gt_text_correlation_embedding=(rng.standard_normal((b, nq, 512)) * mask).astype(np.float32),
        gt_text_correlation_embedding_mask=mask,
        weak_box_cate_label=rng.integers(0, N_CLASSES, (b, nq)),
        weak_confidence_weight=weak_w,
    )
    consts = dict(text_features_clip=text, logit_scale=np.float32(100.0))
    variants = {name: dict(BASELINE_ARGS, **CRITERION_WEIGHTS, **flags)
                for name, flags in NORMALIZERS.items()}
    return dict(outputs=outs, targets=targets, consts=consts, variants=variants)


def _step_case():
    """The tiny baseline detector (no text head, dropout 0) initialised in
    flax and perturbed, and a batch of 2 scenes a rank."""
    batch = _scenes(2 * WORLD)
    jm = jmodel.CoDA3DETR(dataset_config=JaxConfig(), with_text_head=False, **NO_DROPOUT, **TINY)
    fwd_keys = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")
    variables = jax.jit(lambda r, b: jm.init(r, b, train=False))(
        jax.random.PRNGKey(0), {k: batch[k][:2] for k in fwd_keys})
    variables = _perturb(variables, 0)
    state = state_dict_from_flax(variables["params"], variables["batch_stats"],
                                 variables["constants"])
    return dict(batch=batch, jm=jm, variables=variables,
                rank=dict(args=dict(BASELINE_ARGS), model=dict(**NO_DROPOUT, **TINY),
                          state={k: np.asarray(v) for k, v in state.items()},
                          batch={k: batch[k] for k in (*fwd_keys, *JAX_TARGET_KEYS)
                                 if k in batch},
                          lr=STEP_LR))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of one launch, and the cases they ran."""
    tmp = tmp_path_factory.mktemp("ddp")
    cases = dict(loader=_loader_cases(tmp), bn=_bn_case(), criterion=_criterion_case(),
                 step=_step_case())
    out = tmp / "out"
    out.mkdir()
    ddp.launch(torch_ddp_ranks.primitives, WORLD, str(out), cases["loader"], cases["bn"],
               cases["criterion"], cases["step"]["rank"], devices=["cpu"] * WORLD,
               backend="gloo", dist_url=ddp.free_url())
    return dict(cases=cases, got=torch_ddp_ranks.load_ranks(str(out), WORLD))


# ------------------------------------------------------------------ the rules


def test_world_size_rule():
    assert ddp.world_size(8, "cpu") == 1  # one process unless the caller names CPU devices
    assert ddp.world_size(8, "cpu", cpu_devices=2) == 2
    assert ddp.world_size(1, "cpu", cpu_devices=8) == 1
    assert ddp.world_size(3, "cpu", cpu_devices=8) == 3
    assert ddp.backend_for("cpu") == "gloo" and ddp.backend_for("cuda:1") == "nccl"


def test_rows_are_the_mesh_blocks():
    """Contiguous blocks, as P("dp") shards the leading axis over make_mesh(2)."""
    batch = {"x": np.arange(12).reshape(6, 2), "names": list("abcdef")}
    got = [ddp.rows(batch, r, 3) for r in range(3)]
    assert [g["names"] for g in got] == [["a", "b"], ["c", "d"], ["e", "f"]]
    sharded = jax.device_put(batch["x"], NamedSharding(make_mesh(2), P("dp")))
    for r, shard in enumerate(sorted(sharded.addressable_shards, key=lambda s: s.index[0].start)):
        np.testing.assert_array_equal(ddp.rows(batch, r, 2)["x"], np.asarray(shard.data))
    with pytest.raises(ValueError):
        ddp.rows(batch, 0, 4)


def test_collectives_over_the_ranks(ranks):
    for rank, got in enumerate(ranks["got"]):
        d = got["dist"]
        assert d["average"] == 0.5
        assert d["reduced"] == {"a": 1.0, "b": 4.0}
        np.testing.assert_array_equal(d["gathered"]["x"], np.repeat([0.0, 1.0], 2)[:, None]
                                      * np.ones((4, 3), np.float32))
        assert d["gathered"]["names"] == ["r0", "r1"]  # in rank order
        assert d["primary"] == (rank == 0)
        np.testing.assert_array_equal(d["summed"], np.arange(3) * 3)


# ------------------------------------------------------------------ the loader


@pytest.mark.parametrize("split", ["train", "val"])
def test_rank_rows_equal_the_jax_global_batch(ranks, split):
    case = ranks["cases"]["loader"][split]
    cfg = JaxImageConfig() if case["config"] == "SunrgbdImageConfig" else JaxConfig()
    jds = JaxSunrgbd(cfg, split, **case["dataset"])
    loader = jloader.make_loader(jds, PER_RANK * WORLD, num_workers=1, **case["loader"])
    loader.epoch = case["first_epoch"]
    want = [list(loader) for _ in range(EPOCHS)]
    assert len(want[0]) == 2
    if split == "val":  # the tail: one scan, then rank 1's rows are padding only
        assert want[0][-1]["pad_mask"].tolist() == [True, False, False, False]
    else:
        assert [b["scan_idx"].tolist() for b in want[0]] != [b["scan_idx"].tolist()
                                                            for b in want[1]]
    for rank, got in enumerate(ranks["got"]):
        epochs = got["loader"][split]
        assert [len(e) for e in epochs] == [len(e) for e in want]
        for e in range(EPOCHS):
            for g, w in zip(epochs[e], want[e]):
                _assert_batches_equal(g, ddp.rows(w, rank, WORLD))


# ------------------------------------------------------------------ BatchNorm


def _flax_batchnorm(case):
    import flax.linen as nn

    s = case["state"]
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": s["running_mean"], "var": s["running_var"]}

    def loss(params, x):
        y, mutated = jbn.apply({"params": params, "batch_stats": stats}, x,
                               mutable=["batch_stats"])
        return jnp.sum(y * case["gout"]), (y, mutated["batch_stats"])

    x = jax.device_put(case["x"], NamedSharding(make_mesh(WORLD), P("dp")))
    (_, (y, stats)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        {"scale": s["weight"], "bias": s["bias"]}, x)
    return jax.tree.map(np.asarray, dict(y=y, dx=gx, dw=gp["scale"], db=gp["bias"],
                                         mean=stats["mean"], var=stats["var"]))


def test_distributed_batchnorm_matches_flax_over_the_mesh(ranks):
    want = _flax_batchnorm(ranks["cases"]["bn"])
    got = [g["bn"] for g in ranks["got"]]
    for key in ("y", "dx"):  # each rank's rows
        np.testing.assert_allclose(np.concatenate([g[key] for g in got]), want[key], rtol=0,
                                   atol=BN_TOL, err_msg=key)
    for key in ("dw", "db"):  # each rank's part of the global gradient
        np.testing.assert_allclose(sum(g[key] for g in got), want[key], rtol=0,
                                   atol=BN_TOL * max(1.0, np.abs(want[key]).max()), err_msg=key)
    for key in ("mean", "var"):  # the global statistics, alike on every rank
        for g in got:
            np.testing.assert_allclose(g[key], want[key], rtol=0, atol=BN_TOL, err_msg=key)
        np.testing.assert_array_equal(got[0][key], got[1][key])


# ------------------------------------------------------------------ the criterion


@pytest.mark.parametrize("normalizer", list(NORMALIZERS))
def test_criterion_shares_sum_to_the_jax_loss(ranks, normalizer):
    case = ranks["cases"]["criterion"]
    args = types.SimpleNamespace(**case["variants"][normalizer])
    jcrit = jcriterion.build_criterion(args, JaxConfig(), num_replicas=WORLD)
    assert jcrit.per_replica_norm == (WORLD if normalizer == "per_replica" else 0)
    want_total, want = jax.jit(lambda o, t: jcrit(o, t))(
        case["outputs"], dict(case["targets"], **case["consts"]))
    shares = [g["criterion"][normalizer] for g in ranks["got"]]
    assert set(shares[0]) == set(want) | {"total"}
    want = dict(want, total=want_total)
    for key, w in want.items():  # 1e-5 of the loss where it exceeds 1: fp32 rounds the
        w = float(w)             # total of 66 at 4e-6, and the two shares sum in another order
        got = sum(s[key] for s in shares)
        assert abs(got - w) <= LOSS_TOL * max(1.0, abs(w)), (key, got, w)
    # the empty replica: the per-replica normalizer halves the skip-none-gt
    # loss of the global one
    key = "loss_sem_cls_softmax_skip_none_gt_sample"
    assert shares[1][key] == 0.0 and shares[0][key] > 0


def test_per_replica_and_global_normalizers_differ(ranks):
    per_replica, global_ = ([g["criterion"][n] for g in ranks["got"]] for n in NORMALIZERS)
    key = "loss_sem_cls_softmax_skip_none_gt_sample"
    np.testing.assert_allclose(per_replica[0][key], global_[0][key] / 2, rtol=1e-6)


# ------------------------------------------------------------------ one training step


@pytest.fixture(scope="module")
def jax_step(ranks):
    case = ranks["cases"]["step"]
    args = types.SimpleNamespace(**case["rank"]["args"])
    v = case["variables"]
    tx, schedule = joptimizer.build_optimizer(args, None, 600)
    state = jengine.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                               batch_stats=v["batch_stats"], constants=v["constants"],
                               opt_state=tx.init(v["params"]))
    step = jengine.make_train_step(case["jm"], jcriterion.build_criterion(
        args, JaxConfig(), num_replicas=WORLD), tx, lr_schedule=schedule)
    mesh = make_mesh(WORLD)
    batch = shard_batch(mesh, case["rank"]["batch"])
    batch["lr"] = np.float32(STEP_LR)
    state, metrics = step(replicate(mesh, state), batch, jax.random.PRNGKey(1))
    state = jax.tree.map(np.asarray, state)
    return dict(loss=float(metrics["loss"]),
                state=state_dict_from_flax(state.params, state.batch_stats, state.constants))


def test_train_step_matches_the_jax_mesh_step(ranks, jax_step):
    want = jax_step["state"]
    before = ranks["cases"]["step"]["rank"]["state"]
    names = [k for k in want if not k.endswith("num_batches_tracked")]
    for got in ranks["got"]:
        assert abs(got["step"]["loss"] - jax_step["loss"]) <= STEP_LOSS_TOL
        state = got["step"]["state"]
        diff = np.sqrt(sum(np.sum((state[k].astype(np.float64) - want[k]) ** 2) for k in names))
        norm = np.sqrt(sum(np.sum(np.asarray(want[k], np.float64) ** 2) for k in names))
        moved = np.sqrt(sum(np.sum((np.asarray(want[k], np.float64) - before[k]) ** 2)
                            for k in names))
        assert moved / norm > WEIGHT_TOL  # the update is larger than the tolerance
        assert diff / norm <= WEIGHT_TOL, diff / norm


def test_a_non_finite_loss_on_one_rank_stops_every_rank(ranks, tmp_path):
    """The loss each rank reads back is the all-reduced one: a NaN on rank 1
    at step 1 stops both ranks after step 1 (exit code 1, as in one
    process), and neither waits in a collective for the other."""
    with pytest.raises(SystemExit) as stop:
        ddp.launch(torch_ddp_ranks.abort_on_a_non_finite_loss, WORLD, str(tmp_path),
                   ranks["cases"]["step"]["rank"], 1, 1, devices=["cpu"] * WORLD,
                   backend="gloo", dist_url=ddp.free_url())
    assert stop.value.code == 1
    for r in range(WORLD):
        assert (tmp_path / f"rank{r}.steps").read_text().split() == ["0", "1"], r
    # rank 0's own loss was finite: it stopped on the reduced one
    assert "Loss in not finite" in (tmp_path / "rank0.log").read_text()


def test_train_step_leaves_the_ranks_bit_equal(ranks):
    a, b = (g["step"]["state"] for g in ranks["got"])
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ranks["got"][0]["step"]["loss"] == ranks["got"][1]["step"]["loss"]


# ------------------------------------------------------------------ the build lock

_BUILD = """
import subprocess, sys
from pathlib import Path
import numpy as np
from coda_neurips2023_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
native.LIBRARY = native.BUILD_DIR / "libcoda_native_host.so"
run = subprocess.run
def counted(cmd, *a, **kw):
    with open(native.BUILD_DIR / "compiles.txt", "a") as f:
        f.write(" ".join(cmd) + "\\n")
    return run(cmd, *a, **kw)
native.subprocess.run = counted
boxes = np.array([[0, 0, 0, 1, 1, 1, 0.9, 0], [0, 0, 0, 1, 1, 1.1, 0.8, 0]], np.float32)
print(native.nms_3d_samecls(boxes, 0.25).tolist())
"""


def test_two_processes_build_the_host_library_once(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert [o[0].strip() for o in outs] == ["[0]", "[0]"]  # both loaded it
    assert len((tmp_path / "compiles.txt").read_text().splitlines()) == 1
    assert (tmp_path / "libcoda_native_host.so").exists()
