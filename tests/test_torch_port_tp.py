"""The port's tensor parallelism (parallel/tp.py) against the JAX package's, on the CPU.

Four gloo processes (`parallel.ddp.launch`, all on the CPU) in one launch
(tests/torch_ddp_ranks.py :: tensor_parallel) run every rank-side case;
the JAX package's side is its own parallel/tp.py on `make_tp_mesh(4, mp=2)`
of conftest's 8 virtual CPU devices, with one JAX compile for the file:

  (a) the rules: the port shards exactly the flax leaves that JAX
      `partition_spec` shards, on the same dim, for tests/test_train.py's
      tiny_setup model and a tiny CLIP of two vision heads, at mp 2 and 4;
      at mp 64 nothing; `tp_param_summary` equals the JAX function's, over
      the parameters and over the whole train state.  The port's
      parameters reach their flax leaves through the weight bridge: each
      flax leaf is filled with its own number and passed through
      `state_dict_from_flax`;
  (b) each process's slices, on the (dp 2, mp 2) grid, are bit for bit the
      JAX arrays' addressable shards on device d * mp + m of the mesh,
      passed through the bridge (which packs a device's q, k and v shards
      into the port's three row blocks);
  (c) two baseline training steps (dropout 0, the schedule's learning rate,
      clip 0.1) on (dp 2, mp 2) from the JAX weights against JAX's
      constrain_train_step(make_train_step(...)) on the mesh with
      shard_state_tp: the loss within rtol 5e-4, the gathered parameters
      within rtol 5e-4 / atol 5e-6 (tests/test_tp.py's tolerances); the
      clip's global norm is the whole gradient's and exceeds 0.1; the
      replicated parameters are bit-equal on all four processes and the
      shards on each block's dp peers; each step makes the mp all-reduces
      the model's blocks call for;
  (d) the stage-1 fused step with the tiny CLIP teacher sharded, on a
      (dp 1, mp 2) grid, against the port's one-process stage-1 step (held
      against JAX in tests/test_torch_port_stage1.py) at 1e-5;
  (e) dropout 0.1 on (dp 1, mp 2) against the one-process step with the same
      seed, at 1e-5: the FFN mask's columns and the dp index's generator;
  (f) a grid whose mp divides no head count and no FFN width: the rules
      replicate everything, as at mp 64 in (a), and the step is the
      one-process step bit for bit;
  (g) one bf16 step (compute_dtype bfloat16) on (dp 1, mp 2) against the
      one-process bf16 step: the loss and the state after the step at
      PAIR_TOL, the gradients within BF16_PAIR_GRAD_TOL of their norm (5.2e-4
      measured), its biases drawn, not flax's zeros, so that a bias added
      at the wrong precision shows;
  and on (c)'s grid a checkpoint written by every process (whole tensors,
  process 0 writes), resumed into a fresh sharded model, and
  ddp.broadcast_state of a sharded model.

After (b) and (c) on the four processes' grid, processes 0-1 and 2-3 each
join a process group of two: the first pair runs (d) and (e), the second
(f) and (g); then each process leaves its group and steps one of the four
one-process references, in one thread as the ranks step.
"""

import functools
import threading
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coda_neurips2023_tpu import criterion as jcriterion
from coda_neurips2023_tpu import engine as jengine
from coda_neurips2023_tpu import optimizer as joptimizer
from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig
from coda_neurips2023_tpu.engine import _TARGET_KEYS as JAX_TARGET_KEYS
from coda_neurips2023_tpu.engine import create_train_state
from coda_neurips2023_tpu.models import clip as jclip
from coda_neurips2023_tpu.models import model_3detr as jmodel
from coda_neurips2023_tpu.parallel.mesh import shard_batch
from coda_neurips2023_tpu.parallel.tp import (
    constrain_train_step,
    make_tp_mesh,
    partition_spec,
    shard_state_tp,
    tp_param_summary,
)

from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.datasets.loader import make_loader
from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset
from coda_neurips2023_tpu_torch.models.clip import CLIP
from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
from coda_neurips2023_tpu_torch.optimizer import build_optimizer
from coda_neurips2023_tpu_torch.parallel import ddp, tp
from coda_neurips2023_tpu_torch.utils.weights import (
    clip_state_dict_from_flax,
    state_dict_from_flax,
)

import torch_ddp_ranks
from test_torch_port_clip import TINY_CLIP, _perturb_clip
from test_torch_port_model import TINY, _perturb
from test_torch_port_stage1 import STAGE1_ARGS, _image_scenes
from test_torch_port_train import BASELINE_ARGS, NO_DROPOUT, _scenes
from test_train import tiny_setup
from torch_one_thread import one_intra_op_thread  # noqa: F401

WORLD = 4
MP = 2
# tests/test_tp.py's tolerances of a grid step against the dp-only step
LOSS_RTOL = 5e-4
PARAM_RTOL, PARAM_ATOL = 5e-4, 5e-6
# a (dp 1, mp 2) step against the one-process step: the row-parallel
# products sum their two halves in another order, nothing else differs
PAIR_TOL = 1e-5
# (g)'s bf16 gradients, the largest element's difference as a share of the
# gradient's norm: 5.2e-4 measured (an ulp of bf16 on the largest
# gradients).  A row-parallel product whose bias is added before the bf16
# rounding moves the loss 1.9e-3, the state 3.1e-3 and the gradients
# 1.4e-2; one whose sum is not rounded, 1.3e-3, 2.7e-3 and 1.1e-2
BF16_PAIR_GRAD_TOL = 2e-3
STEPS = 2
# the tiny CLIP of tests/test_torch_port_clip.py at a vision width of two
# heads (vision heads = width // 64), so that mp 2 shards its attention
TP_CLIP = dict(TINY_CLIP, vision_width=128)
# heads and FFN widths that mp 2 divides none of
UNSHARDABLE = dict(TINY, enc_dim=48, dec_dim=48, enc_nhead=3, dec_nhead=3, enc_ffn_dim=33,
                   dec_ffn_dim=33)
FWD_KEYS = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")
# the RankLoader on the grid: 3 global batches of 2 rows a dp block
LOADER_SCENES = dict(num_scenes=12, num_points=64, seed=2)
# (c)'s detector: tests/test_torch_port_model.py's at tests/test_tp.py's two
# decoder layers, which keep the JAX compile short
GRID_MODEL = dict(TINY, dec_nlayers=2)


def _dim(spec):
    return list(spec).index("mp") if "mp" in tuple(spec) else None


def _numbered(tree):
    """The tree with each leaf filled with its own number, and the leaves'
    paths in that order."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    paths = ["/" + "/".join(str(k.key) for k in path) for path, _ in flat]
    leaves = [np.full(leaf.shape, i, np.int64) for i, (_, leaf) in enumerate(flat)]
    return jax.tree_util.tree_unflatten(treedef, leaves), paths


def _zeros(tree):
    return jax.tree.map(lambda x: np.zeros(x.shape, np.float32), tree)


# ------------------------------------------------------------------ the cases


def _grid_step_case():
    """(c): the tiny baseline detector initialised in flax and perturbed, 2
    scenes a dp block."""
    batch = _scenes(2 * (WORLD // MP))
    jm = jmodel.CoDA3DETR(dataset_config=JaxConfig(), with_text_head=False, **NO_DROPOUT,
                          **GRID_MODEL)
    variables = jax.jit(lambda r, b: jm.init(r, b, train=False))(
        jax.random.PRNGKey(0), {k: batch[k][:2] for k in FWD_KEYS})
    variables = _perturb(variables, 0)
    state = state_dict_from_flax(variables["params"], variables["batch_stats"],
                                 variables["constants"])
    rank = dict(model=dict(with_text_head=False, **NO_DROPOUT, **GRID_MODEL),
                args=dict(BASELINE_ARGS),
                state={k: np.asarray(v) for k, v in state.items()}, steps=STEPS,
                batch={k: batch[k] for k in (*FWD_KEYS, *JAX_TARGET_KEYS) if k in batch})
    return dict(jm=jm, variables=variables, rank=rank)


def _pair_cases(clip_state):
    scenes = _scenes(2)
    batch = {k: scenes[k] for k in (*FWD_KEYS, *JAX_TARGET_KEYS) if k in scenes}
    baseline = dict(args=dict(BASELINE_ARGS), batch=batch, init_seed=3, steps=STEPS)
    images = _image_scenes(2, seed=1)
    images["distillation_sel"] = np.stack([np.arange(8), np.arange(8)[::-1]]).astype(np.int64)
    stage1 = dict(model=dict(TINY, **NO_DROPOUT), args=dict(STAGE1_ARGS), batch=images,
                  init_seed=4, steps=1, clip=dict(config=TP_CLIP, state=clip_state))
    drop = dict(mlp_dropout=0.1, enc_dropout=0.1, dec_dropout=0.1)
    return [
        {"stage1": stage1,
         "dropout": dict(baseline, model=dict(TINY, with_text_head=False, **drop), seed=11)},
        {"unsharded": dict(baseline, model=dict(UNSHARDABLE, with_text_head=False, **NO_DROPOUT)),
         "bf16": dict(baseline, model=dict(TINY, with_text_head=False, **NO_DROPOUT,
                                           compute_dtype=torch.bfloat16), steps=1,
                     bias_scale=0.1)},
    ]


def _jax_grid_steps(case):
    """(b)'s sharded state and (c)'s steps on make_tp_mesh(4, mp=2)."""
    args = types.SimpleNamespace(**case["rank"]["args"])
    v = case["variables"]
    tx, schedule = joptimizer.build_optimizer(args, None, 600)
    state = jengine.TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                               batch_stats=v["batch_stats"], constants=v["constants"],
                               opt_state=tx.init(v["params"]))
    step = jengine.make_train_step(case["jm"], jcriterion.build_criterion(
        args, JaxConfig(), num_replicas=WORLD // MP), tx, lr_schedule=schedule)
    mesh = make_tp_mesh(WORLD, mp=MP)
    state = shard_state_tp(mesh, state)
    sharded = state.params
    step = constrain_train_step(step, mesh, state)
    batch = shard_batch(mesh, case["rank"]["batch"])
    losses = []
    for i in range(STEPS):
        state, metrics = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
    params = jax.tree.map(np.asarray, state.params)
    return dict(mesh=mesh, sharded=sharded, losses=losses,
                params=state_dict_from_flax(params, _zeros(state.batch_stats), {}))


def _jax_clip_params():
    """tests/test_torch_port_clip.py's perturbed flax CLIP of TP_CLIP, its
    init jitted."""
    jm = jclip.CLIP(**TP_CLIP)
    res, ctx = TP_CLIP["image_resolution"], TP_CLIP["context_length"]
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, res, res, 3)),
                              jnp.zeros((1, ctx), jnp.int32))["params"]
    return _perturb_clip(params, 0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four processes' results (their one-process references too) and
    JAX's grid steps, which this process compiles and steps while the ranks
    run."""
    clip_params = _jax_clip_params()
    clip_state = {k: np.asarray(v) for k, v in clip_state_dict_from_flax(clip_params).items()}
    grid_case = _grid_step_case()
    out = tmp_path_factory.mktemp("tp")
    errors = []

    def launch():
        try:
            ddp.launch(torch_ddp_ranks.tensor_parallel, WORLD, str(out),
                       dict(clip=dict(config=TP_CLIP, state=clip_state), loader=LOADER_SCENES,
                            steps={"grid": grid_case["rank"]}),
                       _pair_cases(clip_state), [ddp.free_url(), ddp.free_url()],
                       devices=["cpu"] * WORLD, backend="gloo", dist_url=ddp.free_url())
        except BaseException as e:  # re-raised below, in the test's thread
            errors.append(e)

    thread = threading.Thread(target=launch)
    thread.start()
    try:
        jax_grid = _jax_grid_steps(grid_case)
    finally:
        thread.join()
    if errors:
        raise errors[0]
    got = torch_ddp_ranks.load_ranks(str(out), WORLD)
    one = {name: ref for g in got for name, ref in g["one"].items()}
    return dict(got=got, jax=jax_grid, one=one, clip_params=clip_params, grid_case=grid_case,
                out=out)


# ------------------------------------------------------------------ (a) the rules


@functools.lru_cache(maxsize=None)
def _detector_trees():
    cfg, model, batch, criterion, tx, schedule = tiny_setup(batch_size=2)
    state = jax.eval_shape(lambda: create_train_state(model, tx, jax.random.PRNGKey(0), batch))
    port = CoDA3DETR(SunrgbdAnonymousConfig(), enc_dim=32, dec_dim=64, enc_nlayers=2,
                     dec_nlayers=2, enc_ffn_dim=32, dec_ffn_dim=32, preenc_npoints=64,
                     nqueries=16)
    args = types.SimpleNamespace(weight_decay=0.1, clip_gradient=0.1, filter_biases_wd=False,
                                 **{k: BASELINE_ARGS[k] for k in (
                                     "base_lr", "warm_lr", "warm_lr_epochs", "final_lr",
                                     "lr_scheduler", "max_epoch")})
    optimizer, _ = build_optimizer(args, port, 4)

    def bridge(numbered):
        return state_dict_from_flax(numbered, _zeros(state.batch_stats), _zeros(state.constants))

    return state.params, state, port, optimizer, bridge


def _clip_trees():
    res, ctx = TP_CLIP["image_resolution"], TP_CLIP["context_length"]
    params = jax.eval_shape(lambda: jclip.CLIP(**TP_CLIP).init(
        jax.random.PRNGKey(0), jnp.zeros((1, res, res, 3)), jnp.zeros((1, ctx), jnp.int32)))
    return params["params"], None, CLIP(**TP_CLIP), None, clip_state_dict_from_flax


@pytest.mark.parametrize("model", ["detector", "clip"])
@pytest.mark.parametrize("mp", [2, 4, 64])
def test_rules_shard_the_jax_leaves(model, mp):
    params, state, port, optimizer, bridge = (_detector_trees if model == "detector"
                                              else _clip_trees)()
    numbered, paths = _numbered(params)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    want = [_dim(partition_spec(path, leaf, mp)) for path, leaf in flat]
    by_param = {n: [paths[i] for i in np.unique(v)] for n, v in bridge(numbered).items()
                if n in dict(port.named_parameters())}
    assert set(by_param) == set(dict(port.named_parameters()))
    specs = tp.flax_specs(port, mp)
    n_sharded = 0
    for name, leaves in by_param.items():
        dims = [want[paths.index(p)] for p in leaves]
        if name not in specs:
            assert dims == [None] * len(dims), name
            continue
        got = specs[name]
        assert len(got) == len(leaves), name
        for rel, dim in got.items():
            (path,) = [p for p in leaves if p.endswith(rel)]
            assert dim == want[paths.index(path)], (name, path, dim)
            n_sharded += dim is not None
    # mp 64 divides no width of the tiny detector (tests/test_tp.py); the
    # CLIP's c_fc and c_proj (4 x 128 hidden units) it divides, its 2 heads not
    assert (n_sharded == 0) == (mp == 64 and model == "detector"), n_sharded
    assert tp.tp_param_summary(port, mp) == tp_param_summary(params, mp)
    if state is not None:  # the whole train state: params, mu, nu and the rest
        assert tp.tp_param_summary(port, mp, optimizer) == tp_param_summary(state, mp)


def test_trivial_grid_outside_a_process_group():
    grid = tp.make_tp_grid(1)
    assert (grid.dp, grid.mp, grid.mp_group) == (1, 1, None)
    port = CLIP(**TP_CLIP)
    before = dict(port.named_parameters())
    assert tp.shard_state_tp(grid, port) is port
    assert dict(port.named_parameters()) == before
    x = torch.ones(2)
    assert tp.copy_to_mp(x, grid=grid)[0] is x
    with pytest.raises(ValueError, match="does not divide"):
        tp.make_tp_grid(2)


def test_grid_layout(runs):
    for r, got in enumerate(runs["got"]):
        d, m = divmod(r, MP)
        assert got["layout"] == dict(dp=WORLD // MP, mp=MP, dp_rank=d, mp_rank=m,
                                   world=WORLD // MP, rank=d, primary=r == 0)


def test_rank_loader_gives_each_block_its_rows(runs):
    """Process 0 runs the loader and sends dp block d's rows to both of its
    mp processes (ddp.rows at the dp rank and the dp size)."""
    loader = make_loader(SyntheticDetectionDataset(SunrgbdAnonymousConfig(), **LOADER_SCENES),
                         2 * (WORLD // MP), shuffle=True, seed=5, num_workers=1)
    want = [b["scan_idx"].tolist() for b in loader]
    assert len(want) == 3
    for r, got in enumerate(runs["got"]):
        d = r // MP
        assert got["loader"] == [w[2 * d:2 * d + 2] for w in want], r


# ------------------------------------------------------------------ (b) the slices


def _device_shard(tree, device):
    return jax.tree.map(
        lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == device)),
        tree)


@pytest.mark.parametrize("model", ["detector", "clip"])
def test_slices_are_the_jax_shards(runs, model):
    mesh = runs["jax"]["mesh"]
    devices = list(mesh.devices.flat)
    if model == "detector":
        v = runs["grid_case"]["variables"]
        tree = runs["jax"]["sharded"]
        bridge = lambda p: state_dict_from_flax(p, v["batch_stats"], v["constants"])  # noqa
    else:
        sharded = shard_state_tp(mesh, {"params": runs["clip_params"]})
        tree = sharded["params"]
        bridge = clip_state_dict_from_flax
    for r, got in enumerate(runs["got"]):
        slices = got["grid"]["slices"] if model == "detector" else got["clip_slices"]
        assert slices, r
        want = bridge(_device_shard(tree, devices[r]))
        for name, local in slices.items():
            np.testing.assert_array_equal(local, want[name], err_msg=f"process {r}: {name}")
    if model == "detector":
        for got in runs["got"]:
            grid = got["grid"]
            assert grid["optimizer_holds_the_slices"]
            for name, (mu, nu) in grid["moment_shapes"].items():
                assert mu == nu == (grid["slices"][name].shape if name in grid["slices"]
                                    else grid["state"][name].shape), name
    else:  # the gather puts the whole CLIP back together on every process
        whole = clip_state_dict_from_flax(runs["clip_params"])
        for got in runs["got"]:
            for name, w in whole.items():
                np.testing.assert_array_equal(got["clip_whole"][name], w, err_msg=name)


# ------------------------------------------------------------------ (c) the grid's steps


def test_grid_steps_match_the_jax_mesh_steps(runs):
    want = runs["jax"]
    names = set(want["params"]) & set(runs["grid_case"]["rank"]["state"])
    for r, got in enumerate(runs["got"]):
        got = got["grid"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        for name in sorted(n for n in names if not n.endswith(
                ("running_mean", "running_var", "num_batches_tracked"))):
            np.testing.assert_allclose(got["state"][name], want["params"][name], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=f"process {r}: {name}")
        assert got["sharded"], "the rules sharded nothing"


def test_clip_norm_counts_each_shard_once(runs):
    for got in runs["got"]:
        got = got["grid"]
        whole = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in got["grads"].values()))
        clip = BASELINE_ARGS["clip_gradient"]
        np.testing.assert_allclose(got["norms"][-1], whole, rtol=1e-5)
        assert all(n > clip for n in got["norms"]), got["norms"]  # the clip triggers


def test_replicas_bit_equal_and_shards_equal_on_dp_peers(runs):
    local = [got["grid"]["local"] for got in runs["got"]]
    sharded = set(runs["got"][0]["grid"]["sharded"])
    for name in local[0]:
        for r in range(1, WORLD):
            # a replica as process 0's; a shard as its dp peer's of block 0
            peer = r % MP if name in sharded else 0
            np.testing.assert_array_equal(local[r][name], local[peer][name], err_msg=name)
        if name in sharded:
            assert local[1][name].shape == local[0][name].shape
            assert not np.array_equal(local[1][name], local[0][name]), name


def test_each_step_makes_the_blocks_all_reduces(runs):
    enc, dec = GRID_MODEL["enc_nlayers"], GRID_MODEL["dec_nlayers"]
    case = runs["grid_case"]["rank"]["batch"]
    b = len(case["point_clouds"]) // (WORLD // MP)
    nq, n_enc = GRID_MODEL["nqueries"], GRID_MODEL["preenc_npoints"]
    # forward: out_proj and linear2 of each encoder layer, the decoder's two
    # out_proj and linear2; backward: copy_to_mp's gradient, once for each
    # distinct input of a column-parallel product: the encoder's
    # self-attention takes one tensor (no position embedding) and linear1
    # one, the decoder's self-attention two (the queries with and without
    # their embedding), its cross-attention three and linear1 one
    want = dict(forward=2 * enc + 3 * dec, backward=2 * enc + 6 * dec, norm=1,
                forward_bytes=4 * b * (enc * 2 * n_enc * GRID_MODEL["enc_dim"]
                                       + dec * 3 * nq * GRID_MODEL["dec_dim"]))
    for got in runs["got"]:
        for counts in got["grid"]["counts"]:
            assert {k: counts[k] for k in want} == want, counts
            assert counts["backward_bytes"] > 0


# ------------------------------------------------------------------ checkpoints on the grid


def test_checkpoint_under_the_grid_holds_whole_tensors(runs):
    """Every process calls save_checkpoint after (c)'s steps; process 0 writes
    the gathered weights and AdamW moments, whole, as the JAX package writes
    a sharded state."""
    assert [got["grid"]["wrote"] for got in runs["got"]] == [True] + [False] * (WORLD - 1)
    ckpt = torch.load(runs["out"] / "grid" / "checkpoint.pth", weights_only=True)
    grid = runs["got"][0]["grid"]
    whole = runs["grid_case"]["rank"]["state"]
    assert set(ckpt["model"]) == set(grid["state"]) == set(whole)
    for k, w in grid["state"].items():
        assert tuple(ckpt["model"][k].shape) == whole[k].shape, k
        np.testing.assert_array_equal(ckpt["model"][k].numpy(), w, err_msg=k)
    params = dict(CoDA3DETR(SunrgbdAnonymousConfig(), **runs["grid_case"]["rank"]["model"])
                  .named_parameters())
    for key in ("mu", "nu"):
        assert set(ckpt["optimizer"][key]) == set(grid["moments"][key])
        for n, w in grid["moments"][key].items():
            assert ckpt["optimizer"][key][n].shape == params[n].shape, (key, n)
            np.testing.assert_array_equal(ckpt["optimizer"][key][n].numpy(), w,
                                          err_msg=f"{key} {n}")
    assert (ckpt["optimizer"]["count"], ckpt["epoch"]) == (STEPS, 3)


def test_resume_under_the_grid_keeps_each_process_slices(runs):
    """A fresh sharded model and optimizer resumed from that checkpoint hold
    each process's own slices, moments and step count, bit for bit."""
    for r, got in enumerate(runs["got"]):
        got = got["grid"]
        assert got["epoch"] == 3
        want, have = got["trained"], got["resumed"]
        assert have["count"] == want["count"] == STEPS
        for n, w in want["params"].items():
            np.testing.assert_array_equal(have["params"][n], w, err_msg=f"process {r}: {n}")
        for key in ("mu", "nu"):
            for i, (h, w) in enumerate(zip(have[key], want[key])):
                np.testing.assert_array_equal(h, w, err_msg=f"process {r}: {key}[{i}]")


def test_broadcast_state_sends_each_shard_from_its_own_process(runs):
    """ddp.broadcast_state on a sharded model drawn from another seed in each
    dp block: afterwards every process holds block 0's model (init seed
    100), shards from their own shard's process, not process 0's."""
    model = CoDA3DETR(SunrgbdAnonymousConfig(), **runs["grid_case"]["rank"]["model"])
    reset_parameters(model, torch.Generator().manual_seed(100))
    want = model.state_dict()
    for r, got in enumerate(runs["got"]):
        got = got["grid"]["broadcast"]
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w.numpy(), err_msg=f"process {r}: {k}")


# ------------------------------------------------------------------ (d)-(g) on (dp 1, mp 2)


def _grad_err(got, want):
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in want.values()))
    return max(float(np.abs(got[n].astype(np.float64) - want[n]).max()) for n in want) / norm


def _pair(runs, name):
    pair = 0 if name in ("stage1", "dropout") else 1
    return [runs["got"][2 * pair + m][name] for m in range(MP)], runs["one"][name]


@pytest.mark.parametrize("name", ["stage1", "dropout"])
def test_pair_step_is_the_one_process_step(runs, name):
    """(d) the stage-1 step with its CLIP teacher sharded, (e) dropout 0.1."""
    grid, one = _pair(runs, name)
    for got in grid:
        assert got["sharded"] and got["summary"][0] > 0
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=PAIR_TOL)
        assert _grad_err(got["grads"], one["grads"]) <= PAIR_TOL
        for k, w in one["state"].items():
            np.testing.assert_allclose(got["state"][k], w, rtol=0, atol=PAIR_TOL, err_msg=k)
    if name == "stage1":  # the teacher's blocks all-reduce too: two a tower block
        tower = TP_CLIP["vision_layers"]
        assert grid[0]["counts"][0]["forward"] == (
            2 * TINY["enc_nlayers"] + 3 * TINY["dec_nlayers"] + 2 * tower)


def test_unsharded_grid_step_is_the_one_process_step(runs):
    """(f) nothing sharded: the blocks stay off the grid and nothing is summed
    over it, so the step is the one-process step bit for bit."""
    grid, one = _pair(runs, "unsharded")
    for got in grid:
        assert got["sharded"] == [] and got["summary"][0] == 0
        assert got["losses"] == one["losses"] and got["norms"] == one["norms"]
        assert got["counts"][0] == dict.fromkeys(tp.COUNTS, 0)
        for k, w in one["state"].items():
            np.testing.assert_array_equal(got["state"][k], w, err_msg=k)


def test_bf16_pair_step_is_the_one_process_step(runs):
    """(g): the row-parallel products' bf16 sums round once, as in one
    process, from fp32 halves summed in another order; copy_to_mp's bf16
    partial gradients are rounded before their sum, where one process
    rounds the whole product once."""
    grid, one = _pair(runs, "bf16")
    for got in grid:
        assert got["sharded"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=PAIR_TOL)
        assert _grad_err(got["grads"], one["grads"]) <= BF16_PAIR_GRAD_TOL
        for k, w in one["state"].items():
            np.testing.assert_allclose(got["state"][k], w, rtol=0, atol=PAIR_TOL, err_msg=k)
