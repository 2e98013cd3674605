"""The port's radius-masked encoder (--enc_type masked) against the JAX package on the CPU.

A tiny masked CoDA3DETR (enc 32, dec 64, 64 pre-encoder points, so 32
after the interim set abstraction; the size of tests/test_masked_encoder.py)
is initialised in flax, perturbed so that no norm is an identity, and
bridged to the port (`utils.weights`, which now maps
`encoder.interim_downsampling.*`).  The JAX side runs its CPU path: flax's
MultiHeadDotProductAttention with the (B, 1, S, S) radius mask (its fused
Pallas layer is taken only on a TPU).  Held:

  * the bridge's names, a strict load, a strict `.pth` restore, and its
    refusal of a flax key it does not map;
  * the masked encoder alone and the whole forward at 256 and 1024 points,
    and the eval step: integer outputs (`enc_inds` composed through both
    samplings) exactly, floats within 1e-4;
  * one training step at dropout 0, at 256 pre-encoder points, against
    the same step in float64 (the port's model in double, its indices from
    the same fp32 coordinates, plain gathers and attention): loss 1e-4,
    gradients 1e-4 of their global norm (the interim SA's included) and the
    BatchNorm statistics 1e-5, the tolerances of tests/test_torch_port_train.py;
    the JAX step's distance from it is printed beside;
  * that step against the JAX train step: loss 1e-4, gradients
    MASKED_GRAD_TOL of their global norm and the BatchNorm statistics
    MASKED_BN_TOL.  These are looser than the vanilla step's 1e-4 and 1e-5
    because the JAX reference rounds more there (its gradients lie about
    1.2e-3 of the norm from the float64 step, the port's about 5e-5): the
    interim SA's first BatchNorm takes E[x^2] - E[x]^2 of convs of the
    encoder's residual stream (a mean of about 3.5 against a variance of
    0.3, so the difference cancels 80-fold) over B * npoint * nsample rows,
    and XLA's CPU reduction leaves about 3e-4 of the batch variance in
    that, which training-mode BatchNorm carries into every gradient.
    `test_interim_sa_train_mode_matches_float64` holds the set abstraction
    alone against float64 too: the port within 1e-5 of the output's size,
    where the JAX package's is off by about 3e-5;
  * --remat: the training step with activation checkpointing equals the
    step without it bit for bit (loss, every gradient, the weights after
    AdamW, the BatchNorm statistics) at the shipped dropout, for the
    vanilla and the masked encoder; and `main` trains with --remat.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coda_neurips2023_tpu import criterion as jcriterion
from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig
from coda_neurips2023_tpu.engine import _TARGET_KEYS as JAX_TARGET_KEYS
from coda_neurips2023_tpu.engine import TrainState
from coda_neurips2023_tpu.engine import make_eval_step as jax_make_eval_step
from coda_neurips2023_tpu.models import model_3detr as jmodel
from coda_neurips2023_tpu.models import transformer as jtransformer

from coda_neurips2023_tpu_torch import main as tmain
from coda_neurips2023_tpu_torch.criterion import build_criterion
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.engine import make_eval_step, make_train_step
from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
from coda_neurips2023_tpu_torch.models import model_3detr as pmodel
from coda_neurips2023_tpu_torch.models import pointnet as ppointnet
from coda_neurips2023_tpu_torch.models import transformer as ptransformer
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
from coda_neurips2023_tpu_torch.models.transformer import MASKING_RADIUS
from coda_neurips2023_tpu_torch.ops.grouping import ball_query
from coda_neurips2023_tpu_torch.ops.masked_attention import masked_attention_plain
from coda_neurips2023_tpu_torch.ops.sampling import furthest_point_sample
from coda_neurips2023_tpu_torch.optimizer import build_optimizer
from coda_neurips2023_tpu_torch.utils.io import restore_params_only
from coda_neurips2023_tpu_torch.utils.weights import grads_from_flax, state_dict_from_flax, to_torch

from test_torch_port_model import _assert_outputs_match, _batch, _build, _close, _perturb, _t
from test_torch_port_train import (
    BN_TOL,
    GRAD_TOL,
    NO_DROPOUT,
    STEP_LOSS_TOL,
    _args,
    _np,
    _scenes,
)
from torch_one_thread import one_intra_op_thread  # noqa: F401

MASKED = dict(enc_dim=32, dec_dim=64, enc_type="masked", enc_ffn_dim=32, dec_nlayers=2,
              dec_ffn_dim=32, preenc_npoints=64, nqueries=16)
INTERIM = MASKED["preenc_npoints"] // 2
TRAIN_MASKED = dict(MASKED, preenc_npoints=256)
MASKED_GRAD_TOL = 2e-3
MASKED_BN_TOL = 1e-4


@pytest.fixture(scope="module", params=[256, 1024], ids=["256pts", "1024pts"])
def masked(request):
    batch = _batch(2, request.param)
    jm, variables, sd, tm = _build(MASKED, batch, seed=2)
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, batch)
    return dict(batch=batch, jm=jm, variables=variables, sd=sd, tm=tm,
                want=jax.tree.map(np.asarray, want))


def test_bridge_maps_the_interim_downsampling(masked):
    sd, tm = masked["sd"], masked["tm"]
    interim = sorted(k for k in sd if k.startswith("encoder.interim_downsampling."))
    assert len(interim) == 3 * 6  # 3 convs, each a weight and a BN of 5 entries
    for i, (o, c) in enumerate([(256, MASKED["enc_dim"] + 3), (256, 256),
                                (MASKED["enc_dim"], 256)]):
        prefix = f"encoder.interim_downsampling.mlp_module.layer{i}"
        assert sd[prefix + ".conv.weight"].shape == (o, c, 1, 1)
        for name in ("weight", "bias", "running_mean", "running_var"):
            np.testing.assert_array_equal(tm.state_dict()[f"{prefix}.bn.bn.{name}"].numpy(),
                                          sd[f"{prefix}.bn.bn.{name}"])
    assert sorted(k for k in sd if k.startswith("encoder.layers.")) == sorted(
        k for k in tm.state_dict() if k.startswith("encoder.layers."))
    assert {k.split(".")[2] for k in sd if k.startswith("encoder.layers.")} == {"0", "1", "2"}


def _with(tree, path, value):
    """A copy of the nested dict `tree` with `value` at `path`."""
    out = dict(tree)
    if len(path) == 1:
        out[path[0]] = value
    else:
        out[path[0]] = _with(tree[path[0]], path[1:], value)
    return out


@pytest.mark.parametrize("path", [
    ("stray_head",),
    ("encoder", "interim_upsampling"),
    ("encoder", "interim_downsampling", "extra_mlp"),
    ("encoder", "interim_downsampling", "mlp_module", "conv9"),
    ("encoder", "layer0", "norm3"),
    ("decoder", "layer1", "norm4"),
    ("sem_cls_head", "norm7"),
], ids=lambda p: ".".join(p))
def test_bridge_raises_on_a_key_it_does_not_map(masked, path):
    v = masked["variables"]
    params = _with(v["params"], path, {"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match=path[-1]):
        state_dict_from_flax(params, v["batch_stats"], v["constants"])


def test_masked_pth_restores_strictly(masked, tmp_path):
    sd = to_torch(masked["sd"])
    torch.save({"model": sd, "epoch": 3}, tmp_path / "masked.pth")
    model = CoDA3DETR(SunrgbdAnonymousConfig(), **MASKED, device="cpu")
    loaded = restore_params_only(str(tmp_path / "masked.pth"), model)
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    del sd["encoder.interim_downsampling.mlp_module.layer1.bn.bn.running_var"]
    torch.save({"model": sd}, tmp_path / "short.pth")
    with pytest.raises(ValueError, match="interim_downsampling"):
        restore_params_only(str(tmp_path / "short.pth"), model)


def test_masked_encoder_matches_jax(masked):
    rng = np.random.default_rng(3)
    s, d = MASKED["preenc_npoints"], MASKED["enc_dim"]
    src = rng.standard_normal((2, s, d)).astype(np.float32)
    xyz = rng.uniform(-1.5, 1.5, (2, s, 3)).astype(np.float32)
    jenc = jtransformer.MaskedTransformerEncoder(
        num_layers=3, d_model=d, masking_radius=MASKING_RADIUS, interim_npoint=INTERIM,
        nhead=4, dim_feedforward=MASKED["enc_ffn_dim"])
    v = masked["variables"]
    want = jenc.apply({"params": v["params"]["encoder"],
                       "batch_stats": v["batch_stats"]["encoder"]},
                      jnp.asarray(src), jnp.asarray(xyz), train=False)
    with torch.inference_mode():
        got = masked["tm"].encoder(torch.from_numpy(src), torch.from_numpy(xyz))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1], what="features")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].dtype == torch.int32 and tuple(got[2].shape) == (2, INTERIM)


def test_masked_forward_matches_jax(masked):
    with torch.inference_mode():
        got = masked["tm"](_t(masked["batch"]))
    assert tuple(got["enc_inds"].shape) == (2, INTERIM)
    assert tuple(got["enc_xyz"].shape) == (2, INTERIM, 3)
    # enc_inds index the input cloud: the points they name are enc_xyz
    pc = torch.from_numpy(masked["batch"]["point_clouds"])
    picked = torch.gather(pc[..., :3], 1, got["enc_inds"].long()[..., None].expand(-1, -1, 3))
    torch.testing.assert_close(picked, got["enc_xyz"], rtol=0, atol=0)
    _assert_outputs_match(got, masked["want"])


def test_masked_eval_step_matches_jax(masked):
    v = masked["variables"]
    rng = np.random.default_rng(6)
    bank = rng.standard_normal((46, 512)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], constants=v["constants"], opt_state=())
    want = jax_make_eval_step(masked["jm"], eval_text_features=jnp.asarray(bank))(
        state, masked["batch"])
    got = make_eval_step(masked["tm"], eval_text_features=torch.from_numpy(bank))(
        _t(masked["batch"]))
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], what=key)


# ---------------------------------------------------------------- training


@pytest.fixture(scope="module")
def masked_train():
    """The tiny masked baseline detector (no text head, dropout 0) in flax
    and the port, one training step of each."""
    batch = _scenes(2)
    jm = jmodel.CoDA3DETR(dataset_config=JaxConfig(), with_text_head=False, **NO_DROPOUT,
                          **TRAIN_MASKED)
    fwd = {k: batch[k] for k in ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")}
    v = _perturb(jax.jit(lambda r, b: jm.init(r, b, train=False))(jax.random.PRNGKey(4), fwd), 4)
    crit = jcriterion.build_criterion(_args(), JaxConfig())
    jbatch = {k: jnp.asarray(batch[k]) for k in (*fwd, *JAX_TARGET_KEYS) if k in batch}

    def loss_fn(params):
        out, mutated = jm.apply({"params": params, "batch_stats": v["batch_stats"],
                                 "constants": v["constants"]}, jbatch, train=True,
                                rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        loss, loss_dict = crit(out, {k: jbatch[k] for k in JAX_TARGET_KEYS if k in jbatch})
        return loss, (loss_dict, mutated["batch_stats"])

    (loss, (loss_dict, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    want = jax.tree.map(np.asarray, dict(loss=loss, loss_dict=loss_dict, stats=stats, grads=grads))

    tm = CoDA3DETR(SunrgbdAnonymousConfig(), with_text_head=False, **NO_DROPOUT, **TRAIN_MASKED)
    tm.load_state_dict(to_torch(state_dict_from_flax(v["params"], v["batch_stats"],
                                                     v["constants"])), strict=True)
    opt, sched = build_optimizer(_args(), tm, 600)
    step = make_train_step(tm, build_criterion(_args(), SunrgbdAnonymousConfig()), opt, sched)
    metrics = step({k: torch.from_numpy(x) for k, x in batch.items()},
                   torch.Generator().manual_seed(0))
    got = dict(metrics=metrics, grads={n: p.grad.clone() for n, p in tm.named_parameters()},
               state=tm.state_dict())
    return dict(variables=v, want=want, got=got)


def test_masked_train_step_loss_matches_jax(masked_train):
    got, want = masked_train["got"]["metrics"], masked_train["want"]
    _close(got["loss"], want["loss"], STEP_LOSS_TOL, "loss")
    for key, w in want["loss_dict"].items():
        _close(got[key], w, STEP_LOSS_TOL, key)


def test_masked_train_step_gradients_match_jax(masked_train):
    want = grads_from_flax(masked_train["want"]["grads"])
    got = masked_train["got"]["grads"]
    assert set(got) == set(want)
    assert sum(k.startswith("encoder.interim_downsampling.") for k in want) == 3 * 3
    norm = np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2) for g in want.values()))
    assert norm > 0
    for name, w in want.items():
        err = np.abs(_np(got[name]) - np.asarray(w)).max() / norm
        assert err <= MASKED_GRAD_TOL, (name, err)
    interim = [k for k in want if k.startswith("encoder.interim_downsampling.")]
    assert max(np.abs(np.asarray(want[k])).max() for k in interim) > 0  # it is trained


def test_masked_train_step_batchnorm_statistics_match_jax(masked_train):
    v = masked_train["variables"]
    want = state_dict_from_flax(v["params"], masked_train["want"]["stats"], v["constants"])
    got = masked_train["got"]["state"]
    names = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * (3 + 3 + 3 + 2 * 5)  # SA 3, interim SA 3, enc-to-dec 3, heads
    for name in names:
        _close(got[name], want[name], MASKED_BN_TOL * max(1.0, np.abs(want[name]).max()), name)


def _fps64(xyz, npoint):
    return furthest_point_sample(xyz.float(), npoint)


def _gather64(points, idx):
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, points.shape[-1]))


def _query_and_group64(radius, nsample, xyz, new_xyz, features=None, normalize_xyz=False):
    idx = ball_query(radius, nsample, xyz.float(), new_xyz.float()).long()
    rows = torch.arange(xyz.shape[0])[:, None, None]
    grouped = xyz[rows, idx] - new_xyz[:, :, None]
    if normalize_xyz:
        grouped = grouped / radius
    if features is None:
        return grouped, grouped
    return torch.cat([grouped, features[rows, idx]], dim=-1), grouped


def _attention64(q, k, v, qxyz, kxyz_t, radius, **kw):
    """The plain attention in q's dtype; the radius mask from the fp32
    coordinates, as the fp32 step decides it."""
    return masked_attention_plain(q, k, v, None if qxyz is None else qxyz.float(),
                                  None if kxyz_t is None else kxyz_t.float(), radius, **kw)


@pytest.fixture(scope="module")
def masked_train_f64(masked_train):
    """`masked_train`'s port step in float64: the model in double, FPS and
    the ball query on the same fp32 coordinates (so the same indices), the
    gathers by plain indexing and the attention's plain version in double."""
    v = masked_train["variables"]
    tm = CoDA3DETR(SunrgbdAnonymousConfig(), with_text_head=False, **NO_DROPOUT, **TRAIN_MASKED)
    tm.load_state_dict(to_torch(state_dict_from_flax(v["params"], v["batch_stats"],
                                                     v["constants"])), strict=True)
    tm.double()
    opt, sched = build_optimizer(_args(), tm, 600)
    step = make_train_step(tm, build_criterion(_args(), SunrgbdAnonymousConfig()), opt, sched)
    batch = {k: torch.from_numpy(x.astype(np.float64) if x.dtype == np.float32 else x)
             for k, x in _scenes(2).items()}
    with pytest.MonkeyPatch.context() as mp:
        for module in (pmodel, ppointnet):
            mp.setattr(module, "furthest_point_sample", _fps64)
            mp.setattr(module, "gather_points", _gather64)
        mp.setattr(ppointnet, "query_and_group", _query_and_group64)
        mp.setattr(ptransformer, "masked_attention", _attention64)
        metrics = step(batch, torch.Generator().manual_seed(0))
    grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
    assert {g.dtype for g in grads.values()} == {torch.float64}
    return dict(metrics=metrics, grads=grads, state=tm.state_dict())


def test_masked_train_step_matches_float64(masked_train, masked_train_f64):
    """The port's fp32 step within the vanilla step's tolerances of the same
    step in float64, every gradient and BatchNorm statistic included."""
    got, ref = masked_train["got"], masked_train_f64
    _close(got["metrics"]["loss"], ref["metrics"]["loss"].numpy(), STEP_LOSS_TOL, "loss")
    assert set(got["grads"]) == set(ref["grads"])
    assert sum(k.startswith("encoder.interim_downsampling.") for k in ref["grads"]) == 3 * 3
    norm = np.sqrt(sum(np.sum(g.numpy() ** 2) for g in ref["grads"].values()))
    jax_grads = grads_from_flax(masked_train["want"]["grads"])
    port_err = jax_err = 0.0
    for name, w in ref["grads"].items():
        err = np.abs(_np(got["grads"][name]).astype(np.float64) - w.numpy()).max() / norm
        assert err <= GRAD_TOL, (name, err)
        port_err = max(port_err, err)
        jax_err = max(jax_err, np.abs(np.asarray(jax_grads[name], np.float64)
                                      - w.numpy()).max() / norm)
    names = [k for k in ref["state"] if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * (3 + 3 + 3 + 2 * 5)
    for name in names:
        want = ref["state"][name].numpy()
        _close(got["state"][name], want, BN_TOL * max(1.0, np.abs(want).max()), name)
    print(f"masked training step, max |grad - float64| / |grad|: port {port_err:.3g}, "
          f"JAX {jax_err:.3g}")


def test_interim_sa_train_mode_matches_float64():
    """The interim SA in training mode (batch statistics) on inputs shaped
    like the encoder's (a large mean against the spread): the port's fp32
    output and its gradients within 1e-5 of the same set abstraction
    computed in float64 with the port's indices; the JAX package's fp32 SA,
    on the same flax weights, is printed beside it."""
    from coda_neurips2023_tpu.models import pointnet as jpointnet

    rng = np.random.default_rng(8)
    s, d = MASKED["preenc_npoints"], MASKED["enc_dim"]
    xyz = torch.from_numpy(rng.uniform(-1.5, 1.5, (2, s, 3)).astype(np.float32))
    feats = (rng.standard_normal((2, s, d)) * 2.0 + 3.5).astype(np.float32)
    cot = torch.from_numpy(rng.standard_normal((2, INTERIM, d)))
    jsa = jpointnet.PointnetSAModuleVotes(npoint=INTERIM, radius=0.4, nsample=32,
                                          mlp_dims=(d, 256, 256, d), normalize_xyz=True)
    variables = _perturb(jsa.init(jax.random.PRNGKey(5), jnp.asarray(xyz.numpy()),
                                  jnp.asarray(feats)), 5)
    (_, jout, _), _ = jsa.apply(variables, jnp.asarray(xyz.numpy()), jnp.asarray(feats),
                                train=True, mutable=["batch_stats"])
    p, st = variables["params"]["mlp_module"], variables["batch_stats"]["mlp_module"]
    sd = {}
    for i in range(3):
        pre = f"mlp_module.layer{i}"
        sd[f"{pre}.conv.weight"] = np.asarray(p[f"conv{i}"]["kernel"]).T[..., None, None]
        sd.update({f"{pre}.bn.bn.weight": p[f"bn{i}"]["scale"],
                   f"{pre}.bn.bn.bias": p[f"bn{i}"]["bias"],
                   f"{pre}.bn.bn.running_mean": st[f"bn{i}"]["mean"],
                   f"{pre}.bn.bn.running_var": st[f"bn{i}"]["var"],
                   f"{pre}.bn.bn.num_batches_tracked": np.asarray(0, np.int64)})
    sa = CoDA3DETR(SunrgbdAnonymousConfig(), **MASKED).encoder.interim_downsampling
    sa.load_state_dict(to_torch(sd), strict=True)
    ft = torch.from_numpy(feats).requires_grad_(True)
    new_xyz, out, _ = sa.train()(xyz, ft)
    (out.double() * cot).sum().backward()
    # the same function in float64, at the port's indices
    idx = ball_query(sa.radius, sa.nsample, xyz, new_xyz).long()
    f64 = torch.from_numpy(feats).double().requires_grad_(True)
    rows = torch.arange(2)[:, None, None]
    h = torch.cat([(xyz.double()[rows, idx] - new_xyz.double()[:, :, None]) / sa.radius,
                   f64[rows, idx]], dim=-1)
    weights = []
    for layer in sa.mlp_module.children():
        w = layer.conv.weight.detach().double()[..., 0, 0].clone().requires_grad_(True)
        weights.append(w)
        h = h @ w.t()
        mean = h.mean((0, 1, 2))
        var = torch.clamp((h * h).mean((0, 1, 2)) - mean * mean, min=0.0)
        bn = layer.bn.bn
        h = torch.relu((h - mean) * torch.rsqrt(var + 1e-5) * bn.weight.detach().double()
                       + bn.bias.detach().double())
    want = h.amax(2)
    (want * cot).sum().backward()
    scale = want.abs().max().item()
    assert (out.double() - want).abs().max().item() <= 1e-5 * scale
    assert (ft.grad.double() - f64.grad).abs().max().item() <= 1e-5 * f64.grad.abs().max().item()
    for layer, w in zip(sa.mlp_module.children(), weights):
        g = layer.conv.weight.grad.double()[..., 0, 0]
        assert (g - w.grad).abs().max().item() <= 1e-5 * w.grad.abs().max().item()
    print(f"interim SA in training mode, max |x - float64| / max |x|: port "
          f"{(out.double() - want).abs().max().item() / scale:.3g}, JAX "
          f"{np.abs(np.asarray(jout, np.float64) - want.detach().numpy()).max() / scale:.3g}")


def _remat_step(enc_type, remat, batch):
    """One training step of a tiny detector at the shipped dropout (0.1 in
    the encoder and decoder, 0.3 in the heads) from seeded weights."""
    cfg = dict(MASKED, enc_type=enc_type, enc_nlayers=2)
    model = CoDA3DETR(SunrgbdAnonymousConfig(), with_text_head=False, remat=remat, **cfg)
    with torch.no_grad():
        reset_parameters(model, torch.Generator().manual_seed(5))
    opt, sched = build_optimizer(_args(), model, 600)
    step = make_train_step(model, build_criterion(_args(), SunrgbdAnonymousConfig()), opt, sched)
    gen = torch.Generator().manual_seed(7)
    metrics = step({k: torch.from_numpy(x) for k, x in batch.items()}, gen)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return metrics, grads, model.state_dict(), gen.get_state()


@pytest.mark.parametrize("enc_type", ["vanilla", "masked"])
def test_remat_step_is_bit_equal_to_the_step_without(enc_type):
    batch = _scenes(2)
    plain = _remat_step(enc_type, False, batch)
    remat = _remat_step(enc_type, True, batch)
    assert set(plain[0]) == set(remat[0])
    for key in plain[0]:
        assert torch.equal(plain[0][key], remat[0][key]), key
    for what, a, b in (("grad", plain[1], remat[1]), ("state", plain[2], remat[2])):
        assert set(a) == set(b)
        for name in a:
            assert torch.equal(a[name], b[name]), (what, name)
    assert torch.equal(plain[3], remat[3])  # the generator ends where it did
    assert float(plain[0]["loss"]) > 0


def test_remat_recompute_replays_the_dropout_masks(monkeypatch):
    """Under --remat each checkpointed layer runs twice (the forward, then
    the recompute in the backward), and each of its dropouts draws from the
    generator in the same state both times."""
    from coda_neurips2023_tpu_torch.models import transformer

    states = []
    real = transformer.dropout

    def recording(x, rate, training, generator=None):
        if training and rate > 0:
            states.append(bytes(generator.get_state().numpy()))
        return real(x, rate, training, generator)

    monkeypatch.setattr(transformer, "dropout", recording)
    _remat_step("masked", True, _scenes(2))
    # three masked encoder layers of 3 dropouts and two decoder layers of 4, twice
    n = 3 * 3 + 2 * 4
    assert len(states) == 2 * n
    forward, recompute = states[:n], states[n:]
    assert len(set(forward)) == n  # every draw moved the generator
    assert sorted(recompute) == sorted(forward)


def test_main_trains_with_remat(tmp_path):
    """`main` trains the masked detector with --remat (it raised before);
    the weights after a run equal those of the same run without it."""
    flags = ["--dataset_name", "synthetic", "--synthetic_num_scenes", "8", "--num_points", "512",
             "--model_name", "3detr_predictedbox_distillation", "--batchsize_per_gpu", "2",
             "--max_epoch", "1", "--eval_every_epoch", "1000", "--real_eval_every_epoch", "1000",
             "--dataset_num_workers", "0", "--dataset_num_workers_test", "0", "--log_every", "1",
             *[x for k, v in MASKED.items() for x in (f"--{k}", str(v))]]
    models = [tmain.main(flags + extra + ["--checkpoint_dir", str(tmp_path / name)], device="cpu")
              for name, extra in (("plain", []), ("remat", ["--remat"]))]
    a, b = (m.state_dict() for m in models)
    assert any(k.startswith("encoder.interim_downsampling.") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("compute_dtype", ["float32", "bf16"])
def test_main_test_only_runs_the_masked_detector(monkeypatch, tmp_path, compute_dtype):
    """`main --test_only --enc_type masked` evaluates on the CPU, in fp32 and
    with --compute_dtype bf16, where the masked encoder stays fp32 (the JAX
    package gives it no dtype) and the decoder takes bf16."""
    from coda_neurips2023_tpu_torch import models

    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    built = []
    build = models.build_model

    def recording(*a, **kw):
        built.append(build(*a, **kw)[0])
        return built[-1], None

    monkeypatch.setattr(models, "build_model", recording)
    flags = ["--test_only", "--dataset_name", "synthetic", "--synthetic_num_scenes", "8",
             "--num_points", "512", "--batchsize_per_gpu_test", "2", "--compute_dtype",
             compute_dtype, "--log_file", str(tmp_path / "eval.lst"),
             *[x for k, v in MASKED.items() for x in (f"--{k}", str(v))]]
    metrics = tmain.main(flags, device="cpu")
    assert set(metrics) == {0.25, 0.5} and "mAP" in metrics[0.25]
    model = built[0]
    assert type(model.encoder).__name__ == "MaskedTransformerEncoder"
    dtypes = {m.dtype for m in model.encoder.modules() if isinstance(getattr(m, "dtype", None),
                                                                     torch.dtype)}
    assert dtypes == {torch.float32}
    want = torch.bfloat16 if compute_dtype == "bf16" else torch.float32
    assert model.decoder.layers[0].linear1.dtype == want
