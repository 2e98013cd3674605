"""The PyTorch port's detector against the JAX package on the CPU.

One tiny CoDA3DETR (the config of tests/test_model.py) is initialised in
flax, its 1-D parameters and BatchNorm statistics are perturbed so that no
norm is an identity, and the variables go through the port's weight bridge
(`coda_neurips2023_tpu_torch.utils.weights`).  Every module of the eval
forward, the whole forward and the eval step are then held against their
flax counterparts on the same weights and the same numpy inputs.

Tolerance: integer outputs (FPS and ball-query indices, `enc_inds`) exactly;
floats within 1e-4 absolute.  Both sides compute in fp32 on the CPU, and
their matmuls sum in different orders (XLA vs PyTorch's BLAS), which moves
the last bits of the O(1)-O(10) activations.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig
from coda_neurips2023_tpu.datasets.synthetic import SyntheticDetectionDataset as JaxScenes
from coda_neurips2023_tpu.engine import TrainState
from coda_neurips2023_tpu.engine import make_eval_step as jax_make_eval_step
from coda_neurips2023_tpu.models import box_processor as jbox
from coda_neurips2023_tpu.models import helpers as jhelpers
from coda_neurips2023_tpu.models import model_3detr as jmodel
from coda_neurips2023_tpu.models import pointnet as jpointnet
from coda_neurips2023_tpu.models import position_embedding as jpos
from coda_neurips2023_tpu.models import transformer as jtransformer
from coda_neurips2023_tpu.ops.grouping import ball_query as jax_ball_query
from coda_neurips2023_tpu.utils.torch_convert import export_reference_state_dict

from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch
from coda_neurips2023_tpu_torch.engine import make_eval_step
from coda_neurips2023_tpu_torch.models.box_processor import BoxProcessor
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
from coda_neurips2023_tpu_torch.ops.grouping import ball_query
from coda_neurips2023_tpu_torch.ops.sampling import furthest_point_sample, gather_points
from coda_neurips2023_tpu_torch.utils.weights import state_dict_from_flax, to_torch

TINY = dict(enc_dim=32, dec_dim=64, enc_nlayers=2, dec_nlayers=3, enc_ffn_dim=32,
            dec_ffn_dim=32, preenc_npoints=64, nqueries=16)
FLOAT_TOL = 1e-4
NUM_POINTS = 1024
NO_LAYER_AXIS = ("query_xyz", "enc_xyz", "enc_inds")


def _perturb(variables, seed):
    """Random 1-D parameters (biases, norm scales) and BN statistics."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path[-1:])
        if "var" in name:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if any(s in name for s in ("bias", "scale", "mean")):
            return (x + rng.normal(0.0, 0.1, x.shape)).astype(np.float32)
        return x

    return {
        col: jax.tree_util.tree_map_with_path(leaf, tree) if col != "constants"
        else jax.tree.map(np.asarray, tree)
        for col, tree in variables.items()
    }


def _build(config_kw, batch, seed=0):
    """flax model + perturbed numpy variables, and the port loaded from them."""
    jm = jmodel.CoDA3DETR(dataset_config=JaxConfig(), **config_kw)
    variables = jax.jit(lambda r, b: jm.init(r, b, train=False))(
        jax.random.PRNGKey(seed), batch
    )
    variables = _perturb(variables, seed)
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"],
                              variables.get("constants", {}))
    tm = CoDA3DETR(SunrgbdAnonymousConfig(), **config_kw)
    result = tm.load_state_dict(to_torch(sd), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return jm, variables, sd, tm.eval()


def _batch(num_scenes, num_points):
    ds = JaxScenes(JaxConfig(), num_scenes=num_scenes, num_points=num_points)
    samples = [ds[i] for i in range(num_scenes)]
    keys = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")
    return {k: np.stack([s[k] for s in samples]) for k in keys}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got, want, tol=FLOAT_TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _assert_no_boundary_flip(batch, npoint):
    """On the SA module's inputs, the JAX CPU ball query (|a|^2+|b|^2-2ab)
    must pick what the port's direct differences pick (the port matches the
    golden model in test_torch_port_ops.py); otherwise a comparison with the
    JAX CPU path would test rounding at the radius, not the port."""
    xyz = torch.from_numpy(np.ascontiguousarray(batch["point_clouds"][..., :3]))
    new_xyz = gather_points(xyz, furthest_point_sample(xyz, npoint))
    want = jax_ball_query(0.2, 64, jnp.asarray(xyz.numpy()), jnp.asarray(new_xyz.numpy()))
    np.testing.assert_array_equal(ball_query(0.2, 64, xyz, new_xyz).numpy(), np.asarray(want))


def _assert_outputs_match(got, want):
    assert set(got) == set(want)
    np.testing.assert_array_equal(
        got["angle_logits"].argmax(-1).numpy(), np.asarray(want["angle_logits"]).argmax(-1),
        err_msg="angle classes differ: angle_continuous would not be comparable",
    )
    for key, w in want.items():
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
        else:
            _close(got[key], w, what=key)


@pytest.fixture(scope="module")
def tiny():
    batch = _batch(2, NUM_POINTS)
    jm, variables, sd, tm = _build(TINY, batch)
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, batch)
    return dict(batch=batch, jm=jm, variables=variables, sd=sd, tm=tm,
                want=jax.tree.map(np.asarray, want))


def test_weight_bridge_matches_export(tiny):
    v = tiny["variables"]
    want = export_reference_state_dict(v["params"], v["batch_stats"], v["constants"])
    got = tiny["sd"]
    assert list(got) == list(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    port_names = set(tiny["tm"].state_dict())
    assert port_names == set(want)


HEADS = ("sem_cls_head", "center_head", "size_head", "angle_cls_head",
         "angle_residual_head", "text_correlation_head")


@pytest.mark.parametrize("name", HEADS + ("encoder_to_decoder_projection", "query_projection"))
def test_generic_mlp(tiny, name):
    dec = TINY["dec_dim"]
    if name == "encoder_to_decoder_projection":
        jmlp = jhelpers.GenericMLP(hidden_dims=(512, 512), output_dim=dec, norm="bn1d",
                                   output_use_activation=True, output_use_norm=True,
                                   output_use_bias=False)
        port, width = tiny["tm"].encoder_to_decoder_projection, TINY["enc_dim"]
    elif name == "query_projection":
        jmlp = jhelpers.GenericMLP(hidden_dims=(dec,), output_dim=dec, hidden_use_bias=True,
                                   output_use_activation=True)
        port, width = tiny["tm"].query_projection, dec
    else:
        out_dim = {"sem_cls_head": 2, "center_head": 3, "size_head": 3, "angle_cls_head": 12,
                   "angle_residual_head": 12, "text_correlation_head": 512}[name]
        jmlp = jhelpers.GenericMLP(hidden_dims=(dec, dec), output_dim=out_dim, norm="bn1d",
                                   dropout=0.3)
        port, width = tiny["tm"].mlp_heads[name], dec
    v = tiny["variables"]
    jvars = {"params": v["params"][name]}
    if name in v["batch_stats"]:
        jvars["batch_stats"] = v["batch_stats"][name]
    x = np.random.default_rng(1).standard_normal((3, 2, 16, width)).astype(np.float32)
    want = jmlp.apply(jvars, jnp.asarray(x), train=False)
    with torch.inference_mode():
        _close(port(torch.from_numpy(x)), want, what=name)


def test_position_embedding(tiny):
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-3, 3, (2, 40, 3)).astype(np.float32)
    lo, hi = xyz.min(1), xyz.max(1)
    jpe = jpos.PositionEmbeddingCoordsSine(d_pos=TINY["dec_dim"], pos_type="fourier", normalize=True)
    want = jpe.apply({"constants": tiny["variables"]["constants"]["pos_embedding"]},
                     jnp.asarray(xyz), input_range=(jnp.asarray(lo), jnp.asarray(hi)))
    got = tiny["tm"].pos_embedding(torch.from_numpy(xyz),
                                   input_range=(torch.from_numpy(lo), torch.from_numpy(hi)))
    _close(got, want, what="fourier")


def test_pointnet_sa(tiny):
    xyz = np.ascontiguousarray(tiny["batch"]["point_clouds"][..., :3])
    _assert_no_boundary_flip(tiny["batch"], TINY["preenc_npoints"])
    jsa = jpointnet.PointnetSAModuleVotes(npoint=TINY["preenc_npoints"], radius=0.2, nsample=64,
                                          mlp_dims=(0, 64, 128, TINY["enc_dim"]),
                                          normalize_xyz=True)
    v = tiny["variables"]
    want = jsa.apply({"params": v["params"]["pre_encoder"],
                      "batch_stats": v["batch_stats"]["pre_encoder"]},
                     jnp.asarray(xyz), None, train=False)
    with torch.inference_mode():
        got = tiny["tm"].pre_encoder(torch.from_numpy(xyz))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1], what="sa features")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_encoder_stack(tiny):
    src = np.random.default_rng(3).standard_normal((2, 64, TINY["enc_dim"])).astype(np.float32)
    jenc = jtransformer.TransformerEncoder(num_layers=TINY["enc_nlayers"], d_model=TINY["enc_dim"],
                                           nhead=4, dim_feedforward=TINY["enc_ffn_dim"])
    _, want, _ = jenc.apply({"params": tiny["variables"]["params"]["encoder"]},
                            jnp.asarray(src), train=False)
    with torch.inference_mode():
        _, got, _ = tiny["tm"].encoder(torch.from_numpy(src))
    _close(got, want, what="encoder")


def test_decoder_stack(tiny):
    rng = np.random.default_rng(4)
    dec = TINY["dec_dim"]
    tgt, qpos = (rng.standard_normal((2, 16, dec)).astype(np.float32) for _ in range(2))
    mem, pos = (rng.standard_normal((2, 64, dec)).astype(np.float32) for _ in range(2))
    jdec = jtransformer.TransformerDecoder(num_layers=TINY["dec_nlayers"], d_model=dec, nhead=4,
                                           dim_feedforward=TINY["dec_ffn_dim"])
    want = jdec.apply({"params": tiny["variables"]["params"]["decoder"]}, jnp.asarray(tgt),
                      jnp.asarray(mem), query_pos=jnp.asarray(qpos), pos=jnp.asarray(pos),
                      train=False)
    with torch.inference_mode():
        got = tiny["tm"].decoder(*map(torch.from_numpy, (tgt, mem)),
                                 query_pos=torch.from_numpy(qpos), pos=torch.from_numpy(pos))
    assert tuple(got.shape) == (TINY["dec_nlayers"], 2, 16, dec)
    _close(got, want, what="decoder")


def test_box_processor():
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    lo = rng.uniform(-4, -2, (2, 3)).astype(np.float32)
    hi = rng.uniform(2, 4, (2, 3)).astype(np.float32)
    offset, qxyz, size = f(3, 2, 16, 3), f(2, 16, 3), rng.uniform(0, 1, (3, 2, 16, 3)).astype(np.float32)
    logits, res, cls_logits = f(3, 2, 16, 12), f(3, 2, 16, 12), f(3, 2, 16, 2)
    jb, tb = jbox.BoxProcessor(JaxConfig()), BoxProcessor(SunrgbdAnonymousConfig())
    j = lambda *a: [jnp.asarray(x) for x in a]
    t = lambda *a: [torch.from_numpy(x) for x in a]
    dims_j, dims_t = tuple(j(lo, hi)), tuple(t(lo, hi))
    for g, w in zip(tb.compute_predicted_center(*t(offset, qxyz), dims_t),
                    jb.compute_predicted_center(*j(offset, qxyz), dims_j)):
        _close(g, w, what="center")
    size_t = tb.compute_predicted_size(torch.from_numpy(size), dims_t)
    _close(size_t, jb.compute_predicted_size(jnp.asarray(size), dims_j), what="size")
    angle_t = tb.compute_predicted_angle(*t(logits, res))
    angle_j = jb.compute_predicted_angle(*j(logits, res))
    _close(angle_t, angle_j, what="angle")
    for g, w in zip(tb.compute_objectness_and_cls_prob(torch.from_numpy(cls_logits)),
                    jb.compute_objectness_and_cls_prob(jnp.asarray(cls_logits))):
        _close(g, w, what="probs")
    center = torch.from_numpy(f(3, 2, 16, 3))
    _close(tb.box_parametrization_to_corners(center, size_t, angle_t),
           jb.box_parametrization_to_corners(jnp.asarray(center.numpy()), jnp.asarray(size_t.numpy()),
                                             jnp.asarray(angle_t.numpy())), what="corners")
    _close(tb.box_parametrization_to_corners_xyz(center, size_t, angle_t),
           jb.box_parametrization_to_corners_xyz(jnp.asarray(center.numpy()),
                                                 jnp.asarray(size_t.numpy()),
                                                 jnp.asarray(angle_t.numpy())), what="corners_xyz")


def test_forward_matches_jax(tiny):
    _assert_no_boundary_flip(tiny["batch"], TINY["preenc_npoints"])
    with torch.inference_mode():
        got = tiny["tm"](_t(tiny["batch"]))
    for key, value in got.items():
        if key not in NO_LAYER_AXIS:
            assert value.shape[0] == TINY["dec_nlayers"], key
    _assert_outputs_match(got, tiny["want"])


def test_eval_step_matches_jax(tiny):
    v = tiny["variables"]
    rng = np.random.default_rng(6)
    bank = rng.standard_normal((46, 512)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"], constants=v["constants"], opt_state=())
    want = jax_make_eval_step(tiny["jm"], eval_text_features=jnp.asarray(bank))(state, tiny["batch"])
    got = make_eval_step(tiny["tm"], eval_text_features=torch.from_numpy(bank))(_t(tiny["batch"]))
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], what=key)


def test_synthetic_scenes_bit_equal():
    for seed, num_points, max_boxes, image_hw in ((0, 1024, 12, None), (3, 2048, 4, None),
                                                  (7, 999, 1, None), (2, 1024, 12, (53, 73))):
        images = dict(with_images=True, image_hw=image_hw) if image_hw else {}
        jds = JaxScenes(JaxConfig(), num_scenes=3, num_points=num_points, seed=seed,
                        max_boxes_per_scene=max_boxes, **images)
        tds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=3,
                                        num_points=num_points, seed=seed,
                                        max_boxes_per_scene=max_boxes, **images)
        got = make_batch(tds, 0, 3)
        if image_hw:
            assert got["input_image"].shape == (3, *image_hw, 3)
        for i in range(3):
            want = jds[i]
            for key, g in got.items():
                assert g[i].dtype == want[key].dtype
                np.testing.assert_array_equal(g[i], want[key], err_msg=f"{key} scene {i}")


@pytest.mark.slow
def test_flagship_forward_matches_jax():
    """The full width of the flagship config on one 20000-point scene.

    At 20000 points some points lie within the rounding of |a|^2+|b|^2-2ab of
    the radius, and the JAX CPU ball query flips them.  On a 1/64 grid every
    square and cross product is exact in f32, so both distance forms agree.
    """
    batch = _batch(1, 20000)
    pc = np.round(batch["point_clouds"] * 64) / 64
    batch = {"point_clouds": pc, "point_cloud_dims_min": pc.min(1),
             "point_cloud_dims_max": pc.max(1)}
    jm, variables, _, tm = _build({}, batch, seed=1)
    want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(variables, batch)
    _assert_no_boundary_flip(batch, 2048)
    with torch.inference_mode():
        got = tm(_t(batch))
    _assert_outputs_match(got, jax.tree.map(np.asarray, want))
