"""The rest of the port's pointnet2 and model surface against the JAX package on the CPU.

Each piece on the same seeded numpy inputs and, where it has weights, the
same flax weights through the bridge (`utils.weights`):

  * `PointnetSAModuleVotes` with point features (C = 5): new_xyz and inds
    exactly, features within 1e-4, with the port's ball query routed as on
    the card by default (B), CODA_BQ_FUSED_GATHER=1 (F, N >= 4096) and
    CODA_BQ_ALGO=adaptive (G), each taking its plain version here; the
    points lie on a 1/64 grid, where both packages' distance forms are
    exact, so no hit lies on the radius by rounding;
  * --use_color: the detector on 6-channel clouds (xyz and RGB), the colours
    as the pre-encoder's point features: integers exactly, floats 1e-4; the
    synthetic dataset's colours under --use_color (every other field and
    xyz bit-equal to the JAX generator's scene);
  * `main` with --use_color and with --pos_embed sine, in eval and through
    one training epoch on the synthetic data;
  * --pos_embed sine: the embedding at d_pos 64 and 100 (which leaves a
    remainder for the first axes) within 1e-5, a sine model with no
    `gauss_B` in its state dict, and its forward within 1e-4;
  * `three_nn` (indices exactly, distances 1e-5, duplicated known points so
    that ties are decided) and `three_interpolate` (1e-5);
  * `crop_square_resize_white_bilinear` within 1e-4 (values in [0, 255]);
  * `vis_color_pc`: the same `.ply` and `_boxes.obj` files as the JAX tool
    (the PLY's text equal, the OBJ's numbers within 1e-6, its 6-decimal
    print of float32 corners), and the t-SNE branch's file.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from coda_neurips2023_tpu import vis_color_pc as jvis
from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig
from coda_neurips2023_tpu.datasets.synthetic import SyntheticDetectionDataset as JaxScenes
from coda_neurips2023_tpu.models import distillation as jdist
from coda_neurips2023_tpu.models import pointnet as jpointnet
from coda_neurips2023_tpu.models import position_embedding as jpos
from coda_neurips2023_tpu.ops import interpolate as jinterp

from coda_neurips2023_tpu_torch import main as tmain
from coda_neurips2023_tpu_torch import vis_color_pc as tvis
from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset
from coda_neurips2023_tpu_torch.models.distillation import crop_square_resize_white_bilinear
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
from coda_neurips2023_tpu_torch.models.pointnet import PointnetSAModuleVotes
from coda_neurips2023_tpu_torch.models.position_embedding import PositionEmbeddingCoordsSine
from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
from coda_neurips2023_tpu_torch.ops import interpolation_weights, three_interpolate, three_nn
from coda_neurips2023_tpu_torch.ops import grouping

from coda_neurips2023_tpu_torch.utils.weights import to_torch

from test_torch_port_model import (
    TINY,
    _assert_outputs_match,
    _batch,
    _build,
    _close,
    _perturb,
    _t,
)
from torch_one_thread import one_intra_op_thread  # noqa: F401

FLOAT_TOL = 1e-4
EMBED_TOL = 1e-5
C_FEAT = 5
ROUTES = {
    "B": {},
    "F": {"CODA_BQ_FUSED_GATHER": "1"},
    "G": {"CODA_BQ_ALGO": "adaptive"},
}


def _grid_cloud(rng, b, n, extent=1.0):
    """Points on a 1/64 grid: every square and product of coordinates is
    exact in f32, so |a|^2 + |b|^2 - 2ab and the direct differences agree."""
    return (np.round(rng.uniform(-extent, extent, (b, n, 3)) * 64) / 64).astype(np.float32)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_sa_module_with_features_matches_jax(monkeypatch, route):
    for var in ("CODA_BQ_ALGO", "CODA_BQ_MXU", "CODA_BQ_FUSED_GATHER"):
        monkeypatch.delenv(var, raising=False)
    rng = np.random.default_rng(11)
    n = 4096 if route == "F" else 1000
    xyz = _grid_cloud(rng, 2, n)
    feats = rng.standard_normal((2, n, C_FEAT)).astype(np.float32)
    dims = (C_FEAT, 16, 32)
    jsa = jpointnet.PointnetSAModuleVotes(npoint=48, radius=0.3, nsample=16, mlp_dims=dims,
                                          normalize_xyz=True)
    variables = _perturb(jsa.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(feats)), 0)
    # the JAX side on its CPU path, before the environment routes the port
    want = jsa.apply(variables, jnp.asarray(xyz), jnp.asarray(feats), train=False)
    for var, value in ROUTES[route].items():
        monkeypatch.setenv(var, value)
    assert grouping.fused_gather(16, n) == (route == "F")
    assert grouping.ball_query_kernel(16) == ("coda_ball_query_tile" if route == "G"
                                              else "coda_ball_query")
    p, s = variables["params"]["mlp_module"], variables["batch_stats"]["mlp_module"]
    sd = {}
    for i in range(len(dims) - 1):
        pre = f"mlp_module.layer{i}"
        sd[f"{pre}.conv.weight"] = np.asarray(p[f"conv{i}"]["kernel"]).T[..., None, None]
        sd[f"{pre}.bn.bn.weight"] = p[f"bn{i}"]["scale"]
        sd[f"{pre}.bn.bn.bias"] = p[f"bn{i}"]["bias"]
        sd[f"{pre}.bn.bn.running_mean"] = s[f"bn{i}"]["mean"]
        sd[f"{pre}.bn.bn.running_var"] = s[f"bn{i}"]["var"]
        sd[f"{pre}.bn.bn.num_batches_tracked"] = np.asarray(0, np.int64)
    sa = PointnetSAModuleVotes(48, 0.3, 16, dims, normalize_xyz=True)
    sa.load_state_dict(to_torch(sd), strict=True)
    with torch.inference_mode():
        got = sa.eval()(torch.from_numpy(xyz), torch.from_numpy(feats))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1], what="features")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    with pytest.raises(ValueError, match="point features"):
        sa(torch.from_numpy(xyz))


def test_query_and_group_with_features_uses_the_ball_query_indices(monkeypatch):
    monkeypatch.setenv("CODA_BQ_FUSED_GATHER", "1")
    rng = np.random.default_rng(12)
    xyz = torch.from_numpy(_grid_cloud(rng, 2, 4096))
    centres = xyz[:, :40].contiguous()
    feats = torch.from_numpy(rng.standard_normal((2, 4096, 7)).astype(np.float32))
    new_features, grouped_xyz = grouping.query_and_group(0.25, 24, xyz, centres, feats,
                                                         normalize_xyz=True)
    idx = grouping.ball_query_plain(0.25, 24, xyz, centres)
    assert tuple(new_features.shape) == (2, 40, 24, 3 + 7)
    torch.testing.assert_close(new_features[..., :3], grouped_xyz, rtol=0, atol=0)
    torch.testing.assert_close(new_features[..., 3:], grouping.group_points_plain(feats, idx),
                               rtol=0, atol=0)


def test_use_color_forward_matches_jax():
    batch = _batch(2, 1024)
    rgb = np.random.default_rng(13).uniform(0, 1, batch["point_clouds"].shape).astype(np.float32)
    pc = np.concatenate([batch["point_clouds"], rgb], axis=-1)
    batch = dict(batch, point_clouds=pc)
    cfg = dict(TINY, use_color=True)
    jm, variables, sd, tm = _build(cfg, batch, seed=3)
    assert sd["pre_encoder.mlp_module.layer0.conv.weight"].shape[1] == 6  # 3 xyz + 3 colour
    want = jax.tree.map(np.asarray, jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        variables, batch))
    with torch.inference_mode():
        got = tm(_t(batch))
    _assert_outputs_match(got, want)
    with pytest.raises(ValueError, match="point features"):
        CoDA3DETR(SunrgbdAnonymousConfig(), **TINY).eval()(_t(batch))


def test_synthetic_colour_keeps_the_jax_scene():
    """Under --use_color a synthetic scene gains seeded colours after its
    xyz, centred as the SUN RGB-D dataset centres them; xyz and every other
    field stay the JAX generator's, bit for bit."""
    kw = dict(num_scenes=3, num_points=700, seed=9)
    want = JaxScenes(JaxConfig(), **kw)
    got = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), use_color=True, **kw)
    again = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), use_color=True, **kw)
    for i in range(3):
        w, g = want[i], got[i]
        assert set(g) == set(w)
        assert g["point_clouds"].shape == (700, 6) and g["point_clouds"].dtype == np.float32
        np.testing.assert_array_equal(g["point_clouds"][:, :3], w["point_clouds"])
        for k in w:
            if k != "point_clouds":
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        rgb = g["point_clouds"][:, 3:]
        assert rgb.min() >= -0.5 and rgb.max() < 0.5 and rgb.std() > 0.2
        np.testing.assert_array_equal(again[i]["point_clouds"], g["point_clouds"])
    assert not np.array_equal(got[0]["point_clouds"][:, 3:], got[1]["point_clouds"][:, 3:])


MAIN_FLAGS = ["--dataset_name", "synthetic", "--num_points", "512", "--dataset_num_workers", "0",
              "--dataset_num_workers_test", "0",
              *[x for k, v in dict(TINY, preenc_npoints=64).items() for x in (f"--{k}", str(v))]]


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("option", [["--use_color"], ["--pos_embed", "sine"]],
                         ids=["use_color", "sine"])
def test_main_runs_the_option(monkeypatch, tmp_path, option, mode):
    """`main` with --use_color (6-channel clouds, the pre-encoder's MLP
    taking 3 + 3 inputs) or --pos_embed sine (no `gauss_B`): evaluates with
    finite metrics of the JAX package's key set, and trains one epoch to
    finite weights."""
    from coda_neurips2023_tpu_torch import models

    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    built = []
    build = models.build_model

    def recording(*a, **kw):
        built.append(build(*a, **kw)[0])
        return built[-1], None

    monkeypatch.setattr(models, "build_model", recording)
    if mode == "eval":
        out = tmain.main(MAIN_FLAGS + option + [
            "--test_only", "--synthetic_num_scenes", "8", "--batchsize_per_gpu_test", "2",
            "--log_file", str(tmp_path / "eval.lst")], device="cpu")
        assert set(out) == {0.25, 0.5} and "mAP" in out[0.25]
        assert all(np.isfinite(v) for m in out.values() for v in m.values()
                   if isinstance(v, float))
    else:
        out = tmain.main(MAIN_FLAGS + option + [
            "--synthetic_num_scenes", "4", "--model_name", "3detr_predictedbox_distillation",
            "--batchsize_per_gpu", "2", "--max_epoch", "1", "--eval_every_epoch", "1000",
            "--real_eval_every_epoch", "1000", "--log_every", "1",
            "--checkpoint_dir", str(tmp_path / "ckpt")], device="cpu")
        assert out is built[0]
        assert all(torch.isfinite(v).all() for v in out.state_dict().values()
                   if v.is_floating_point())
    model = built[0]
    width = model.pre_encoder.mlp_module.layer0.conv.weight.shape[1]
    assert width == (6 if option == ["--use_color"] else 3)
    assert ("pos_embedding.gauss_B" in model.state_dict()) == (option == ["--use_color"])


@pytest.mark.parametrize("d_pos", [64, 100])
def test_sine_embedding_matches_jax(d_pos):
    rng = np.random.default_rng(14)
    xyz = rng.uniform(-3, 3, (2, 40, 3)).astype(np.float32)
    lo, hi = xyz.min(1), xyz.max(1)
    want = jpos.PositionEmbeddingCoordsSine(d_pos=d_pos, pos_type="sine", normalize=True).apply(
        {}, jnp.asarray(xyz), input_range=(jnp.asarray(lo), jnp.asarray(hi)))
    pe = PositionEmbeddingCoordsSine(d_pos, pos_type="sine")
    got = pe(torch.from_numpy(xyz), input_range=(torch.from_numpy(lo), torch.from_numpy(hi)))
    assert tuple(got.shape) == (2, 40, d_pos)
    _close(got, want, tol=EMBED_TOL, what=f"sine {d_pos}")
    assert not list(pe.state_dict())


def test_sine_model_matches_jax_and_has_no_gauss_b():
    batch = _batch(2, 1024)
    cfg = dict(TINY, position_embedding="sine")
    jm, variables, sd, tm = _build(cfg, batch, seed=4)
    assert not any("gauss_B" in k for k in sd) and "pos_embedding.gauss_B" not in tm.state_dict()
    want = jax.tree.map(np.asarray, jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        variables, batch))
    with torch.inference_mode():
        got = tm(_t(batch))
    _assert_outputs_match(got, want)
    with pytest.raises(ValueError, match="pos_type"):
        PositionEmbeddingCoordsSine(64, pos_type="learned")


@pytest.mark.parametrize("case", ["random", "duplicates"])
def test_three_nn_and_interpolate_match_jax(case):
    rng = np.random.default_rng(15)
    known = rng.uniform(-1, 1, (2, 24, 3)).astype(np.float32)
    unknown = rng.uniform(-1, 1, (2, 50, 3)).astype(np.float32)
    if case == "duplicates":  # exact ties: the earlier index goes first
        known[:, 10] = known[:, 3]
        known[:, 17] = known[:, 3]
        known[:, 20] = known[:, 5]
        unknown[:, :8] = known[:, [3, 5, 3, 5, 3, 5, 3, 5]]
    jd, ji = jinterp.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    d, i = three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(d, jd, tol=EMBED_TOL, what="dist2")
    if case == "duplicates":
        assert (i[:, 0:8:2, :3].numpy() == np.array([3, 10, 17])).all()
    weight = interpolation_weights(d)
    _close(weight, jinterp.interpolation_weights(jd), tol=EMBED_TOL, what="weights")
    points = rng.standard_normal((2, 24, 6)).astype(np.float32)
    want = jinterp.three_interpolate(jnp.asarray(points), ji, jnp.asarray(weight.numpy()))
    got = three_interpolate(torch.from_numpy(points), i, weight)
    _close(got, want, tol=EMBED_TOL, what="interpolate")


def test_crop_square_resize_white_bilinear_matches_jax():
    rng = np.random.default_rng(16)
    image = rng.uniform(0, 255, (53, 71, 3)).astype(np.float32)
    rects = np.array([[3, 4, 40, 20], [0, 0, 71, 53], [10, 30, 12, 50], [5, 5, 6, 6],
                      [60, 2, 71, 45]], dtype=np.int32)
    got = crop_square_resize_white_bilinear(torch.from_numpy(image), torch.from_numpy(rects),
                                            out_size=32)
    assert tuple(got.shape) == (5, 32, 32, 3)
    for k, rect in enumerate(rects):
        want = jdist.crop_square_resize_white_bilinear(jnp.asarray(image), jnp.asarray(rect),
                                                       out_size=32)
        _close(got[k], want, tol=FLOAT_TOL, what=f"rect {rect}")
        single = crop_square_resize_white_bilinear(torch.from_numpy(image),
                                                   torch.from_numpy(rect), out_size=32)
        torch.testing.assert_close(single, got[k], rtol=0, atol=0)


def _numbers(path):
    with open(path) as f:
        return [float(x) for line in f if line[0] in "vl" for x in line.split()[1:]]


def test_vis_color_pc_writes_the_jax_tools_files(tmp_path):
    rng = np.random.default_rng(17)
    pc = np.concatenate([rng.uniform(-3, 3, (200, 3)), rng.uniform(0, 1, (200, 3))],
                        axis=1).astype(np.float32)
    np.savez(tmp_path / "scene_pc.npz", pc=pc)
    boxes = np.concatenate([rng.uniform(-2, 2, (4, 3)), rng.uniform(0.1, 1, (4, 3)),
                            rng.uniform(-np.pi, np.pi, (4, 1)), np.ones((4, 1))],
                           axis=1).astype(np.float32)
    np.save(tmp_path / "scene_bbox.npy", boxes)
    args = [str(tmp_path / "scene_pc.npz"), None, str(tmp_path / "scene_bbox.npy")]
    jvis.vis_pointcloud(args[0], str(tmp_path / "jax"), args[2])
    tvis.main(["--pc", args[0], "--bbox", args[2], "--out", str(tmp_path / "port")])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "scene_pc.ply", "scene_pc_boxes.obj"]
    ply = [(tmp_path / d / "scene_pc.ply").read_text() for d in ("port", "jax")]
    assert ply[0] == ply[1]
    got, want = (_numbers(tmp_path / d / "scene_pc_boxes.obj") for d in ("port", "jax"))
    assert len(got) == len(want) == 4 * (8 * 3 + 12 * 2)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0, atol=1.01e-6)


def test_vis_color_pc_tsne_writes_its_file(tmp_path):
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(18)
    np.save(tmp_path / "feats.npy", rng.standard_normal((40, 16)).astype(np.float32))
    np.save(tmp_path / "labels.npy", rng.integers(0, 4, 40))
    tvis.main(["--embeddings", str(tmp_path / "feats.npy"), "--labels",
               str(tmp_path / "labels.npy"), "--out", str(tmp_path / "out")])
    written = os.listdir(tmp_path / "out")
    assert written in (["feats_tsne.png"], ["tsne_proj.npy"])
