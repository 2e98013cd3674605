"""The port's random detector init against the JAX package's on the CPU.

`models.helpers.reset_parameters` draws every parameter of the detector from
the initializer of its flax counterpart.  A flax init of the JAX model and
the port's init, at the tiny widths of tests/test_torch_port_model.py, go
through the weight bridge's names (`utils.weights.state_dict_from_flax`),
and for each state-dict key:

  * zeros where the JAX init is all zeros (biases, norm shifts, running
    means), ones where it is all ones (norm scales, running variances);
  * each matrix within its flax initializer's bound (xavier_uniform's
    sqrt(6 / (fan_in + fan_out)), lecun_normal's 2 sqrt(1/fan_in) / 0.8796),
    with a standard deviation within sampling error of the initializer's and
    of the JAX init's own (5 standard errors, each estimated from the
    sample's fourth moment).

The SUN RGB-D config (12 angle bins), ScanNet's (1 bin) and the radius-masked
encoder's (its interim set abstraction's convs and BatchNorms) are held.
The CLIP tower keeps its own init (OpenAI's real weights replace it).
"""

import math

import numpy as np
import pytest
import torch

import jax

from coda_neurips2023_tpu.datasets.config import ScannetAnonymousConfig as JaxScannetConfig
from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxSunrgbdConfig
from coda_neurips2023_tpu.datasets.synthetic import SyntheticDetectionDataset as JaxScenes
from coda_neurips2023_tpu.models import model_3detr as jmodel

from coda_neurips2023_tpu_torch.datasets.config import (
    ScannetAnonymousConfig,
    SunrgbdAnonymousConfig,
)
from coda_neurips2023_tpu_torch.models import clip as tclip
from coda_neurips2023_tpu_torch.models.helpers import reset_parameters
from coda_neurips2023_tpu_torch.models.model_3detr import CoDA3DETR
from coda_neurips2023_tpu_torch.utils.weights import state_dict_from_flax, to_torch

from test_torch_port_clip import TINY_CLIP
from test_torch_port_model import TINY
from torch_one_thread import one_intra_op_thread  # noqa: F401

CONFIGS = {
    "sunrgbd": (JaxSunrgbdConfig, SunrgbdAnonymousConfig, {}),
    "scannet": (JaxScannetConfig, ScannetAnonymousConfig, {}),
    # the radius-masked encoder: its interim SA's convs and BatchNorms too
    "masked": (JaxSunrgbdConfig, SunrgbdAnonymousConfig, {"enc_type": "masked"}),
}
XAVIER = ("out_proj.weight", "linear1.weight", "linear2.weight")
SIGMAS = 5.0


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def inits(request):
    """(config name, JAX state dict, port state dict, a function that builds the port model)."""
    jcfg, tcfg, extra = CONFIGS[request.param]
    ds = JaxScenes(JaxSunrgbdConfig(), num_scenes=2, num_points=512)
    samples = [ds[i] for i in range(2)]
    keys = ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")
    batch = {k: np.stack([s[k] for s in samples]) for k in keys}
    jm = jmodel.CoDA3DETR(dataset_config=jcfg(), **TINY, **extra)
    variables = jax.jit(lambda r, b: jm.init(r, b, train=False))(jax.random.PRNGKey(3), batch)
    variables = jax.tree.map(np.asarray, variables)
    want = state_dict_from_flax(variables["params"], variables["batch_stats"],
                                variables["constants"])
    model = CoDA3DETR(tcfg(), **TINY, **extra)
    reset_parameters(model, torch.Generator().manual_seed(3))
    got = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return request.param, want, got, lambda: CoDA3DETR(tcfg(), **TINY, **extra)


def _initializer(key, shape):
    """(kind, bound, std) of the flax initializer behind a state-dict key."""
    if key.endswith("gauss_B"):
        return "normal", math.inf, 1.0
    if key.endswith("in_proj_weight"):  # flax MHA q/k/v kernels (C_in, H * D)
        fan_in, fan_out = shape[1], shape[0] // 3
    elif key.endswith(XAVIER):
        fan_in, fan_out = int(np.prod(shape[1:])), shape[0]
    else:
        std = math.sqrt(1.0 / int(np.prod(shape[1:])))
        return "lecun_normal", 2.0 * std / 0.87962566103423978, std
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return "xavier_uniform", bound, bound / math.sqrt(3.0)


def _std_and_error(x):
    """The sample's standard deviation about 0 and its standard error."""
    x = np.asarray(x, np.float64).ravel()
    var = np.mean(x ** 2)
    var_err = math.sqrt(max(np.mean(x ** 4) - var ** 2, 0.0) / x.size)
    return math.sqrt(var), var_err / (2.0 * math.sqrt(var))


def test_port_init_has_the_jax_keys_and_shapes(inits):
    name, want, got, build = inits
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == np.shape(want[k]), k
    if name == "scannet":  # the angle heads are 1 wide and the bridge carries them
        assert got["mlp_heads.angle_cls_head.layers.8.weight"].shape[0] == 1
        assert got["mlp_heads.angle_residual_head.layers.8.weight"].shape[0] == 1
    if name == "masked":
        assert sum(k.startswith("encoder.interim_downsampling.") for k in want) == 3 * 6
    result = build().load_state_dict(to_torch(want), strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_port_init_is_zero_and_one_where_the_jax_init_is(inits):
    _, want, got, _ = inits
    constant = 0
    for k, w in want.items():
        w = np.asarray(w)
        for value in (0.0, 1.0):
            if w.size and np.all(w == value):
                np.testing.assert_array_equal(got[k], np.full(w.shape, value), err_msg=k)
                constant += 1
    # every bias, norm shift and scale and BN statistic of the detector
    assert constant == sum(1 for k in want if np.asarray(want[k]).ndim <= 1 and
                           not k.endswith("gauss_B"))


def test_port_init_draws_each_matrix_from_the_jax_initializer(inits):
    _, want, got, _ = inits
    kinds = set()
    for k, w in want.items():
        w = np.asarray(w)
        if w.ndim < 2:
            continue
        kind, bound, std = _initializer(k, w.shape)
        kinds.add(kind)
        g_std, g_err = _std_and_error(got[k])
        w_std, w_err = _std_and_error(w)
        for what, x, s, e in (("port", got[k], g_std, g_err), ("jax", w, w_std, w_err)):
            assert np.abs(x).max() <= bound * (1 + 1e-6), (what, k, kind, np.abs(x).max(), bound)
            assert abs(s - std) <= SIGMAS * e, (what, k, kind, s, std, e)
        assert abs(g_std - w_std) <= SIGMAS * math.hypot(g_err, w_err), (k, g_std, w_std)
        if kind == "xavier_uniform":  # a uniform reaches near its bound
            assert np.abs(got[k]).max() > 0.9 * bound, k
    assert kinds == {"xavier_uniform", "lecun_normal", "normal"}


def test_clip_keeps_its_own_init():
    """The CLIP tower's random init is not the detector's: matrices
    N(0, 1/fan), biases N(0, 0.02^2), LayerNorm scales 1."""
    model = tclip.CLIP(**TINY_CLIP)
    tclip.init_clip_parameters(model, torch.Generator().manual_seed(0))
    want = torch.Generator().manual_seed(0)
    for name, p in model.named_parameters():
        if name == "logit_scale":
            assert float(p) == pytest.approx(math.log(1 / 0.07))
            torch.empty(()).normal_(0.0, 0.02, generator=want)
            continue
        ref = torch.empty_like(p)
        if p.dim() >= 2:
            ref.normal_(0.0, p[0].numel() ** -0.5, generator=want)
        elif name.endswith("weight"):
            ref.fill_(1.0)
        else:
            ref.normal_(0.0, 0.02, generator=want)
        torch.testing.assert_close(p.detach(), ref, rtol=0, atol=0, msg=name)
