"""The port's eval entry point over 2 ranks, on the CPU.

`main --test_only --test_ckpt x.pth --ngpus 2` at the tiny widths of
tests/test_torch_port_model.py on 9 synthetic scenes of the real_test split
at --batchsize_per_gpu_test 2 (global batches of 4: two full ones and a tail
of one scene, padded, whose second rank holds padding only), the text bank
from the tiny CLIP, one `.pth` exported from a flax model:

  * the JAX package on a mesh of 2 of conftest's 8 virtual CPU devices;
  * the port in 2 gloo processes (tests/torch_ddp_ranks.py :: run_main);
  * the port in one process at the same global batch.

Held: each batch's outputs of rank 0 then rank 1 are the JAX package's
global batch's within OUTPUT_TOL; rank 0 meters the 9 real scans once; the
metrics equal the JAX package's and the port's one-process metrics within
METRIC_TOL; the log file holds one table, rank 0's.

And `main` itself at --ngpus 2 with cpu_devices=2 starts its two ranks
(its own launcher: the world-size rule, the build in the parent, rank 0's
result returned) and without cpu_devices runs one process, and says so:
--cal_class_only (run_mode, each rank its rows) gives the same confusion
matrix, summed over the ranks (the default model with its random CLIP, from
--seed).
"""

import numpy as np
import pytest
import torch

import jax

from coda_neurips2023_tpu import engine as jengine
from coda_neurips2023_tpu import main as jmain
from coda_neurips2023_tpu import stages as jstages
from coda_neurips2023_tpu.datasets import loader as jloader
from coda_neurips2023_tpu.datasets.config import SunrgbdAnonymousConfig as JaxConfig
from coda_neurips2023_tpu.datasets.synthetic import SyntheticDetectionDataset as JaxScenes
from coda_neurips2023_tpu.models import clip as jclip
from coda_neurips2023_tpu.utils.torch_convert import export_reference_state_dict

from coda_neurips2023_tpu_torch import stages
from coda_neurips2023_tpu_torch import main as tmain
from coda_neurips2023_tpu_torch.parallel import ddp

import torch_ddp_ranks
from test_torch_port_clip import TINY_CLIP
from test_torch_port_eval import METRIC_TOL, OUTPUT_TOL, _assert_metrics_close
from test_torch_port_model import TINY, _assert_no_boundary_flip, _build
from torch_one_thread import one_intra_op_thread  # noqa: F401

WORLD = 2
PER_RANK = 2
SCENES = 9  # the real_test split: a quarter of --synthetic_num_scenes
NUM_POINTS = 1024


def _argv(tmp_path, ckpt, log_name, ngpus, per_rank):
    return [
        "--test_only", "--dataset_name", "synthetic", "--synthetic_num_scenes", str(4 * SCENES),
        "--num_points", str(NUM_POINTS), "--batchsize_per_gpu_test", str(per_rank),
        "--test_ckpt", str(ckpt), "--log_file", str(tmp_path / log_name), "--if_use_v1",
        "--ngpus", str(ngpus), *[x for k, v in TINY.items() for x in (f"--{k}", str(v))],
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_eval")
    ds = JaxScenes(JaxConfig(), num_scenes=SCENES, num_points=NUM_POINTS, seed=2)
    batch = jloader.collate([ds[i] for i in range(SCENES)])
    _assert_no_boundary_flip(batch, TINY["preenc_npoints"])
    pts = {k: batch[k][:2] for k in ("point_clouds", "point_cloud_dims_min", "point_cloud_dims_max")}
    _, variables, _, _ = _build(TINY, pts)
    sd = export_reference_state_dict(variables["params"], variables["batch_stats"],
                                     variables["constants"])
    ckpt = tmp / "tiny.pth"
    torch.save({"model": {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()},
                "epoch": 0}, ckpt)
    contexts, jax_outs = {}, []
    mp = pytest.MonkeyPatch()
    mp.setenv("CODA_AP_WORKERS", "0")
    jstages_cls, jmake = jstages.StageContext, jengine.make_eval_step

    def jax_ctx(args, cfg):
        contexts["jax"] = jstages_cls(args, cfg, clip_model=jclip.CLIP(**TINY_CLIP), crop_size=16)
        return contexts["jax"]

    def jax_make(*a, **kw):
        step = jmake(*a, **kw)

        def recorded(state, b):
            out = step(state, b)
            jax_outs.append(jax.tree.map(np.asarray, out))
            return out

        return recorded

    mp.setattr(jstages, "StageContext", jax_ctx)
    mp.setattr(jengine, "make_eval_step", jax_make)
    out = tmp / "ranks"
    out.mkdir()
    try:
        want = jmain.main(_argv(tmp, ckpt, "jax.lst", WORLD, PER_RANK))
        params = jax.tree.map(np.asarray, contexts["jax"].clip_variables["params"])
        url = ddp.free_url()
        ddp.launch(torch_ddp_ranks.run_main, WORLD, str(out),
                   _argv(tmp, ckpt, "port2.lst", WORLD, PER_RANK) + ["--dist_url", url],
                   TINY_CLIP, params, devices=["cpu"] * WORLD, backend="gloo", dist_url=url)
        mp.setattr(stages, "StageContext",
                   torch_ddp_ranks.tiny_clip_context(stages.StageContext, TINY_CLIP, params))
        one = tmain.main(_argv(tmp, ckpt, "port1.lst", 1, PER_RANK * WORLD), device="cpu")
    finally:
        mp.undo()
    return dict(want=want, jax_outs=jax_outs, one=one, tmp=tmp,
                ranks=torch_ddp_ranks.load_ranks(str(out), WORLD))


def test_each_batch_is_the_jax_global_batch(runs):
    ranks = runs["ranks"]
    assert len(runs["jax_outs"]) == len(ranks[0]["evals"]) == len(ranks[1]["evals"]) == 3
    for b, want in enumerate(runs["jax_outs"]):
        for k, w in want.items():
            got = np.concatenate([r["evals"][b][k] for r in ranks])
            np.testing.assert_allclose(got, w, rtol=0, atol=OUTPUT_TOL, err_msg=f"batch {b} {k}")


def test_rank_zero_meters_every_scan_once(runs):
    assert runs["ranks"][0]["scans"] == SCENES
    assert runs["ranks"][1]["result"] is None  # rank 1 steps its rows and meters nothing
    text = (runs["tmp"] / "port2.lst").read_text()
    assert text.startswith("mAP0.25") and text.count("mAP0.25") == 1


@pytest.mark.parametrize("other", ["jax_mesh2", "port_one_process"])
def test_metrics_match(runs, other):
    want = runs["want"] if other == "jax_mesh2" else runs["one"]
    _assert_metrics_close(runs["ranks"][0]["result"], want, METRIC_TOL)


def test_main_starts_its_ranks_on_cpu_devices(tmp_path, monkeypatch, capsys):
    """main's own launcher through run_mode: --cal_class_only's confusion
    matrix summed over 2 ranks equals one process's."""
    monkeypatch.setenv("CODA_AP_WORKERS", "0")
    argv = ["--cal_class_only", "--dataset_name", "synthetic", "--synthetic_num_scenes", "20",
            "--num_points", str(NUM_POINTS), "--batchsize_per_gpu_test", "2", "--ngpus", "2",
            "--checkpoint_dir", str(tmp_path), "--dist_url", ddp.free_url(),
            *[x for k, v in TINY.items() for x in (f"--{k}", str(v))]]
    two = tmain.main(argv, device="cpu", cpu_devices=2)
    assert "data parallel: 2 rank(s) (--ngpus 2, 2 CPU devices)" in capsys.readouterr().out
    one = tmain.main(argv, device="cpu")
    assert "data parallel: 1 rank(s) (--ngpus 2, 1 CPU devices)" in capsys.readouterr().out
    assert one.shape == (46, 46) and one.sum() > 0
    np.testing.assert_array_equal(two, one)
