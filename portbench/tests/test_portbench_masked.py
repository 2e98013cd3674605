"""The 3detr-m-sunrgbd configuration and its training cell: their files
against the manifest's rules and the baseline's, the masked detector's
model FLOPs (mfu_masked.train) against a hand count at the published widths
and PyTorch's own counter, the radius-masked attention's bytes floor
(radius_attention_roofline.train), the encoder span readers, and the whole
harness on the CPU at a tiny size."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import run as R
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "3detr-m-sunrgbd.train"
CONFIG = "3detr-m-sunrgbd"
NEW_METRICS = ("masked_encoder_ms.train", "interim_sa_ms.train",
               "radius_attention_roofline.train", "mfu_masked.train")


def _json(*parts):
    return json.loads(ROOT.joinpath("portbench", *parts).read_text())


def _entry(group, name):
    (e,) = [e for e in BENCH[group] if e["name"] == name]
    return e


def test_configuration_is_the_baseline_with_the_masked_encoder():
    base, c = _json("configs", "baseline-sunrgbd.json"), _json("configs", f"{CONFIG}.json")
    assert c["flags"] == base["flags"] + ["--enc_type", "masked"]
    assert c["reduced"] == base["reduced"] == ["ngpus", "clip_model_path"]
    assert {k: v for k, v in c["widths"].items() if k != "masked_encoder"} == base["widths"]
    assert c["widths"]["masked_encoder"] == {
        "layers": 3, "masking_radius_sq": [0.16, 0.64, 1.44], "interim_npoints": 1024,
        "interim_radius": 0.4, "interim_nsample": 32, "interim_mlp": [256, 256, 256, 256]}
    assert any("enc_type masked" in a for a in c["assumed"])
    assert any("--enc_dropout 0.1" in a for a in c["assumed"])
    entry = _entry("configs", CONFIG)
    assert entry["file"] == f"portbench/configs/{CONFIG}.json"
    assert entry["reduced"] == c["reduced"] and entry["source"] == c["source"]
    assert 1 <= len(c["source"]) <= 200


def test_configuration_matches_the_program():
    """The widths the FLOP count reads are the ones main builds."""
    from coda_neurips2023_tpu_torch.main import make_args_parser
    from coda_neurips2023_tpu_torch.models import transformer

    c = _json("configs", f"{CONFIG}.json")
    args = make_args_parser().parse_args(c["flags"])
    w, m = c["widths"]["detector"], c["widths"]["masked_encoder"]
    assert args.enc_type == "masked" and args.enc_dropout == 0.1
    assert (args.enc_dim, args.enc_ffn_dim, args.enc_nhead) == (w["enc_dim"], w["enc_ffn_dim"],
                                                                w["enc_nhead"])
    assert (args.dec_dim, args.dec_nlayers, args.nqueries, args.preenc_npoints) == (
        w["dec_dim"], w["dec_nlayers"], w["nqueries"], w["preenc_npoints"])
    assert m["interim_npoints"] == args.preenc_npoints // 2
    assert m["layers"] == len(transformer.MASKING_RADIUS)
    assert m["masking_radius_sq"] == pytest.approx(transformer.MASKING_RADIUS)
    assert (m["interim_radius"], m["interim_nsample"]) == (transformer.INTERIM_RADIUS,
                                                           transformer.INTERIM_NSAMPLE)


def test_cell_and_its_limits():
    cell = _json("cells", f"{CELL}.json")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "train", 1)
    w = _entry("workloads", CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "train", 1)
    assert CELL in _entry("end_to_end", "train_scenes_per_s")["workloads"]
    assert set(cell["limits"]) == {"loss_gap", "grad_gap", "update_gap"}
    control_over = []
    for name, limit in cell["limits"].items():
        r = cell["limit_readings"][name]
        assert r["lower"] < limit < r["upper"], name
        control_over.append(r["upper_from"].startswith("TF32 control"))
    assert any(control_over)  # the TF32 control fails at least one limit


def test_new_metrics_read_the_new_cell_alone():
    for name in NEW_METRICS:
        m = _entry("per_layer", name)
        assert m["workloads"] == [CELL] and m["moves"] == "train_scenes_per_s"
        assert R.load_reader(name).WORKLOADS == [CELL]


def _published():
    c = _json("configs", f"{CONFIG}.json")
    return dict(c["widths"]["detector"], heads=c["widths"]["heads_out"]), c["widths"]["masked_encoder"]


def test_masked_flops_by_hand():
    """One scene's forward at the published widths, written out."""
    w, m = _published()
    pre = 2 * (2048 * 64) * (3 * 64 + 64 * 128 + 128 * 256)
    enc_layer = lambda s: 2 * s * 4 * 256 * 256 + 2 * s * (256 * 128 + 128 * 256)  # noqa: E731
    encoder = enc_layer(2048) + 2 * enc_layer(1024)
    interim = 2 * (1024 * 32) * (259 * 256 + 256 * 256 + 256 * 256)
    proj = 2 * 1024 * (256 * 512 + 512 * 512 + 512 * 512)
    query = 2 * 128 * (512 * 512 + 512 * 512)
    self_attn = 2 * 128 * 512 * 512 * 4 + 4 * 128 * 128 * 512
    cross = 2 * 128 * 512 * 512 * 2 + 2 * 1024 * 512 * 512 * 2 + 4 * 128 * 1024 * 512
    ffn = 2 * 128 * (512 * 256 + 256 * 512)
    heads = sum(2 * 128 * (512 * 512 + 512 * 512 + 512 * h) for h in (2, 3, 3, 12, 12))
    want = pre + encoder + interim + proj + query + 8 * (self_attn + cross + ffn + heads)
    reader = R.load_reader("mfu_masked.train")
    assert reader.masked_forward(w, m) == want
    run = {"spec": R.load_cell(CELL), "batch": 8, "kind": "train", "steps": 10,
           "window_s": 2.0}
    assert reader.step_flops(run) == 3 * 8 * want
    assert reader.read(run) == pytest.approx(100 * 10 * 24 * want / 2.0 / 495e12)
    assert reader.read(dict(run, kind="eval")) is None


def test_masked_flops_against_counter():
    """The reference's masked detector at a small size: PyTorch counts the
    count plus the radius-masked QK and PV products it leaves out."""
    from portbench.reference.datasets.config import SunrgbdAnonymousConfig
    from portbench.reference.models.model_3detr import CoDA3DETR

    w = dict(preenc_npoints=256, nsample=64, in_channels=3, enc_dim=32, enc_ffn_dim=16,
             dec_dim=64, dec_nlayers=2, dec_ffn_dim=32, nqueries=16, heads=[2, 3, 3, 12, 12])
    m = dict(interim_npoints=128, interim_nsample=32, interim_mlp=[32, 256, 256, 32])
    model = CoDA3DETR(SunrgbdAnonymousConfig(), enc_dim=32, dec_dim=64, enc_type="masked",
                      enc_ffn_dim=16, dec_nlayers=2, dec_ffn_dim=32, preenc_npoints=256,
                      nqueries=16, with_text_head=False, device="cpu").eval()
    pc = torch.rand(2, 2048, 3) * 4
    batch = {"point_clouds": pc, "point_cloud_dims_min": pc.amin(1),
             "point_cloud_dims_max": pc.amax(1)}
    with FlopCounterMode(display=False) as fc:
        model(batch)
    radius_qk_pv = 4 * 32 * (256 ** 2 + 2 * 128 ** 2)
    want = 2 * (R.load_reader("mfu_masked.train").masked_forward(w, m) + radius_qk_pv)
    # the rest left out: position embeddings, box corners' rotations
    assert want <= fc.get_total_flops() <= 1.05 * want


def _run(trace, calls):
    return {"kind": "train", "trace": trace, "spec": R.load_cell(CELL),
            "op_calls": {"attention": calls}}


def test_radius_roofline_floor_is_the_three_calls_bytes():
    # the masked encoder's three calls at B = 8, then the decoder's eight cross-attentions
    calls = [(8, 4, 2048, 2048, 64), (8, 4, 1024, 1024, 64), (8, 4, 1024, 1024, 64)]
    calls += [(8, 4, 128, 1024, 128)] * 8
    reader = R.load_reader("radius_attention_roofline.train")
    assert reader.radius_calls(_run(None, calls)) == calls[:3]
    qkvo = 4 * 8 * 4 * (2 * 2048 * 64 + 2 * 2048 * 64) + 2 * 4 * 8 * 4 * (4 * 1024 * 64)
    xyz = 4 * 8 * 3 * (2 * 2048) + 2 * 4 * 8 * 3 * (2 * 1024)
    assert sum(reader.least_bytes(*c) for c in calls[:3]) == qkvo + xyz
    # 5 ms of D inside encoder:radius; a kernel launched outside it is not counted
    trace = Trace(device_ops=[("attn", 0.0, 3000.0, 1), ("attn", 3000.0, 5000.0, 2),
                              ("gemm", 5000.0, 9000.0, 3)],
                  ranges=[("encoder:radius", 0.0, 10.0), ("encoder:radius", 20.0, 30.0)],
                  launches={1: 5.0, 2: 25.0, 3: 40.0}, window_s=1.0, steps=1)
    got = reader.read(_run(trace, calls))
    assert got == pytest.approx(100 * (qkvo + xyz) / 3.35e12 / 5e-3)
    assert 0 < got < 100


def test_radius_roofline_and_span_readers_without_spans_are_none():
    calls = [(8, 4, 2048, 2048, 64)]
    trace = Trace(device_ops=[("attn", 0.0, 3000.0, 1)], ranges=[("train:forward", 0.0, 10.0)],
                  launches={1: 5.0}, window_s=1.0, steps=1)
    for name in ("radius_attention_roofline.train", "masked_encoder_ms.train",
                 "interim_sa_ms.train"):
        assert R.load_reader(name).read(_run(trace, calls)) is None, name
        assert R.load_reader(name).read(_run(None, calls)) is None, name
    reader = R.load_reader("radius_attention_roofline.train")
    trace.ranges.append(("encoder:radius", 0.0, 10.0))
    assert reader.read(_run(trace, [])) is None  # no call seen
    assert reader.read(dict(_run(trace, calls), kind="eval")) is None


def test_encoder_span_readers():
    # two traced steps: the interim SA's ops inside encoder:interim, inside encoder:masked
    trace = Trace(device_ops=[("attn", 0.0, 1000.0, 1), ("fps", 1000.0, 1500.0, 2),
                              ("mlp", 1500.0, 3500.0, 3), ("dec", 3500.0, 9500.0, 4)],
                  ranges=[("encoder:masked", 0.0, 100.0), ("encoder:interim", 20.0, 60.0),
                          ("train:forward", 0.0, 200.0)],
                  launches={1: 10.0, 2: 30.0, 3: 50.0, 4: 150.0}, window_s=1.0, steps=2)
    run = _run(trace, [])
    assert R.load_reader("masked_encoder_ms.train").read(run) == pytest.approx(3.5 / 2)
    assert R.load_reader("interim_sa_ms.train").read(run) == pytest.approx(2.5 / 2)


def _tiny():
    from portbench.tests.test_portbench_faults import _overrides

    ov = _overrides(CELL)
    # 256 pre-encoder points: at 64 the interim SA's BatchNorm is ill-conditioned
    ov["config"]["flags"] += ["--preenc_npoints", "256"]
    ov["config"]["widths"]["detector"]["preenc_npoints"] = 256
    ov["config"]["widths"]["masked_encoder"].update(interim_npoints=128,
                                                    interim_mlp=[32, 256, 256, 32])
    return ov


@pytest.mark.parametrize("fault,correct",
                         [(None, True), ("frozen_state", False), ("half_batch", False)])
def test_harness_runs_the_cell(fault, correct):
    result, run = R.run_cell(CELL, 2 ** 31 + 17, 1.0, 1, "cpu", fault=fault, overrides=_tiny())
    assert result["correct"] is correct, result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "update_gap"}
    assert run["steps"] >= 1
    assert result["metrics"]["mfu_masked.train"]["value"] > 0
