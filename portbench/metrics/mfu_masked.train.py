"""mfu_masked.train: Model FLOPs of the window's steps over its time, against 495 TFLOP/s, for the detector with the masked encoder (--enc_type masked).

The count (`masked_forward`) follows flops.detector_forward, whose helpers
it uses: the pre-encoder at preenc_npoints; encoder layer 0 at
preenc_npoints and layers 1 and 2 at the interim SA's points, each with its
Q, K, V and output projections and its FFN; the interim SA's shared MLP
(enc_dim + 3 -> 256 -> 256 -> enc_dim) over interim points x nsample rows;
the encoder-to-decoder projection over the interim points; the queries; the
decoder with its cross-attention over the interim points; the heads.  The
radius-masked QK and PV products are left out (their allowed pairs depend
on the data), so the share can only read low.  A step counts three
forwards."""

from portbench import flops, readers

LAYER = "Step: make_train_step and the stage-1 fused step"
SOURCE = "host_clock"
MOVES = "train_scenes_per_s"
UNIT = "%"
BETTER = "higher"
WORKLOADS = ["3detr-m-sunrgbd.train"]


def masked_forward(w: dict, m: dict) -> int:
    """Model FLOPs of one scene's forward.  `w`: the detector's widths as
    flops.detector_forward takes them; `m`: the configuration's
    widths["masked_encoder"] (interim_npoints, interim_nsample, interim_mlp)."""
    n0, k = w["preenc_npoints"], w["nsample"]
    n1, k1 = m["interim_npoints"], m["interim_nsample"]
    enc, dec, nq = w["enc_dim"], w["dec_dim"], w["nqueries"]
    mlp = m["interim_mlp"]

    def enc_layer(s):  # the four projections and the FFN, no QK or PV
        return 4 * 2 * s * enc * enc + flops._mlp(s, (enc, w["enc_ffn_dim"], enc))

    pre = flops._mlp(n0 * k, (w["in_channels"], 64, 128, enc))
    encoder = enc_layer(n0) + 2 * enc_layer(n1)
    interim = flops._mlp(n1 * k1, (mlp[0] + 3, *mlp[1:]))
    proj = flops._mlp(n1, (enc, 512, 512, dec))
    query = flops._mlp(nq, (dec, dec, dec))
    dec_layer = (flops._attention_block(nq, nq, dec) + flops._attention_block(nq, n1, dec)
                 + flops._mlp(nq, (dec, w["dec_ffn_dim"], dec)))
    heads = w["dec_nlayers"] * sum(flops._mlp(nq, (dec, dec, dec, h)) for h in w["heads"])
    return pre + encoder + interim + proj + query + w["dec_nlayers"] * dec_layer + heads


def step_flops(run) -> int:
    w = run["spec"].config["widths"]
    return 3 * run["batch"] * masked_forward(dict(w["detector"], heads=w["heads_out"]),
                                             w["masked_encoder"])


def read(run):
    if run["kind"] != "train" or run["steps"] < 1 or readers.window_s(run) <= 0:
        return None
    return 100.0 * run["steps"] * step_flops(run) / readers.window_s(run) / flops.PEAK_FLOPS
