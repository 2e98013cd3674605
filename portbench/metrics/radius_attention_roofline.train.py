"""radius_attention_roofline.train: Least time over device time of kernel D's radius-masked calls, the operations launched inside the program's encoder:radius spans, %.

The least time is the bytes alone at 3.35 TB/s: q, k and v read once, the
output written once, and both coordinate sets (B x S x 3 floats each) read
once, for each call the harness saw in `op_calls["attention"]` with
Sq = Skv != nqueries (the encoder's self-attention; the decoder's
cross-attention has Sq = nqueries).  The QK and PV products are not
counted: the allowed pairs depend on the data (0.05-4.2% of them at the
three radii), and their operations then take under a tenth of the bytes'
time.  So the floor holds for a kernel that skips key tiles, and the share
cannot read over 100%."""

from portbench import flops

LAYER = "Kernels: ops and csrc through _kernels"
SOURCE = "device_trace"
MOVES = "train_scenes_per_s"
UNIT = "%"
BETTER = "higher"
WORKLOADS = ["3detr-m-sunrgbd.train"]
SPAN = "encoder:radius"


def radius_calls(run) -> list:
    """The (B, H, Sq, Skv, D) of the traced stretch's radius-masked calls."""
    nq = int(run["spec"].config["widths"]["detector"]["nqueries"])
    return [c for c in run["op_calls"].get("attention") or [] if c[2] == c[3] != nq]


def least_bytes(b: int, h: int, sq: int, skv: int, d: int, itemsize: int = 4) -> int:
    """q, k, v and the output, and the query and key coordinates."""
    return flops.attention_cost(b, h, sq, skv, d, itemsize)[1] + itemsize * b * 3 * (sq + skv)


def read(run):
    tr = run["trace"]
    if run["kind"] != "train" or tr is None or not tr.count_ranges(SPAN):
        return None
    calls = radius_calls(run)
    device_s = tr.device_s_in(SPAN)
    if not calls or device_s <= 0:
        return None
    return 100.0 * sum(least_bytes(*c) for c in calls) / flops.PEAK_BYTES / device_s
