#!/usr/bin/env python3
"""Kernels D and C on the card: correctness sweep, times against the library,
and D's key-split sweep.

    python3 scripts/bench_torch_attention.py [--no-sweep]

1. Kernel D against its plain version at every head width (16, 32, 64, 128),
   ragged shapes (Sq, Skv not multiples of the tiles, Skv odd), with and
   without the radius mask and attention-weight dropout: max |error|, and
   the (splits, chunk) the wrapper chose.
2. D at the paths' shapes (B = 32, H = 4: encoder 2048 x 2048 x 64, decoder
   cross 128 x 2048 x 128, decoder self 128 x 128 x 128, radius-masked
   encoder) against scaled_dot_product_attention and the plain version, and
   kernel C at 32 x 2048 x 64 x 3 against torch.gather.  Times are CUDA
   events around 10 back-to-back calls, median of 7, kernel and library in
   turns (kernel, library, kernel, library).
3. Unless --no-sweep: D's time at the decoder's shapes (B = 32 and 8) and
   the training encoder's (B = 8) for 1 to 16 key splits, and the host's
   time a `group_points` call takes.
Needs a GPU; builds the kernels as the port does.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

from coda_neurips2023_tpu_torch import _kernels  # noqa: E402
from coda_neurips2023_tpu_torch.ops import masked_attention as ma  # noqa: E402
from coda_neurips2023_tpu_torch.ops.grouping import group_points, group_points_plain  # noqa: E402

ATTN_TOL = 1e-4


def time_ms(fn, reps=7, inner=10):
    for _ in range(2):
        fn()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def qkv(g, b, h, sq, skv, d):
    q = torch.randn((b, h, sq, d), device="cuda", generator=g) / d ** 0.5
    k = torch.randn((b, h, d, skv), device="cuda", generator=g)
    v = torch.randn((b, h, skv, d), device="cuda", generator=g)
    return q, k, v


def correctness(g):
    worst = 0.0
    for d in ma.KERNEL_HEAD_DIMS:
        for b, h, sq, skv in ((2, 3, 64, 64), (2, 3, 70, 130), (2, 3, 5, 200), (2, 3, 33, 1001),
                              (2, 3, 130, 777)):
            for radius in (0.0, 0.5):
                for dropout in (0.0, 0.1):
                    q, k, v = qkv(g, b, h, sq, skv, d)
                    kx = torch.rand((b, skv, 3), device="cuda", generator=g) * 2 - 1
                    qx = torch.rand((b, sq, 3), device="cuda", generator=g) * 2 - 1
                    qx[:, 0] = 100.0  # a row with no allowed key when masked
                    seed = torch.randint(0, 2 ** 62, (), device="cuda", generator=g)
                    args = (q, k, v, qx, kx.transpose(1, 2).contiguous(), radius, dropout, seed)
                    err = (ma.masked_attention(*args) - ma.masked_attention_plain(*args)).abs().max().item()
                    worst = max(worst, err)
                    print(f"D d={d} {b}x{h}x{sq}x{skv} r={radius} p={dropout} "
                          f"splits={ma.attention_splits(b, h, sq, skv, d)} err={err!r}"
                          + ("" if err <= ATTN_TOL else "  <-- over ATTN_TOL"))
    print(f"D worst error over the sweep: {worst!r} (ATTN_TOL {ATTN_TOL})")
    return worst <= ATTN_TOL


def path_shapes(g):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, sq, skv, d, radius in (("encoder", 2048, 2048, 64, 0.0),
                                      ("decoder cross", 128, 2048, 128, 0.0),
                                      ("decoder self", 128, 128, 128, 0.0),
                                      ("radius-masked", 2048, 2048, 64, 1.44)):
        q, k, v = qkv(g, 32, 4, sq, skv, d)
        xyz = torch.rand((32, skv, 3), device="cuda", generator=g) * 4 - 2
        qx, kt = xyz[:, :sq].contiguous(), xyz.transpose(1, 2).contiguous()
        kern = lambda: ma.masked_attention(q, k, v, qx, kt, radius)
        plain = lambda: ma.masked_attention_plain(q, k, v, qx, kt, radius)
        err = (kern() - plain()).abs().max().item()
        k_t = k.transpose(2, 3).contiguous()
        lib = lambda: sdpa(q, k_t, v, scale=1.0)  # the unmasked function; q arrives scaled
        ts = [time_ms(kern), time_ms(lib), time_ms(kern), time_ms(lib)]
        print(f"D {label} B=32 H=4 Sq={sq} Skv={skv} D={d} splits={ma.attention_splits(32, 4, sq, skv, d)}"
              f" err={err!r} kernel_ms={ts[0]!r},{ts[2]!r} sdpa_ms={ts[1]!r},{ts[3]!r}"
              f" plain_ms={time_ms(plain)!r}")
    xyz = torch.randn((32, 20000, 3), device="cuda", generator=g)
    idx = torch.randint(0, 20000, (32, 2048, 64), device="cuda", generator=g, dtype=torch.int32)
    flat = idx.reshape(32, -1, 1).long().expand(-1, -1, 3)
    equal = torch.equal(group_points(xyz, idx), group_points_plain(xyz, idx))
    kern = lambda: group_points(xyz, idx)
    lib = lambda: torch.gather(xyz, 1, flat)
    ts = [time_ms(kern), time_ms(lib), time_ms(kern), time_ms(lib)]
    print(f"C 32x2048x64x3 (random indices) bit-equal={equal} kernel_ms={ts[0]!r},{ts[2]!r} "
          f"gather_ms={ts[1]!r},{ts[3]!r}")
    return equal


def split_sweep(g):
    chosen = ma.attention_splits
    try:
        for b, sq, skv, d in ((32, 128, 2048, 128), (8, 128, 2048, 128), (8, 2048, 2048, 64)):
            q, k, v = qkv(g, b, 4, sq, skv, d)
            want = ma.masked_attention_plain(q, k, v, None, None, 0.0)
            res = {}
            for n in (1, 2, 3, 4, 6, 8, 12, 16):
                per = -(-skv // ma.key_tile(d) // n) * ma.key_tile(d)
                ma.attention_splits = lambda *a, per=per: (-(-skv // per), per)
                err = (ma.masked_attention(q, k, v) - want).abs().max().item()
                res[f"{-(-skv // per)}x{per}"] = (round(time_ms(lambda: ma.masked_attention(q, k, v)), 4),
                                                  f"{err:.1e}")
            print(f"D splits B={b} Sq={sq} Skv={skv} D={d} policy={chosen(b, 4, sq, skv, d)}: "
                  f"{{splits x chunk: (ms, err)}} {res}")
    finally:
        ma.attention_splits = chosen
    xyz = torch.randn((8, 20000, 3), device="cuda", generator=g)
    idx = torch.randint(0, 20000, (8, 2048, 64), device="cuda", generator=g, dtype=torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        group_points(xyz, idx)
    host_us = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    print(f"group_points B=8: host us a call {host_us!r}; ms a call back to back "
          f"{time_ms(lambda: group_points(xyz, idx), inner=50)!r}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-sweep", action="store_true", help="skip the key-split sweep")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_torch_attention: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    t0 = time.perf_counter()
    _kernels.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(0)
    ok = correctness(g)
    ok = path_shapes(g) and ok
    if not args.no_sweep:
        split_sweep(g)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
