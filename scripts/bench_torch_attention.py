#!/usr/bin/env python3
"""Kernels D, E and C on the card: correctness sweep, times against the
library, D's key-split sweep and E's two resident forms.

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
3. Kernel E's two resident forms (scripts/vit_attention_variants.cu: K and
   V split into TF32 hi and lo once in shared memory, as the package runs
   it, or kept in fp32 and split at each fragment load) against the plain
   version and scaled_dot_product_attention at 32, 128 and 256 crops of
   ViT-B/16 (12 heads, S = 197, D = 64), the three timed in turns twice;
   and E's time at 1 head, one and two waves of heads, and 1536 heads.
4. Unless --no-sweep: D's time at the decoder's shapes (B = 32 and 8) and
   the training encoder's (B = 8) for 1 to 16 key splits, and the host's
   time a `group_points` call takes.
Needs a GPU and nvcc; builds the kernels as the port does, the variants
into build/.
"""

import argparse
import ctypes
import math
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
from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention, vit_attention_plain  # noqa: E402
from coda_neurips2023_tpu_torch.utils.device import multi_processor_count  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ATTN_TOL = 1e-4
SMS = None  # the card's SM count, read in main()


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
                    args = (q, k, v, qx, kx.transpose(1, 2).contiguous(), radius, "float32",
                            dropout, seed)
                    err = (ma.masked_attention(*args) - ma.masked_attention_plain(*args)).abs().max().item()
                    worst = max(worst, err)
                    print(f"D d={d} {b}x{h}x{sq}x{skv} r={radius} p={dropout} "
                          f"splits={ma.attention_splits(b, h, sq, skv, d, SMS)} err={err!r}"
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
        print(f"D {label} B=32 H=4 Sq={sq} Skv={skv} D={d} splits={ma.attention_splits(32, 4, sq, skv, d, SMS)}"
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


def vit_forms(g):
    """Kernel E's resident forms and SDPA at the tower's shapes."""
    so = os.path.join(ROOT, "build", "vit_attention_variants.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so,
                    os.path.join(ROOT, "scripts", "vit_attention_variants.cu")],
                   check=True, stdout=subprocess.DEVNULL)
    lib = ctypes.CDLL(so)
    lib.vit_attention_form.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ok = True
    for crops in (32, 128, 256):
        q, k, v = (torch.randn((crops, 12, 197, 64), device="cuda", generator=g) for _ in range(3))
        want = vit_attention_plain(q, k, v)
        fns = {}
        for form, presplit in (("split_once", 1), ("split_at_load", 0)):
            out = torch.empty_like(q)

            def fn(out=out, presplit=presplit):
                err = lib.vit_attention_form(presplit, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             out.data_ptr(), crops * 12, 197, 64, 1 / math.sqrt(64),
                                             torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"vit_attention_form: CUDA error {err}")
                return out

            err = (fn() - want).abs().max().item()
            ok = ok and err <= ATTN_TOL
            print(f"E {form} {crops} crops err={err!r}")
            fns[form] = fn
        err = (vit_attention(q, k, v) - want).abs().max().item()
        ok = ok and err <= ATTN_TOL
        fns["sdpa"] = lambda: sdpa(q, k, v)
        times = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                times[name].append(time_ms(fn))
        print(f"E {crops} crops x 12 x 197 x 64: package err={err!r} "
              + " ".join(f"{name}_ms={statistics.fmean(t)!r}" for name, t in times.items())
              + f" plain_ms={time_ms(lambda: vit_attention_plain(q, k, v))!r}")
    # a block a head, one block an SM: time against heads shows a block's
    # own latency (one head) apart from what blocks contend for (many waves)
    waves = {}
    for heads in (1, SMS, 2 * SMS, 1536):
        q, k, v = (torch.randn((heads, 1, 197, 64), device="cuda", generator=g) for _ in range(3))
        waves[heads] = time_ms(lambda: vit_attention(q, k, v))
    print(f"E ms by heads (S=197, D=64; {SMS} SMs): {waves}")
    return ok


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
            print(f"D splits B={b} Sq={sq} Skv={skv} D={d} policy={chosen(b, 4, sq, skv, d, SMS)}: "
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
    global SMS
    SMS = multi_processor_count("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    ok = correctness(g)
    ok = path_shapes(g) and ok
    ok = vit_forms(g) and ok
    if not args.no_sweep:
        split_sweep(g)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
