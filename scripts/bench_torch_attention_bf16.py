#!/usr/bin/env python3
"""Kernels D-bf16 and E-bf16 against an earlier checkout's, and D-bf16's key
split, on the card: what phase 18 (a) of `chip_smoke.py` does not time.
Phase 18 (a) holds both kernels against their plain versions, prints
ptxas's registers and spills, runs the division check and times the kernels
against SDPA; this script imports its timing from there.

    python3 scripts/bench_torch_attention_bf16.py [--parent DIR] [--no-sweep]

1. With --parent DIR: D-bf16 at the encoder's (32 x 4 x 2048 x 2048 x 64),
   the decoder's cross-attention (32 x 4 x 128 x 2048 x 128) and the
   radius-masked encoder's shapes, E-bf16 at 128 and 256 crops x 12 x 197
   x 64, each against DIR's kernel (its library built from its own sources,
   called through the C interface of the wgmma kernel before its dropout
   arguments, with that kernel's key split), in turns; D-bf16 without
   dropout and with the transformer's 0.1, and without dropout also
   through its own C interface as the parent is called (no Python wrapper);
   the radius case also with kernel D and SDPA in fp32 (the boolean mask
   made outside the timed window).  Then the SASS (cuobjdump) of D-bf16's
   instances without dropout against the parent's, instruction by
   instruction.
2. Unless --no-sweep: D-bf16 at the decoder's cross-attention shape as
   `main --test_only --compute_dtype bf16 --batchsize_per_gpu_test B` runs
   it (Sq = 128 queries, Skv = 2048 keys, 4 heads of 128), at B = 8, 16, 24
   and 32 scenes: the split policy's choice against one chunk and other
   splits, in turns.  Device time: the calls are queued behind a sleep on
   the card, so the host's cost of a call (tensor maps, allocations) does
   not hide the kernels' time.
Needs a GPU and nvcc.
"""

import argparse
import ctypes
import difflib
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from chip_smoke import time_in_turns  # noqa: E402
from coda_neurips2023_tpu_torch import _kernels  # noqa: E402
from coda_neurips2023_tpu_torch.ops import masked_attention as ma  # noqa: E402
from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention  # noqa: E402
from coda_neurips2023_tpu_torch.utils.device import multi_processor_count  # noqa: E402

BF16 = torch.bfloat16
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's clock: the host queues the calls meanwhile


def d_inputs(g, b, h, sq, skv, d):
    q = (torch.randn((b, h, sq, d), device="cuda", generator=g) / d ** 0.5).to(BF16)
    k = torch.randn((b, h, d, skv), device="cuda", generator=g).to(BF16)
    v = torch.randn((b, h, skv, d), device="cuda", generator=g).to(BF16)
    return q, k, v


def parent_library(parent):
    """DIR's kernel library, built from DIR's own sources."""
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.');"
         "from coda_neurips2023_tpu_torch import _kernels; print(_kernels.build())"],
        cwd=parent, check=True, stdout=subprocess.PIPE, text=True)
    lib = ctypes.CDLL(out.stdout.strip().splitlines()[-1])
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.coda_attention_bf16.argtypes = [P] * 8 + [I] * 6 + [F, I, I, I, P]
    lib.coda_attention_combine.argtypes = [P, P, P, I, I, I, I, I, I, P]
    lib.coda_vit_attention_bf16.argtypes = [P, P, P, P, I, I, I, F, P]
    return lib


def parent_d(lib, q, k, v, qx, kx, radius, sms):
    """The earlier kernel D-bf16 on the same inputs, with its own split (Skv
    a multiple of 8: no padding)."""
    b, h, sq, d = q.shape
    skv = v.shape[2]
    splits, chunk = ma.attention_splits(b, h, sq, skv, d, sms, bf16=True)
    out = torch.empty_like(q)
    op = torch.empty((splits, b, h, sq, d), device="cuda") if splits > 1 else None
    ml = torch.empty((splits, b, h, sq, 2), device="cuda") if splits > 1 else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        assert lib.coda_attention_bf16(ptr(q), ptr(k), ptr(v), ptr(qx), ptr(kx), ptr(out),
                                       ptr(op), ptr(ml), b, h, sq, skv, skv, d, radius, 1, splits,
                                       chunk, stream) == 0
        if splits > 1:
            assert lib.coda_attention_combine(ptr(op), ptr(ml), ptr(out), b, h, sq, d, splits, 1,
                                              stream) == 0
        return out
    return run


def own_d(q, k, v, sms):
    """This checkout's D-bf16 without dropout through its C interface, as
    `parent_d` calls the parent's (Skv a multiple of 8, no radius)."""
    lib = _kernels.library()
    b, h, sq, d = q.shape
    skv = v.shape[2]
    splits, chunk = ma.attention_splits(b, h, sq, skv, d, sms, bf16=True)
    out = torch.empty_like(q)
    op = torch.empty((splits, b, h, sq, d), device="cuda") if splits > 1 else None
    ml = torch.empty((splits, b, h, sq, 2), device="cuda") if splits > 1 else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        assert lib.coda_attention_bf16(ptr(q), ptr(k), ptr(v), None, None, None, ptr(out),
                                       ptr(op), ptr(ml), b, h, sq, skv, skv, d, 0.0, 0, 0.0, 1,
                                       splits, chunk, stream) == 0
        if splits > 1:
            assert lib.coda_attention_combine(ptr(op), ptr(ml), ptr(out), b, h, sq, d, splits, 1,
                                              stream) == 0
        return out
    return run


def sass(path):
    """{mangled kernel name: its SASS instructions} of a library (cuobjdump)."""
    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", path], check=True, stdout=subprocess.PIPE,
                          text=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        else:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m and name:
                funcs[name].append(m.group(1))
    return funcs


def compare_sass(parent):
    """D-bf16's instances without dropout against the parent's, by opcode
    and by whole instruction (the constant bank's parameter offsets move
    with the new parameters)."""
    mine, theirs = sass(str(_kernels.LIBRARY)), sass(parent._name)

    def opcodes(xs):
        return [" ".join(x.split()[:2]) if x.startswith("@") else x.split()[0] for x in xs]

    for d in (16, 32, 64, 128):
        for t in ("13__nv_bfloat16", "f"):
            a = next(v for k, v in mine.items() if f"attention_bf16_kernelILi{d}E{t}Lb0E" in k)
            b = next(v for k, v in theirs.items() if f"attention_bf16_kernelILi{d}E{t}E" in k)
            differ = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            print(f"D-bf16 SASS D={d} out {'bf16' if t != 'f' else 'f32'}, no dropout: "
                  f"{len(a)} instructions, parent {len(b)}; opcodes equal "
                  f"{opcodes(a) == opcodes(b)}; instructions that differ {differ}")
            for line in list(difflib.unified_diff(opcodes(b), opcodes(a), lineterm="", n=0))[2:12]:
                print(f"    {line}")


def parent_times(g, parent):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sms = multi_processor_count(torch.device("cuda"))
    centres = torch.rand((32, 2048, 3), device="cuda", generator=g) * 4 - 2
    for label, sq, skv, d, radius in (("encoder", 2048, 2048, 64, 0.0),
                                      ("decoder", 128, 2048, 128, 0.0),
                                      ("radius", 2048, 2048, 64, 1.2 ** 2)):
        q, k, v = d_inputs(g, 32, 4, sq, skv, d)
        qx, kx = centres[:, :sq].contiguous(), centres.transpose(1, 2).contiguous()
        seed = torch.randint(0, 2 ** 62, (), dtype=torch.int64, device="cuda", generator=g)
        fns = [lambda: ma.masked_attention(q, k, v, qx, kx, radius, "bfloat16"),
               parent_d(parent, q, k, v, qx, kx, radius, sms),
               lambda: ma.masked_attention(q, k, v, qx, kx, radius, "bfloat16", 0.1, seed)]
        names = ["kernel", "parent", "kernel_dropout"]
        if radius == 0:
            fns.append(own_d(q, k, v, sms))
            names.append("kernel_c_interface")
        if radius > 0:  # kernel D (fp32) on the same inputs, and fp32 SDPA with the mask
            allowed = (ma._scores(q[:, :1].float(), k[:, :1].float(), qx, kx, radius)
                       != torch.finfo(torch.float32).min)
            q32, k32, v32 = (t.float() for t in (q, k, v))
            kt32 = k32.transpose(2, 3).contiguous()
            fns += [lambda: ma.masked_attention(q32, k32, v32, qx, kx, radius),
                    lambda: sdpa(q32, kt32, v32, attn_mask=allowed, scale=1.0)]
            names += ["fp32_kernel_D", "fp32_sdpa_mask"]
        times = time_in_turns(torch, *fns)
        print(f"D-bf16 {label} B=32 H=4 Sq={sq} Skv={skv} D={d}: "
              + " ".join(f"{n}_ms={t!r}" for n, t in zip(names, times)))
    for crops in (128, 256):
        q, k, v = (torch.randn((crops, 12, 197, 64), device="cuda", generator=g).to(BF16)
                   for _ in range(3))
        out = torch.empty_like(q)

        def run(out=out, q=q, k=k, v=v, crops=crops):
            assert parent.coda_vit_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), crops * 12, 197, 64,
                0.125, torch.cuda.current_stream().cuda_stream) == 0
            return out
        times = time_in_turns(torch, lambda: vit_attention(q, k, v), run)
        print(f"E-bf16 {crops} crops x 12 x 197 x 64: kernel_ms={times[0]!r} "
              f"parent_ms={times[1]!r}")


def device_ms(fn, calls=20):
    """Milliseconds a call on the card: `calls` calls queued behind a sleep,
    timed between CUDA events; None where the host did not finish queueing
    them before the sleep ended."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    queued_in_time = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls if queued_in_time else None


def split_sweep(g, rounds=5):
    policy = ma.attention_splits
    sms = multi_processor_count(torch.device("cuda"))
    tk = ma.key_tile(128, bf16=True)
    try:
        for b in (8, 16, 24, 32):
            q, k, v = d_inputs(g, b, 4, 128, 2048, 128)
            chosen = policy(b, 4, 128, 2048, 128, sms, bf16=True)
            variants = {chosen}
            for n in (1, 2, 4, 8):
                per = -(-2048 // tk // n) * tk
                variants.add((-(-2048 // per), per))
            times = {sc: [] for sc in sorted(variants)}
            for _ in range(rounds):
                for sc in times:
                    ma.attention_splits = lambda *a, sc=sc, **kw: sc
                    fn = lambda: ma.masked_attention(q, k, v, None, None, 0.0, "bfloat16")  # noqa: E731
                    fn()
                    times[sc].append(device_ms(fn))
            ma.attention_splits = policy
            med = {f"{s}x{c}": (statistics.median(t) if None not in t else None)
                   for (s, c), t in times.items()}
            print(f"D-bf16 split sweep B={b} H=4 Sq=128 Skv=2048 D=128, {sms} SMs, "
                  f"policy {chosen[0]}x{chosen[1]}: device ms a call (median of {rounds} "
                  f"rounds in turns) {med}")
            print(f"  rounds: { {f'{s}x{c}': t for (s, c), t in times.items()} }")
    finally:
        ma.attention_splits = policy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="an earlier checkout to time against")
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, text=True).stdout.strip())
    _kernels.build()
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        if args.parent:
            parent = parent_library(args.parent)
            parent_times(g, parent)
            compare_sass(parent)
        if not args.no_sweep:
            split_sweep(g)


if __name__ == "__main__":
    main()
