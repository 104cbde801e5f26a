#!/usr/bin/env python3
"""Time variants of the SSD backward kernels against each other on one card.

Each variant is ``csrc/ssd_scan_bwd.cu`` and ``csrc/ssd_mma.cuh`` with a
few text substitutions (the table VARIANTS below; a CPU test checks that
each still matches the sources), built by the port's own nvcc call
(``_build.compile_source``) into a temporary directory, all variants at
once, and bound with the port's signatures (``ssd_scan._BWD_LIB.bind``).
The script then runs every variant once at Zamba2-2.7B's shape (b=2,
T=4096, H=80, P=64, N=64, chunk 256, x bf16, f32 products) against
``ssd_backward_plain``, times them in turns (first to last, last to first,
first to last; CUDA events over 20 calls each) and splits each by kernel
with ``torch.profiler``.  It prints, per variant: registers and spills
(ptxas), the most frequent SASS opcodes of each kernel's main instance
(cuobjdump), the error of each gradient (max |kernel - plain| / max |plain|,
less one bf16 spacing where stored in bf16), the three times and the split.

Variants that change the result on purpose (``no_mma``, ``no_copy``) show
where the time goes, not a faster kernel: their errors are meaningless.

Run from the root of a checkout, on a machine with an NVIDIA card and nvcc:

    python3 tools/ssd_bwd_variants.py [variant ...]
"""
import collections
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402

SHAPE = (2, 4096, 80, 64, 64, 256)            # Zamba2-2.7B: b, T, H, P, N, chunk
_MMA_TERMS = """#pragma unroll
  for (int term = 0; term < 3; ++term) {
    if ((term == 0 && EA) || (term == 1 && EB)) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(acc[mt][nt], term == 0 ? al[mt] : ah[mt], term == 1 ? bl[nt] : bh[nt]);
  }"""
_MMA_ASM = """  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));"""
_HI = "  const uint32_t hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;"
VARIANTS = {
    "base": [],
    # hi by cvt.rna.tf32.f32 (a NaN test and a select more per element)
    "cvt_hi": [(_HI, "  const uint32_t hi = tf32_rna(a);")],
    # lo by the same integer rounding: fewer instructions, but a NaN whose
    # mantissa overflows (0x7fffffff) turns into -0, so NaNs can vanish
    "int_lo": [("  return {hi, tf32_rna(a - __uint_as_float(hi))};",
                "  const uint32_t d = __float_as_uint(a - __uint_as_float(hi));\n"
                "  return {hi, (d + 0x1000u) & 0xffffe000u};")],
    # a tile's three terms back to back on one accumulator, in program order
    "serial_terms": [(_MMA_TERMS, """#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if constexpr (!EA) mma_tf32(acc[mt][nt], al[mt], bh[nt]);
      if constexpr (!EB) mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
      mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
    }"""), ("  asm(\n      \"mma.sync", "  asm volatile(\n      \"mma.sync")],
    # exp(cs_i − cs_j) of every pair, also where the tile pair factorises
    "exact_decay": [("      if (ti > tj) {\n", "      if (false) {\n"),
                    ("if (!BF16C && k0 >= r0 + TILE) {", "if (false) {")],
    # no tensor-core product: the operands are still read and split
    "no_mma": [(_MMA_ASM, "  d[0] += __uint_as_float(a[0] ^ b[0] ^ a[1]);\n"
                          "  d[1] += __uint_as_float(a[2] ^ b[1] ^ a[3]);")],
    # no copy into shared memory: the products read what is there
    "no_copy": [("    cp_async16(dst, src, valid * static_cast<int>(sizeof(T)));",
                 "    (void)src;")],
}


EDITED = ("ssd_scan_bwd.cu", "ssd_mma.cuh")


def variant_sources(name, texts):
    """``texts`` ({file: source} of EDITED) with VARIANTS[name]'s
    substitutions; ValueError where one no longer matches the sources."""
    for a, b in VARIANTS[name]:
        if not any(a in t for t in texts.values()):
            raise ValueError(f"{name}: substitution not found: {a[:60]!r}")
        texts = {f: t.replace(a, b) for f, t in texts.items()}
    return texts


def build(name, root, libs):
    d = root / name
    shutil.copytree(_build.CSRC, d)
    out = d / "lib.so"
    try:
        files = variant_sources(name, {f: (d / f).read_text() for f in EDITED})
        for f, t in files.items():
            (d / f).write_text(t)
        _, log = _build.compile_source(d / "ssd_scan_bwd.cu", out)
    except (ValueError, RuntimeError) as e:
        print(f"{name}: {str(e)[-4000:]}", flush=True)
        return
    main = []                 # the bf16-x, f32-product instances, and kernels with none
    for entry, (regs, spill, _) in _build.ptxas_usage(log).items():
        k = re.search(r"ssd_bwd_\w+?kernel", entry)
        rest = entry[k.end():] if k else ""
        if k and "Lb1" not in rest and "If" not in rest:
            main.append((k.group(), regs, spill))
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass", str(out)],
                          capture_output=True, text=True).stdout
    census = []
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        head = fn.split("\n", 1)[0]
        k = re.search(r"(ssd_bwd_\w+?kernel)", head)
        if not k or "nv_bfloat16" not in head or "Lb1" in head:
            continue
        ops = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn))
        census.append(f"{k.group(1)} {sum(ops.values())} instructions: " + " ".join(
            f"{o} {n}" for o, n in ops.most_common(10)))
    print(f"{name}: registers/spill bytes (bf16 x, f32 products) "
          + ", ".join(f"{k} {rg}/{sp}" for k, rg, sp in main)
          + "".join(f"\n  {c}" for c in census), flush=True)
    libs[name] = ssd._BWD_LIB.bind(ctypes.CDLL(str(out)))


def cuda_ms(fn, iters=20):
    for _ in range(3):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def main(names):
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        threads = [threading.Thread(target=build, args=(n, Path(tmp), libs)) for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _build.load("ssd_scan")
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(7)
        b, T, H, P, N, l = SHAPE
        x = torch.randn((b, T, H, P), generator=g, device=dev).to(torch.bfloat16)
        dt = torch.nn.functional.softplus(torch.randn((b, T, H), generator=g, device=dev)) * 0.1
        A = -torch.exp(torch.randn((H,), generator=g, device=dev))
        Bm, Cm = (torch.randn((b, T, N), generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        dy = torch.randn((b, T, H, P), generator=g, device=dev)
        _, _, scratch = ssd.ssd_forward_with_scratch(x, dt, A, Bm, Cm, chunk=l)
        want = ssd.ssd_backward_plain(x, dt, A, Bm, Cm, l, dy)
        saved = ssd._BWD_LIB.cdll

        def call():
            return ssd.ssd_backward(x, dt, A, Bm, Cm, l, dy, scratch)

        live = [n for n in names if n in libs]
        try:
            for n in live:
                ssd._BWD_LIB.cdll = libs[n]
                got = call()
                torch.cuda.synchronize()
                errs = []
                for u, w in zip(got[:5], want[:5]):
                    d = (u.double() - w.double()).abs()
                    if u.dtype == torch.bfloat16:
                        d = (d - 2.0 ** -7 * w.double().abs()).clamp(min=0)
                    errs.append(float(d.max() / w.abs().max()))
                print(f"{n}: error dx ddt dA dB dC " + " ".join(f"{e:.3e}" for e in errs),
                      flush=True)
            times = {n: [] for n in live}
            for rep in range(3):
                for n in (live if rep % 2 == 0 else live[::-1]):
                    ssd._BWD_LIB.cdll = libs[n]
                    times[n].append(cuda_ms(call))
            from torch.profiler import ProfilerActivity, profile
            for n in live:
                ssd._BWD_LIB.cdll = libs[n]
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        call()
                    torch.cuda.synchronize()
                split = collections.Counter()
                for ev in prof.key_averages():
                    m = re.search(r"ssd_bwd_\w*kernel", ev.key)
                    us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
                    if m and us:
                        split[m.group()] += us / 1e3 / 10
                print(f"{n}: ms " + " ".join(f"{t:.4f}" for t in times[n]) + "; by kernel "
                      + ", ".join(f"{k.removeprefix('ssd_bwd_')} {v:.4f}" for k, v in split.items()),
                      flush=True)
        finally:
            ssd._BWD_LIB.cdll = saved
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
