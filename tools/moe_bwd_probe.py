#!/usr/bin/env python3
"""Where the time of the MoE backward's tensor-core route goes (card only):

    PYTHONPATH=src python3 tools/moe_bwd_probe.py [--rounds 2]

Builds `csrc/moe_gmm_bwd.cu` as it is with `-Xptxas -v` and reports
ptxas's wgmma serialisation warnings (C7518 / C7520) for it and the
register spills of each kernel instance that has any, then builds
a copy with a switch read at each launch (`MOE_BWD_PROBE`) that leaves
one part of `tc::bwd_tc_kernel` out: 1, the consumers' wgmma (each stage
is waited for and released: the load stream alone); 2, the producer's TMA
loads (each stage is marked full at once: the math and the epilogue on
whatever the ring holds); 3, the epilogue (nothing is written). It times
dx, dw and the gated backward at one qwen2-moe-a2.7b layer's training
buffers with every one
of the step's 65,536 assignments kept (`chip_smoke.py` phase 14's
uniform point: E 60, 4 groups of 344, d 2048, f 1408) in each mode, in
turns (whole, 1, 2, 3, whole), beside `torch.bmm` of the same products,
and prints one JSON line a launch and round. The gated backward is also
timed whole from a third copy whose branch-free element function
(`gated_grad_nobranch`) uses the approximate intrinsics `__expf` and
`__fdividef` in place of the exact division and reciprocal, for all
elements: what exactness costs the epilogue. Only times: the outputs of
modes 1-3 and of that copy are not the route's. And it is timed whole, in
turns with the route as it is, from a fourth copy (`--dh-tma`) that reads
dh as the alternative design would: a ring of 3 stages (4 as it is) and
a 32 KB dh tile that the producer loads by TMA under its own barriers
(the first S slabs of a tile issued first), read from shared memory in
the epilogue (as it is: from global memory into registers before the k
loop); that copy's dg and du are checked bit-identical to the route's.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gmm import kernel

OUT = build.BUILD_DIR.parent / "probe"
MODES = {"whole": "0", "no math": "1", "no loads": "2", "no epilogue": "3"}
# (anchor, text put after it) of the copy's switch; each anchor once
EDITS = (
    ("  int E, C, G, M, MT, NT, KT, nseg", ", probe"),
    ("          mbar_wait(&empty[st], ((it / S) & 1) ^ 1);\n",
     "          if (p.probe == 2) {\n"
     "            mbar_arrive(&full[st]);\n"
     "            continue;\n"
     "          }\n"),
    ("          mbar_wait(MODE == kDW ? &ready[st] : &full[st], (it / S) & 1);"
     "\n",
     "          if (p.probe == 1) {\n"
     "            release(st);\n"
     "            continue;\n"
     "          }\n"),
    ("      bool keep[2];\n", "      if (p.probe == 3) continue;\n"),
    ("#include <type_traits>\n", "#include <stdlib.h>\n"),
)


# the approximate copy's element function: (anchor, replacement), each once
APPROX = (("  const float den = 1.f + expf(-gb);\n  float r;",
           "  const float den = 1.f + __expf(-gb);\n  float r;"),
          ("  const float q = __fmaf_rn(rq, __fmaf_rn(-den, q0, gb), q0);",
           "  const float q = __fdividef(gb, den);"),
          ("  const float sig = __fmaf_rn(r, -__fmaf_rn(den, r, -1.f), r);",
           "  const float sig = __fdividef(1.f, den);"),
          ("  return gb >= -40.f && gb <= 0x1p100f && fabsf(gb) >= 0x1p-100f;",
           "  return true;"))


# the dh-by-TMA copy: (anchor, replacement), each anchor once
DH_TMA = (
    ("  static constexpr int kStages = 4;\n",
     "  static constexpr int kStages = NB == 2 ? 3 : 4;\n"
     "  static constexpr int kDh = NB == 2 ? 4 * kSlab : 0;   // dh's tile\n"),
    ("      kSmemMax - 1024 - kStages * kStageBytes - kMisc;",
     "      kSmemMax - 1024 - kStages * kStageBytes - kDh - kMisc - 16;"),
    ("      1024 + kStages * kStageBytes + 2 * kOutBufs * kSlab + kMisc;",
     "      1024 + kStages * kStageBytes + kDh + 2 * kOutBufs * kSlab + "
     "kMisc + 16;"),
    ("  const bf16* dh;\n", "  const bf16* dh;\n  CUtensorMap dhm;\n"),
    ("  if (rc == 0) rc = make_map3(&p.o[1], du, false, f, C, E, 64, 64);\n",
     "  if (rc == 0) rc = make_map3(&p.o[1], du, false, f, C, E, 64, 64);\n"
     "  if (rc == 0) rc = make_map3(&p.dhm, dh, false, f, C, E, 64, 64);\n"),
    ("  unsigned char* sOut = sB + NB * S * Q::kBBytes;",
     "  unsigned char* sDh = sB + NB * S * Q::kBBytes;\n"
     "  unsigned char* sOut = sDh + Q::kDh;"),
    ("  int* counts = reinterpret_cast<int*>(empty + S);",
     "  uint64_t* dh_full = empty + S;\n"
     "  uint64_t* dh_empty = dh_full + 1;\n"
     "  int* counts = reinterpret_cast<int*>(dh_empty + 1);"),
    ("      mbar_init(&empty[s], kConsumerWarps);\n    }\n",
     "      mbar_init(&empty[s], kConsumerWarps);\n    }\n"
     "    mbar_init(dh_full, 1);\n"
     "    mbar_init(dh_empty, kConsumerWarps);\n"),
    ("    if (tid == 0) {\n      int it = 0, e, mt, nt, seg, k0, kv;\n",
     "    if (tid == 0) {\n      int it = 0, e, mt, nt, seg, k0, kv;\n"
     "      int ntile = 0;\n"),
    ("        for (; sl.next(seg, k0, kv); ++it) {\n"
     "          const int st = it % S;\n"
     "          mbar_wait(&empty[st], ((it / S) & 1) ^ 1);\n",
     "        bool dh_issued = MODE != kGB;\n"
     "        auto issue_dh = [&]() {\n"
     "          mbar_wait(dh_empty, (ntile & 1) ^ 1);\n"
     "          mbar_expect_tx(dh_full, Q::kDh);\n"
     "          for (int q = 0; q < 4; ++q)\n"
     "            tma_load(sDh + q * kSlab, &p.dhm, dh_full,\n"
     "                     nt * BN + 64 * (q % 2), mt * kBM + 64 * (q / 2), e);\n"
     "          ++ntile;\n"
     "          dh_issued = true;\n"
     "        };\n"
     "        for (int j = 0; sl.next(seg, k0, kv); ++it, ++j) {\n"
     "          if (!dh_issued && j == S) issue_dh();\n"
     "          const int st = it % S;\n"
     "          mbar_wait(&empty[st], ((it / S) & 1) ^ 1);\n"),
    ("        }\n      }\n    } else if (MODE == kDW && tid >= 32) {",
     "        }\n        if (!dh_issued) issue_dh();\n      }\n"
     "    } else if (MODE == kDW && tid >= 32) {"),
    ("    int it = 0, ob = 0;\n", "    int it = 0, ob = 0, ctile = 0;\n"),
    ("      [[maybe_unused]] uint32_t dhv[MODE == kGB ? BN / 4 : 1];\n"
     "      if constexpr (MODE == kGB) {\n",
     "      [[maybe_unused]] uint32_t dhv[MODE == kGB ? BN / 4 : 1];\n"
     "      if constexpr (false) {\n"),
    ("      if constexpr (MODE == kGB) {\n"
     "        // (g, u, dh) -> (dg, du) in place",
     "      if constexpr (MODE == kGB) {\n"
     "        if (occ) {\n"
     "          mbar_wait(dh_full, ctile & 1);\n"
     "#pragma unroll\n"
     "          for (int j = 0; j < BN / 8; ++j)\n"
     "#pragma unroll\n"
     "            for (int h = 0; h < 2; ++h) {\n"
     "              const int rr = rl + 8 * h, cb = ((j % 8) * 8 + c2) * 2;\n"
     "              dhv[2 * j + h] = keep[h] ? *reinterpret_cast<const "
     "uint32_t*>(\n"
     "                  sDh + (cw * 2 + j / 8) * kSlab + rr * 128 +\n"
     "                  (((cb / 16) ^ (rr % 8)) * 16) + cb % 16) : 0u;\n"
     "            }\n"
     "          __syncwarp();\n"
     "          if (lane == 0) mbar_arrive(dh_empty);\n"
     "          ++ctile;\n"
     "        }\n"
     "      }\n"
     "      if constexpr (MODE == kGB) {\n"
     "        // (g, u, dh) -> (dg, du) in place"),
)


def edited(edits) -> str:
    """`csrc/moe_gmm_bwd.cu` with each (anchor, replacement) of `edits`
    applied in turn; each anchor must occur once."""
    src = (build.CSRC / "moe_gmm_bwd.cu").read_text()
    for anchor, text in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    return src


def probe_source() -> str:
    src = edited((anchor, anchor + text) for anchor, text in EDITS)
    # mode 1 releases each stage in the loop, so not again after it
    tail = ("        wgmma_wait<0>();\n#pragma unroll\n"
            "        for (int b = 0; b < NB; ++b) fence_regs(acc[b]);\n"
            "        release((it - 1) % S);\n")
    if src.count(tail) != 1:
        raise RuntimeError("the consumers' tile end not found once")
    src = src.replace(tail, "        if (p.probe != 1) {\n" + tail +
                      "        }\n")
    env = ('  p.probe = getenv("MOE_BWD_PROBE") ? '
           'atoi(getenv("MOE_BWD_PROBE")) : 0;\n')
    src, n = re.subn(r"(  p\.nseg = [^\n]*;\n)", lambda m: m.group(1) + env,
                     src)
    if n != 3:
        raise RuntimeError(f"{n} launch set-ups found, expected 3")
    return src


def nvcc(src: Path, out: Path, verbose: bool) -> str:
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
           *(["-Xptxas", "-v"] if verbose else []), "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    return res.stdout + res.stderr


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, n_ptr in (("moe_gmm_bwd_dx", 6), ("moe_gmm_bwd_dw", 6),
                        ("moe_gmm_gated_bwd", 7)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def uniform_calls(dev):
    """dx (dh, dxe), dw (dwd, dwg + dwu) and the gated backward (dg, du)
    at one layer's buffers with every assignment kept: 273 or 274 rows a
    group, inputs from a seed, zero past `rows`."""
    E, G, Cg, d, f, n = 60, 4, 344, 2048, 1408, 16384 * 4
    C = G * Cg
    counts = torch.full((E * G,), n // (E * G), dtype=torch.int32)
    counts[:n % (E * G)] += 1
    rows = counts.view(E, G).to(dev)
    live = (torch.arange(C, device=dev) % Cg)[None, :] < \
        rows.repeat_interleave(Cg, dim=1)
    gen = torch.Generator(device=dev).manual_seed(33)

    def draw(*shape, scale=1.0, masked=True):
        t = torch.randn(shape, generator=gen, device=dev) * scale
        return (t * live[..., None] if masked else t).to(torch.bfloat16)
    x, h, dog = draw(E, C, d), draw(E, C, f), draw(E, C, d)
    dh, dg, du = draw(E, C, f), draw(E, C, f), draw(E, C, f)
    wg, wu = (draw(E, d, f, scale=d ** -0.5, masked=False) for _ in range(2))
    wd = draw(E, f, d, scale=f ** -0.5, masked=False)
    return rows, [
        ("dh", "moe_gmm_bwd_dx", (dog, wd),
         lambda: [torch.bmm(dog, wd.mT)]),
        ("dxe", "moe_gmm_bwd_dx", (dg, wg, du, wu),
         lambda: [torch.bmm(dg, wg.mT), torch.bmm(du, wu.mT)]),
        ("dwd", "moe_gmm_bwd_dw", (h, dog), lambda: [torch.bmm(h.mT, dog)]),
        ("dwg + dwu", "moe_gmm_bwd_dw", (x, dg, du),
         lambda: [torch.bmm(x.mT, dg), torch.bmm(x.mT, du)]),
        ("dg + du", "moe_gmm_gated_bwd", (x, wg, wu, dh),
         lambda: [torch.bmm(x, wg), torch.bmm(x, wu)])]


def cuda_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--dh-tma", action="store_true",
                    help="also time the gated backward with dh by TMA")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("moe_bwd_probe: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    OUT.mkdir(parents=True, exist_ok=True)
    log = nvcc(build.CSRC / "moe_gmm_bwd.cu", OUT / "moe_gmm_bwd_asis.so",
               verbose=True)
    asis = load(OUT / "moe_gmm_bwd_asis.so")
    warnings = [ln for ln in log.splitlines() if "C7518" in ln
                or "C7520" in ln]
    spills, fn = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        fn = m.group(1) if m else fn
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and (int(m.group(1)) or int(m.group(2))):
            spills.append(f"{fn}: {ln.strip()}")
    src, so = OUT / "moe_gmm_bwd_probe.cu", OUT / "moe_gmm_bwd_probe.so"
    src.write_text(probe_source())
    nvcc(src, so, verbose=False)
    lib = load(so)
    src, so = OUT / "moe_gmm_bwd_approx.cu", OUT / "moe_gmm_bwd_approx.so"
    src.write_text(edited(APPROX))
    nvcc(src, so, verbose=False)
    approx = load(so)
    if args.dh_tma:
        src, so = OUT / "moe_gmm_bwd_dh_tma.cu", OUT / "moe_gmm_bwd_dh_tma.so"
        src.write_text(edited(DH_TMA))
        dh_log = nvcc(src, so, verbose=True)
        dh_tma = load(so)
        print(json.dumps({"dh_tma_ptxas": [
            ln.strip() for ln in dh_log.splitlines()
            if "C7518" in ln or "C7520" in ln or (
                "bytes spill" in ln and "0 bytes spill stores, 0 bytes" not in ln)]}),
            flush=True)
    print(json.dumps({"card": card.strip(), "ptxas_wgmma_serialised":
                      len(warnings), "warnings": warnings,
                      "spills": spills}), flush=True)
    kernel._bwd_lib = lambda: lib
    rows, calls = uniform_calls("cuda")
    for r in range(args.rounds):
        for label, name, ts, bmm in calls:
            ms = {}
            for mode in ("whole", "no math", "no loads", "no epilogue",
                         "whole"):
                os.environ["MOE_BWD_PROBE"] = MODES[mode]
                key = mode if mode not in ms else f"{mode}, again"
                ms[key] = cuda_ms(lambda: kernel._launch_bwd(
                    "tensor_core", name, *ts, rows=rows))
            os.environ["MOE_BWD_PROBE"] = "0"
            if name == "moe_gmm_gated_bwd":
                kernel._bwd_lib = lambda: approx
                ms["whole, approximate element math"] = cuda_ms(
                    lambda: kernel._launch_bwd("tensor_core", name, *ts,
                                               rows=rows))
                kernel._bwd_lib = lambda: lib
                ms["whole, again 2"] = cuda_ms(lambda: kernel._launch_bwd(
                    "tensor_core", name, *ts, rows=rows))
            if name == "moe_gmm_gated_bwd" and args.dh_tma:
                def run(lib_):
                    kernel._bwd_lib = lambda: lib_
                    return kernel._launch_bwd("tensor_core", name, *ts,
                                              rows=rows)
                same = all(torch.equal(x, y) for x, y in zip(run(asis),
                                                              run(dh_tma)))
                for key, lib_ in (("as is", asis), ("dh by TMA", dh_tma),
                                  ("as is, again", asis),
                                  ("dh by TMA, again", dh_tma)):
                    ms[f"whole, {key}"] = cuda_ms(lambda: run(lib_))
                ms["dh by TMA bit-identical"] = same
                kernel._bwd_lib = lambda: lib
            ms["torch.bmm"] = cuda_ms(bmm)
            print(json.dumps({"round": r, "launch": label, "ms": ms}),
                  flush=True)


if __name__ == "__main__":
    main()
