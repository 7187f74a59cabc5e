#!/usr/bin/env python3
"""Where the time of the MoE backward's tensor-core route goes (card only):

    PYTHONPATH=src python3 tools/moe_bwd_probe.py [--rounds 2]

Builds `csrc/moe_gmm_bwd.cu` as it is with `-Xptxas -v` and reports
ptxas's wgmma serialisation warnings (C7518 / C7520) for it, then builds
a copy with a switch read at each launch (`MOE_BWD_PROBE`) that leaves
one part of `tc::bwd_tc_kernel` out: 1, the consumers' wgmma (each stage
is waited for and released: the load stream alone); 2, the producer's TMA
loads (each stage is marked full at once: the math and the epilogue on
whatever the ring holds); 3, the epilogue (nothing is written). It times
dx and dw at one qwen2-moe-a2.7b layer's training buffers with every one
of the step's 65,536 assignments kept (`chip_smoke.py` phase 14's
uniform point: E 60, 4 groups of 344, d 2048, f 1408) in each mode, in
turns (whole, 1, 2, 3, whole), beside `torch.bmm` of the same products,
and prints one JSON line a launch and round. Only times: the outputs of
modes 1-3 are garbage.
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


def probe_source() -> str:
    src = (build.CSRC / "moe_gmm_bwd.cu").read_text()
    for anchor, text in EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + text)
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
    if n != 2:
        raise RuntimeError(f"{n} launch set-ups found, expected 2")
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
    """dx (dh, dxe) and dw (dwd, dwg + dwu) at one layer's buffers with
    every assignment kept: 273 or 274 rows a group, inputs from a seed,
    zero past `rows`."""
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
    dg, du = draw(E, C, f), draw(E, C, f)
    wg, wu = (draw(E, d, f, scale=d ** -0.5, masked=False) for _ in range(2))
    wd = draw(E, f, d, scale=f ** -0.5, masked=False)
    return rows, [
        ("dh", "moe_gmm_bwd_dx", (dog, wd),
         lambda: [torch.bmm(dog, wd.mT)]),
        ("dxe", "moe_gmm_bwd_dx", (dg, wg, du, wu),
         lambda: [torch.bmm(dg, wg.mT), torch.bmm(du, wu.mT)]),
        ("dwd", "moe_gmm_bwd_dw", (h, dog), lambda: [torch.bmm(h.mT, dog)]),
        ("dwg + dwu", "moe_gmm_bwd_dw", (x, dg, du),
         lambda: [torch.bmm(x.mT, dg), torch.bmm(x.mT, du)])]


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("moe_bwd_probe: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    OUT.mkdir(parents=True, exist_ok=True)
    log = nvcc(build.CSRC / "moe_gmm_bwd.cu", OUT / "moe_gmm_bwd_asis.so",
               verbose=True)
    warnings = [ln for ln in log.splitlines() if "C7518" in ln
                or "C7520" in ln]
    src, so = OUT / "moe_gmm_bwd_probe.cu", OUT / "moe_gmm_bwd_probe.so"
    src.write_text(probe_source())
    nvcc(src, so, verbose=False)
    lib = load(so)
    print(json.dumps({"card": card.strip(), "ptxas_wgmma_serialised":
                      len(warnings), "warnings": warnings}), flush=True)
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
            ms["torch.bmm"] = cuda_ms(bmm)
            print(json.dumps({"round": r, "launch": label, "ms": ms}),
                  flush=True)


if __name__ == "__main__":
    main()
