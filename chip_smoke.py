#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py            # from the repository root

It drives the port's main path — COMM-RAND GraphSAGE training through
`GNNTrainer` — at the paper's full model width on a Reddit-shaped graph,
and holds every hand-written kernel of that path against its plain PyTorch
version on the card. Phases (any failure fails the run, exit code != 0):

  1. device   torch / CUDA versions, the card, its power limit; TF32 off
  2. build    nvcc builds the kernels from `src/repro_torch/csrc` (timed)
  3. kernels  each kernel at the main path's shapes, taken from a real
              batch: max error against the plain version, bit-determinism
              of bwd_dx, and ms (CUDA events around 10 back-to-back calls,
              median of 5) beside the plain
              version, one equivalent PyTorch call where there is one, and
              the bound (compulsory bytes at 3.35 TB/s, flops at 67
              TFLOP/s float32)
  4. train    20 `train_steps` + one `evaluate` of 3 validation batches on
              the reddit-602 graph; the kernels' launch counters are zeroed
              just before and read just after, and must equal 3 per step +
              3 per eval batch (forward) and 2 per step (backward dx)
  5. card vs CPU  5 guarded steps on the tiny graph, same parameters and
              batches on the card and on the CPU, agree within rtol 1e-4

It prints the `{"kernels": [...]}` line before the last, and as the last
line `{"ok": true, "device": {...}}`. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
STEPS, EVAL_BATCHES, CPU_STEPS = 20, 3, 5
DEVICE = "cuda"
REPLACES = {
    "gather_agg_fwd": "src/repro/kernels/gather_agg/kernel.py:56",
    "gather_agg_bwd_dx": "src/repro/kernels/gather_agg/kernel.py:101",
}
SOURCE = "src/repro_torch/csrc/gather_agg.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def reddit_spec():
    """Reddit's node count, feature width and class count; the average
    degree is cut from about 492 to 50 to bound host set-up time."""
    from repro_torch.graphs.synthetic import SBMSpec
    return SBMSpec("reddit-602", 232_965, 50, 50.0, 0.9, 602, 41,
                   train_frac=0.66, val_frac=0.10, seed=1)


# ---------------------------------------------------------------------------
# phase 1 / 2
# ---------------------------------------------------------------------------
def phase_device(torch) -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"[1 device] python {sys.version.split()[0]}  torch "
        f"{torch.__version__}  cuda {torch.version.cuda}  card {name}  "
        f"count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    return name


def phase_build() -> float:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    dt = time.perf_counter() - t0
    log(f"[2 build] nvcc {build.NVCC_FLAGS[1]}: {dt:.2f} s")
    return dt


# ---------------------------------------------------------------------------
# phase 3: the kernels at the main path's shapes
# ---------------------------------------------------------------------------
def cuda_ms(torch, fn, reps: int = 10, rounds: int = 5,
            warmup: int = 3) -> float:
    """Device time per call: CUDA events around `reps` back-to-back calls,
    the median over `rounds`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def typical_batch(trainer):
    """The batch of median footprint among five spread over epoch 0: the
    caps fit the largest batches, and a comm_rand batch's real node count
    varies with the communities its roots come from."""
    stream = trainer.stream
    roots = stream.root_batches(0)
    cands = []
    for pos in sorted({round(k * (len(roots) - 1) / 4) for k in range(5)}):
        b = stream.build(roots[pos], 0, pos)
        cands.append((int(b.num_unique), pos, b))
    cands.sort(key=lambda c: c[0])
    n, pos, batch = cands[len(cands) // 2]
    log(f"[3 kernels] input-level nodes of batches "
        f"{[(c[1], c[0]) for c in sorted(cands, key=lambda c: c[1])]} "
        f"(cap {stream.caps[-1]}); timing batch {pos} ({n} nodes)")
    return batch


def main_path_layers(torch, trainer, batch):
    """The (x, idx, w) each SAGE layer hands `gather_agg` in a train step,
    from a real batch: layer 0 gathers from the global feature matrix
    through composed ids; layers 1 and 2 from hidden activations (random
    values of the real width, from a seeded generator)."""
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    layers = []
    x = trainer.feats
    for i, block in enumerate(batch.blocks):
        if i == 0:
            gid = torch.clamp(batch.node_ids, max=x.shape[0] - 1)
            idx = gid[block.src_pos]
        else:
            x = torch.randn((batch.blocks[i - 1].src_pos.shape[0],
                             trainer.cfg.hidden_dim), generator=gen,
                            device=trainer.device)
            idx = block.src_pos
        m = block.edge_mask.to(torch.float32)
        w = m / torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
        idx = torch.clamp(idx.to(torch.int32), 0, x.shape[0] - 1)
        g = torch.randn((idx.shape[0], x.shape[1]), generator=gen,
                        device=trainer.device)
        layers.append({"layer": i, "x": x, "idx": idx.contiguous(),
                       "w": w.contiguous(), "g": g, "needs_dx": i > 0})
    return layers


def _bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase_kernels(torch, layers):
    import torch.nn.functional as Fn

    from repro_torch.kernels.gather_agg import kernel, ref
    fwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "bound_by": set(), "deterministic": True}
    bwd = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
           "bound_by": set(), "deterministic": True}
    for L in layers:
        x, idx, w, g = L["x"], L["idx"], L["w"], L["g"]
        n_dst, r = idx.shape
        F = x.shape[1]
        n_src = x.shape[0]
        # forward: kernel vs plain; sums in another order -> 1e-5
        out = kernel.gather_agg_fwd(x, idx, w)
        want = ref.gather_agg_ref(x, idx, w)
        err = (out - want).abs().max().item()
        check(torch.isfinite(out).all().item(), f"fwd layer {L['layer']}")
        check(torch.allclose(out, want, rtol=1e-5, atol=1e-5),
              f"fwd layer {L['layer']} max abs err {err}")
        same = torch.equal(out, kernel.gather_agg_fwd(x, idx, w))
        check(same, f"fwd layer {L['layer']} differs between launches")
        idx64 = idx.long()
        lib = Fn.embedding_bag(idx64, x, per_sample_weights=w, mode="sum")
        lib_err = (lib - want).abs().max().item()
        rows = torch.unique(idx).numel()
        b_ms, b_by = _bound_ms(rows * F * 4 + idx.numel() * 8 +
                               n_dst * F * 4, 2.0 * n_dst * r * F)
        t_k = cuda_ms(torch, lambda: kernel.gather_agg_fwd(x, idx, w))
        t_p = cuda_ms(torch, lambda: ref.gather_agg_ref(x, idx, w))
        t_l = cuda_ms(torch, lambda: Fn.embedding_bag(
            idx64, x, per_sample_weights=w, mode="sum"))
        log(f"[3 kernels] gather_agg_fwd layer {L['layer']}: x {n_src}x{F} "
            f"idx {n_dst}x{r} rows read {rows}  max_abs_err {err:.3e}  "
            f"bit-identical relaunch {same}  "
            f"ms {t_k:.4f}  plain_ms {t_p:.4f}  library_ms {t_l:.4f} "
            f"(embedding_bag err {lib_err:.3e})  bound_ms {b_ms:.4f} "
            f"({b_by})")
        fwd["ms"] += t_k
        fwd["plain_ms"] += t_p
        fwd["library_ms"] += t_l
        fwd["bound_ms"] += b_ms
        fwd["bound_by"].add(b_by)
        fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
        if not L["needs_dx"]:
            continue
        # backward dx: kernel vs plain (index_add_, atomics in another
        # order). A dx row sums one product per weighted edge into it, so
        # the float32 rounding grows with the most such edges on one row.
        dx = kernel.gather_agg_bwd_dx(idx, w, g, n_src)
        dx_want = ref.gather_agg_bwd_dx_ref(idx, w, g, n_src)
        err = (dx - dx_want).abs().max().item()
        terms = int(torch.bincount(idx[w != 0].long()).max())
        tol = max(1e-5, 1e-7 * terms)
        check(torch.allclose(dx, dx_want, rtol=tol, atol=tol),
              f"bwd_dx layer {L['layer']} max abs err {err} (tol {tol})")
        same = torch.equal(dx, kernel.gather_agg_bwd_dx(idx, w, g, n_src))
        check(same, f"bwd_dx layer {L['layer']} differs between launches")
        b_ms, b_by = _bound_ms(n_dst * F * 4 + idx.numel() * 8 +
                               n_src * F * 4, 2.0 * n_dst * r * F)
        t_k = cuda_ms(torch, lambda: kernel.gather_agg_bwd_dx(idx, w, g,
                                                              n_src))
        t_p = cuda_ms(torch, lambda: ref.gather_agg_bwd_dx_ref(idx, w, g,
                                                               n_src))
        log(f"[3 kernels] gather_agg_bwd_dx layer {L['layer']}: dx "
            f"{n_src}x{F} edges {n_dst}x{r} (at most {terms} on a row)  "
            f"max_abs_err {err:.3e} (tol {tol:.1e})  "
            f"bit-identical relaunch {same}  ms {t_k:.4f} (sort glue "
            f"included)  plain_ms {t_p:.4f}  library_ms null (no single "
            f"PyTorch call computes it)  bound_ms {b_ms:.4f} ({b_by})")
        bwd["ms"] += t_k
        bwd["plain_ms"] += t_p
        bwd["bound_ms"] += b_ms
        bwd["bound_by"].add(b_by)
        bwd["max_abs_err"] = max(bwd["max_abs_err"], err)
    return fwd, bwd


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def phase_train(torch, graph, trainer):
    from repro_torch.kernels.gather_agg import kernel
    bs = trainer.tcfg.batch_size
    val = graph.val_ids[:EVAL_BATCHES * bs]
    n_eval = -(-len(val) // bs)
    # the batch build alone (pure in the cursor, so it disturbs nothing)
    build_ms = []
    for pos in range(1, 6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.stream.build(trainer.stream.root_batches(0)[pos], 0, pos)
        torch.cuda.synchronize()
        build_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[4 train] batch build alone: median "
        f"{statistics.median(build_ms):.2f} ms over 5 batches")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launches()                      # counts start here
    losses, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses += trainer.train_steps(1)         # ends in one loss read
        step_ms.append((time.perf_counter() - t0) * 1e3)
    ev = trainer.evaluate(val)
    torch.cuda.synchronize()
    launches = dict(kernel.LAUNCHES)             # ... and are read here
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[4 train] {STEPS} steps: first loss {losses[0]:.4f}  last loss "
        f"{losses[-1]:.4f}  median step {statistics.median(step_ms):.2f} ms "
        f"(first {step_ms[0]:.2f} ms)  eval {n_eval} batches: loss "
        f"{ev['loss']:.4f} acc {ev['acc']:.4f}  peak memory {peak:.2f} GiB"
        f"  skipped steps {int(trainer.skips)}  launches {launches}")
    check(all(map(math.isfinite, losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "loss did not fall over the steps")
    check(math.isfinite(ev["loss"]), "non-finite eval loss")
    want = {"gather_agg_fwd": 3 * STEPS + 3 * n_eval,
            "gather_agg_bwd_dx": 2 * STEPS}
    check(launches == want, f"launches {launches} != {want}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: card vs CPU on the tiny graph
# ---------------------------------------------------------------------------
def phase_card_vs_cpu(torch):
    from repro_torch.configs import GNNConfig, TrainConfig
    from repro_torch.core.reorder import prepare
    from repro_torch.graphs import synthetic
    from repro_torch.train.gnn_loop import GNNTrainer
    g = prepare(synthetic.load("tiny"), oracle=True)
    cfg = GNNConfig("tiny", "sage", 2, 32, g.feat_dim, g.num_classes,
                    fanout=(5, 5), dropout=0.0)
    tcfg = TrainConfig(batch_size=256)
    cpu = GNNTrainer(g, cfg, tcfg, "comm_rand", seed=0, device="cpu")
    gpu = GNNTrainer(g, cfg, tcfg, "comm_rand", seed=0, caps=cpu.caps,
                     eval_caps=cpu.eval_caps, device=DEVICE)
    for a, b in zip(cpu.params.parameters(), gpu.params.parameters()):
        check(torch.equal(a, b.cpu()), "card and CPU start from other params")
    # the stream's generators are the device's own, so both steps take the
    # CPU stream's batches
    it = iter(cpu.stream)
    worst = 0.0
    for _ in range(CPU_STEPS):
        b = next(it)
        lc, _ = cpu.train_step(b, tcfg.learning_rate)
        lg, _ = gpu.train_step(b.to(DEVICE), tcfg.learning_rate)
        lc, lg = float(lc), float(lg)
        worst = max(worst, abs(lg - lc) / abs(lc))
        check(abs(lg - lc) <= 1e-4 * abs(lc), f"card {lg} vs CPU {lc}")
    log(f"[5 card vs cpu] {CPU_STEPS} steps on tiny: max relative loss "
        f"difference {worst:.3e} (limit 1e-4)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    kind = phase_device(torch)
    phase_build()

    from repro_torch.batching import make_policy
    from repro_torch.configs import CONFIG, TrainConfig
    from repro_torch.core.reorder import prepare
    from repro_torch.graphs.synthetic import generate
    from repro_torch.train.gnn_loop import GNNTrainer
    t0 = time.perf_counter()
    graph = prepare(generate(reddit_spec()), oracle=True)
    t1 = time.perf_counter()
    trainer = GNNTrainer(graph, CONFIG, TrainConfig(),
                         make_policy("comm_rand", mix=0.125, p=1.0), seed=0,
                         device=DEVICE)
    log(f"[setup] {graph.name}: {graph.num_nodes} nodes, {graph.num_edges} "
        f"edges, feats {graph.features.shape}  generate+prepare "
        f"{t1 - t0:.1f} s  trainer (caps, upload) "
        f"{time.perf_counter() - t1:.1f} s  caps {trainer.caps}  eval caps "
        f"{trainer.eval_caps}")

    fwd, bwd = phase_kernels(torch, main_path_layers(
        torch, trainer, typical_batch(trainer)))
    launches = phase_train(torch, graph, trainer)
    phase_card_vs_cpu(torch)

    kernels = []
    for name, res, lib in (("gather_agg_fwd", fwd, fwd["library_ms"]),
                           ("gather_agg_bwd_dx", bwd, None)):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "ok": True, "deterministic": res["deterministic"],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": "/".join(sorted(res["bound_by"])),
            "library_ms": lib,
            "shapes": "sum over the layers of one train step"})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
