"""Batched LM serving (`repro/launch/serve.py`): prefill a request batch,
then decode greedily (or by sampling) against a bfloat16 KV cache (an
RWKV model: its recurrent state, float32, and bf16 token shifts), with
prefill and per-step decode timings and the cache's size.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --device cpu                        # reduced widths, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --no-reduced --batch 4 --prompt-len 2048 --tokens 32   # the card
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen2-moe-a2.7b --no-reduced --batch 4 --prompt-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --no-reduced --batch 4 --prompt-len 2048 --tokens 32

The prefill's attention runs the hand-written flash-attention kernel on
the card (`repro_torch.kernels.flash_attention`), an MoE model's expert
matmuls the hand-written grouped matmul (`kernels.moe_gmm`), in the
prefill and in every decode step, and an RWKV model's prefill the
hand-written WKV6 chunk kernel (`kernels.rwkv6_chunk`; its decode step
runs the recurrence in plain PyTorch, as the reference does). Unlike
the reference's CLI, whose `--reduced` cannot be switched off,
`--no-reduced` serves the config at full width. Parameters are random,
drawn from `--seed` by a generator on the serving device, directly in
the compute dtype (qwen2-moe-a2.7b's float32 tree, 57 GB, would not fit
beside its cast).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs import LM_CONFIGS, ModelConfig
from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models.lm import transformer
from repro_torch.train.train_step import make_decode_step, make_prefill_step


@dataclass
class Generation:
    ids: torch.Tensor            # (B, n_new + 1): prefill's token, then
    #                              one per decode step
    prefill_ms: float
    decode_ms_per_step: float
    cache_bytes: int


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _next_token(logits, temperature, generator):
    """(B, V) logits -> (B, 1) ids: argmax, or a draw at `temperature`."""
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return torch.argmax(logits, dim=-1, keepdim=True)


def generate(cfg: ModelConfig, params, tokens, n_new: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Generation:
    """Prefill `tokens` (B, P), copy the prefill cache into a bfloat16
    cache of length P + n_new (`transformer.fill_cache`; an RWKV state
    stays float32), then take n_new decode steps.

    Runs on `device` (the card unless given): the parameters are cast to
    the compute dtype there once (`transformer.cast_params`, no copy if
    they already are). The first token is always the argmax of the
    prefill's last logits, as in the reference; at `temperature > 0` each
    decode step then samples from `generator` (on `device`), otherwise it
    takes the first maximal logit. Prefill ms
    and decode ms per step are host clock around work that ends in a
    device synchronise."""
    dev = resolve_device(device)
    params = transformer.cast_params(cfg, params, dev)
    tokens = torch.as_tensor(tokens).to(dev, torch.int64)
    B, P = tokens.shape
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, pcache = prefill(params, {"tokens": tokens})
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3

    cache = transformer.fill_cache(cfg, transformer.init_cache(
        cfg, B, P + n_new, torch.bfloat16, dev), pcache)
    del pcache
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())

    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
    out = [tok]
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(n_new):
        logits, cache = decode(params, cache, tok, P + t)
        tok = _next_token(logits[:, -1], temperature, generator)
        out.append(tok)
    _sync(dev)
    decode_ms = (time.perf_counter() - t0) * 1e3
    return Generation(torch.cat(out, dim=1), prefill_ms,
                      decode_ms / max(n_new, 1), cache_bytes)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=list(LM_CONFIGS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = LM_CONFIGS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    total = args.prompt_len + args.tokens
    params = transformer.init(
        cfg, torch.Generator(device=dev).manual_seed(args.seed),
        max_seq=max(total, 64), device=dev, dtype=getattr(torch, cfg.dtype))
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(1))
    gen = None
    if args.temperature > 0:
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    res = generate(cfg, params, tokens, args.tokens,
                   temperature=args.temperature, generator=gen, device=dev)

    pf_s = res.prefill_ms / 1e3
    print(f"prefill: {args.batch} x {args.prompt_len} tok in "
          f"{res.prefill_ms:.1f} ms "
          f"({args.batch * args.prompt_len / pf_s:.0f} tok/s)")
    print(f"cache: {res.cache_bytes / 2**20:.1f} MiB "
          f"({'state' if cfg.rwkv else 'KV'})")
    dt = res.decode_ms_per_step * args.tokens / 1e3
    print(f"decode: {args.tokens} steps x {args.batch} seqs in "
          f"{dt * 1e3:.1f} ms ({args.tokens * args.batch / max(dt, 1e-9):.0f}"
          f" tok/s, {res.decode_ms_per_step:.2f} ms/step)")
    print("greedy ids, seq 0:", res.ids[0].tolist())


if __name__ == "__main__":
    main()
