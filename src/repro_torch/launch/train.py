"""Training launcher (`repro/launch/train.py`): `--arch` selects a GNN
model (the paper's pipeline) or a dense LM.

    PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage \\
        --dataset tiny --device cpu --epochs 2 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage \\
        --dataset reddit-like --cache dynamic --ckpt-dir /tmp/ck  # the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --reduced --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen2-moe-a2.7b --layers 2 --batch 4 --seq 4096  # the card

LM archs (`train_lm`, the reference's `launch/train.py:22-47`) run the
fault-tolerant `LMTrainer` on synthetic Zipf tokens (checkpoint / resume
with `--ckpt-dir`, straggler monitor, optional int8 gradient compression);
`--reduced` trains the smoke-scale variant, and without it the full-width
config; `--layers` cuts its depth (qwen2-moe-a2.7b's 24 layers do not fit
one card in training; 2 do). Dense and MoE LMs train: rwkv6-7b raises,
since its kernel's backward belongs to a later slice; `--mesh` takes only
`none` (sharded training is the distributed slice's).

The GNN branch is `repro/launch/train.py:50-72` with the checkpoint,
caps-cache and feature-cache flags that `examples/train_gnn_commrand.py`
gives its trainer.
`--arch graphsage|gcn|gat` trains that model at its full width
(`repro_torch.configs.CONFIGS`: 3 layers, hidden 256, fanout 10 per hop;
`--hidden` and `--layers` narrow it) on a synthetic graph through
`GNNTrainer.fit`. With `--ckpt-dir`, the trainer checkpoints every
`--ckpt-every` steps and at the end of `fit`; a second run on the same
directory resumes from the newest valid checkpoint and prints `resumed at
step N (cursor: ...)`. `--caps-cache` memoizes the calibrated caps in a
JSON file (the reference's format). `--cache` routes layer-0 feature
reads through the device-resident cache: a static admission, or
`dynamic[:admission]` for CLOCK re-admission at every epoch boundary.
The run is on the CUDA device unless `--device` says otherwise.
"""
from __future__ import annotations

import argparse
from dataclasses import replace

from repro_torch.batching import CapsCalibrator, make_policy
from repro_torch.configs import CONFIGS, LM_CONFIGS, TrainConfig
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic

CACHES = ("degree_hot", "community_freq", "presampled_freq", "dynamic",
          "dynamic:degree_hot", "dynamic:community_freq",
          "dynamic:presampled_freq")


def train_lm(args) -> None:
    from repro_torch.data.pipeline import (BlockShuffler, LMStream,
                                           SyntheticTokens)
    from repro_torch.models.lm.transformer import check_trainable
    from repro_torch.train.lm_loop import LMTrainer

    cfg = LM_CONFIGS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cfg.scaled(num_layers=args.layers)
    check_trainable(cfg)
    tcfg = TrainConfig(learning_rate=args.lr, remat=not args.reduced,
                       grad_compression=args.compress_grads,
                       microbatches=args.microbatches)
    corpus = SyntheticTokens(cfg.vocab_size, num_docs=4096,
                             doc_len=args.seq * 2)
    stream = LMStream(corpus, args.batch, args.seq,
                      BlockShuffler(corpus.num_docs, 64,
                                    mode=args.shuffle_mode))
    tr = LMTrainer(cfg, tcfg, stream, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, seed=args.seed,
                   device=args.device)
    if tr.step:
        print(f"resumed from step {tr.step}")
    r = tr.run(args.steps)
    print(f"{args.arch}: steps={args.steps} loss {r['loss_first']:.4f} -> "
          f"{r['loss_last']:.4f} stragglers={r['straggler_fraction']:.1%} "
          f"device: {tr.device}")


def train_gnn(args) -> None:
    from repro_torch.train.gnn_loop import GNNTrainer

    g = prepare(synthetic.load(args.dataset), oracle=args.oracle)
    base = CONFIGS[args.arch]
    layers = args.layers or base.num_layers
    cfg = replace(base, name=f"{args.arch}-{args.dataset}",
                  num_layers=layers,
                  hidden_dim=args.hidden or base.hidden_dim,
                  in_dim=g.feat_dim, num_classes=g.num_classes,
                  fanout=tuple(base.fanout[:1]) * layers)
    pol = make_policy(args.policy, mix=args.mix, p=args.p)
    tcfg = TrainConfig(batch_size=args.batch, max_epochs=args.epochs,
                       learning_rate=args.lr)
    print(f"{cfg.model} on {g.name}: {g.num_nodes} nodes, "
          f"{g.communities.max() + 1} communities, policy "
          f"{pol.describe()}")
    tr = GNNTrainer(g, cfg, tcfg, pol, seed=args.seed,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    calibrator=CapsCalibrator(cache_path=args.caps_cache,
                                              seed=args.seed),
                    cache=args.cache, cache_frac=args.cache_frac,
                    device=args.device)
    print(f"calibrated caps: {tr.caps}  device: {tr.device}")
    if tr.cache is not None:
        print(f"feature cache: {tr.cache.describe()}")
    if tr.global_step:
        print(f"resumed at step {tr.global_step} "
              f"(cursor: {tr.stream.cursor.state()})")
    res = tr.fit(verbose=True)
    print(f"val={res.val_acc:.4f} test={res.test_acc:.4f} "
          f"epochs={res.epochs_to_converge} "
          f"per_epoch={res.per_epoch_time_s:.2f}s "
          f"total={res.total_time_s:.1f}s"
          + (f" cache_hit={res.cache_hit_rate:.3f} "
             f"refills={res.cache_refills}" if res.cache else ""))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=list(LM_CONFIGS) + list(CONFIGS))
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default: 8 sequences for an LM, 1024 "
                         "roots for a GNN)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="reddit-like",
                    choices=sorted(synthetic.DATASETS))
    ap.add_argument("--policy", default="comm_rand",
                    choices=["rand", "norand", "comm_rand"])
    ap.add_argument("--mix", type=float, default=0.125)
    ap.add_argument("--p", type=float, default=1.0)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--oracle", action="store_true",
                    help="use planted communities instead of Louvain")
    ap.add_argument("--hidden", type=int, default=None,
                    help="hidden width (default: the config's)")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers (default: the config's; for an LM, its "
                         "depth cut to this many)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint + resume (cursor travels with weights)")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (with --ckpt-dir)")
    ap.add_argument("--caps-cache", default=None,
                    help="JSON file memoizing calibrated caps across runs")
    ap.add_argument("--cache", default=None, choices=CACHES,
                    help="device-resident feature cache: a static "
                         "admission, or 'dynamic[:admission]' for CLOCK "
                         "re-admission at every epoch boundary")
    ap.add_argument("--cache-frac", type=float, default=0.2,
                    help="cache capacity as a fraction of N (with --cache)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "device; without a card, pass cpu)")
    # LM
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-scale variant of the LM config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--shuffle-mode", default="block",
                    choices=["rand", "block", "none"])
    ap.add_argument("--mesh", default="none", choices=["none"],
                    help="sharded LM training is not ported yet")
    args = ap.parse_args(argv)
    if args.arch in LM_CONFIGS:
        args.batch = args.batch or 8
        train_lm(args)
    else:
        args.batch = args.batch or 1024
        train_gnn(args)


if __name__ == "__main__":
    main()
