"""The port stands alone: importing any `repro_torch` module loads neither
`jax` nor `repro`, and its entry points refuse to guess a device."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.batching import BatchStream
from repro_torch.configs import LM_CONFIGS, GNNConfig, TrainConfig
from repro_torch.core.reorder import prepare
from repro_torch.data.pipeline import LMStream, SyntheticTokens
from repro_torch.graphs import synthetic
from repro_torch.graphs.csr import DeviceGraph
from repro_torch.kernels.clock_refill import kernel as walk_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.gather_agg import kernel
from repro_torch.kernels.moe_gmm import kernel as moe_kernel
from repro_torch.kernels.rwkv6_chunk import kernel as wkv_kernel
from repro_torch.launch import train as train_cli
from repro_torch.launch.serve import generate
from repro_torch.pipeline import AsyncBatchStream, DeviceBatchBuilder
from repro_torch.train.baselines import (induced_subgraph, train_clustergcn,
                                         train_fullbatch)
from repro_torch.train.gnn_loop import GNNTrainer
from repro_torch.train.lm_loop import LMTrainer

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert not bad, bad
assert "triton" not in sys.modules
"""


def test_port_modules_import_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 100         # every slice module was imported


_EACH_FIRST = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    for m in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[m]
    importlib.import_module(n)
print(len(names))
"""


def test_each_port_module_imports_first():
    """No import cycle depends on which module a caller imports first
    (`repro_torch.models.gnn.models` alone once failed on one)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _EACH_FIRST], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 100


# the async pipeline and observability slice's modules
SLICE13 = ["repro_torch.obs", "repro_torch.obs.__main__",
           "repro_torch.obs.metrics", "repro_torch.obs.report",
           "repro_torch.obs.trace", "repro_torch.pipeline",
           "repro_torch.pipeline.builder", "repro_torch.pipeline.device_order",
           "repro_torch.pipeline.prefetch"]

# the prior-work slice's modules
SLICE15 = ["repro_torch.batching.policy", "repro_torch.core.hash32",
           "repro_torch.kernels.gather_mean",
           "repro_torch.kernels.gather_mean.ops",
           "repro_torch.kernels.gather_mean.ref",
           "repro_torch.models.gnn.fullgraph", "repro_torch.sampling.device",
           "repro_torch.train.baselines"]

# the chaos soak and LM training slice's modules
SLICE16 = ["repro_torch.data", "repro_torch.data.pipeline",
           "repro_torch.optim.compression", "repro_torch.resilience.soak",
           "repro_torch.train.lm_loop"]

# the analysis gate's modules
SLICE18 = ["repro_torch.analysis", "repro_torch.analysis.__main__",
           "repro_torch.analysis.config", "repro_torch.analysis.lint",
           "repro_torch.analysis.op_audit", "repro_torch.analysis.rules",
           "repro_torch.analysis.sync_gate"]

_FRESH = r"""
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
assert not bad, bad
"""


@pytest.mark.parametrize("name", SLICE13 + SLICE15 + SLICE16 + SLICE18)
def test_slice_module_imports_first_without_jax(name):
    """Each new module, imported first in a fresh interpreter, loads
    neither jax nor repro (nor triton)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _FRESH, name], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture(scope="module")
def tiny():
    return prepare(synthetic.load("tiny"), oracle=True)


@pytest.mark.parametrize("entry", ["trainer", "stream", "device_graph",
                                   "generate", "train_cli", "async_stream",
                                   "builder", "clustergcn", "fullbatch",
                                   "induced_subgraph", "lm_trainer",
                                   "lm_cli"])
def test_entry_points_raise_without_a_card(tiny, entry, monkeypatch):
    """No card and no explicit device: raise, never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GNNConfig("t", "sage", 2, 32, tiny.feat_dim, tiny.num_classes,
                    fanout=(5, 5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "trainer":
            GNNTrainer(tiny, cfg, TrainConfig(batch_size=256), "comm_rand",
                       caps=(768, 1024), eval_caps=(768, 1024))
        elif entry == "stream":
            BatchStream(tiny, "comm_rand", 256, (5, 5), (768, 1024))
        elif entry == "async_stream":
            AsyncBatchStream(tiny, "comm_rand", 256, (5, 5), (768, 1024))
        elif entry == "builder":
            DeviceBatchBuilder(tiny, "comm_rand", 256, (5, 5), (768, 1024))
        elif entry == "clustergcn":
            train_clustergcn(tiny, cfg, TrainConfig(), epochs=1)
        elif entry == "fullbatch":
            train_fullbatch(tiny, cfg, TrainConfig(), epochs=1)
        elif entry == "induced_subgraph":
            induced_subgraph(tiny, np.arange(10), 16, 64)
        elif entry == "generate":
            generate(LM_CONFIGS["gemma3-1b"].reduced(), {},
                     torch.zeros((1, 4), dtype=torch.long), 1)
        elif entry == "train_cli":
            train_cli.main(["--arch", "graphsage", "--dataset", "tiny",
                            "--epochs", "1"])
        elif entry == "lm_trainer":
            cfg = LM_CONFIGS["gemma3-1b"].reduced()
            LMTrainer(cfg, TrainConfig(), LMStream(
                SyntheticTokens(cfg.vocab_size, num_docs=8, doc_len=16),
                batch=2, seq=8))
        elif entry == "lm_cli":
            train_cli.main(["--arch", "gemma3-1b", "--reduced", "--steps",
                            "1"])
        else:
            DeviceGraph.from_graph(tiny)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    kernel.reset_launches()
    rng = np.random.default_rng((0, 1))
    x = torch.as_tensor(rng.normal(size=(9, 6)), dtype=torch.float32)
    idx = torch.as_tensor(rng.integers(0, 9, (4, 3)), dtype=torch.int32)
    w = torch.as_tensor(rng.random((4, 3)), dtype=torch.float32)
    out = kernel.gather_agg_fwd(x, idx, w)
    dx = kernel.gather_agg_bwd_dx(idx, w, out, 9)
    dw = kernel.gather_agg_bwd_dw(x, idx, out)
    assert out.shape == (4, 6) and dx.shape == (9, 6) and dw.shape == (4, 3)
    assert kernel.LAUNCHES == {"gather_agg_fwd": 0, "gather_agg_bwd_dx": 0,
                               "gather_agg_bwd_dw": 0}


def test_flash_cpu_tensors_take_the_plain_path_and_count_no_launch():
    flash_kernel.reset_launches()
    rng = np.random.default_rng((0, 2))
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 9, n, 16)),
                               dtype=torch.float32) for n in (4, 2, 2))
    out = flash_kernel.flash_attention_fwd(q, k, v, window=4,
                                           is_global=False)
    assert out.shape == q.shape
    assert flash_kernel.LAUNCHES == {"flash_attention_fwd": 0,
                                     "flash_attention_bwd": 0}


def test_wkv6_cpu_tensors_take_the_plain_path_and_count_no_launch():
    wkv_kernel.reset_launches()
    rng = np.random.default_rng((0, 3))
    r, k, v = (torch.as_tensor(rng.normal(size=(1, 5, 2, 16)),
                               dtype=torch.float32) for _ in range(3))
    logw = torch.full((1, 5, 2, 16), -0.5)
    u = torch.zeros((2, 16))
    out, s_f = wkv_kernel.wkv6_fwd(r, k, v, logw, u)
    assert out.shape == r.shape and s_f.shape == (1, 2, 16, 16)
    assert wkv_kernel.LAUNCHES == {"wkv6_fwd": 0}


def test_moe_gmm_cpu_tensors_take_the_plain_path_and_count_no_launch():
    """The grouped matmul's forward and its three backward entry points on
    CPU tensors (through autograd, with `rows`): plain versions, and every
    key of `LAUNCHES` and `ROUTES` stays 0."""
    from repro_torch.kernels.moe_gmm.ops import moe_gmm, moe_gmm_gated
    moe_kernel.reset_launches()
    rng = np.random.default_rng((0, 4))
    x, wg, wu = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
                 .requires_grad_() for s in ((3, 8, 6), (3, 6, 5), (3, 6, 5)))
    wd = torch.as_tensor(rng.normal(size=(3, 5, 6)),
                         dtype=torch.float32).requires_grad_()
    rows = torch.tensor([[0, 2], [4, 4], [1, 3]], dtype=torch.int32)
    h = moe_gmm_gated(x, wg, wu, rows=rows)
    moe_gmm(h, wd, rows=rows).sum().backward()
    assert all(t.grad is not None for t in (x, wg, wu, wd))
    assert moe_kernel.LAUNCHES == {"moe_gmm_fwd": 0, "moe_gmm_bwd_dx": 0,
                                   "moe_gmm_bwd_dw": 0,
                                   "moe_gmm_gated_bwd": 0}
    assert moe_kernel.ROUTES == {"tensor_core": 0, "mma_sync": 0,
                                 "simt": 0}


def test_clock_refill_cpu_tensors_take_the_plain_path_and_count_no_launch():
    walk_kernel.reset_launches()
    i32 = dict(dtype=torch.int32)
    w = walk_kernel.clock_refill(
        torch.tensor([0, 1, -1, -1], **i32), torch.tensor([0, 1], **i32),
        torch.tensor([1, 0], **i32), torch.tensor([0, 0], **i32),
        torch.tensor(0, **i32), torch.tensor([3, 2], **i32),
        torch.tensor([2, 1], **i32))
    # node 3 takes slot 1 once slot 0's bit is stripped, then node 2 slot 0
    assert w.slot_ids.tolist() == [2, 3] and int(w.n_admitted) == 2
    assert w.pos.tolist() == [-1, -1, 0, 1] and int(w.hand) == 1
    assert walk_kernel.LAUNCHES == {"clock_refill": 0}


def test_gather_mean_is_a_shim_with_no_launch_counter_of_its_own():
    """`gather_mean` launches `gather_agg`'s kernels and counts nothing of
    its own; on CPU tensors it takes the plain path and counts no launch."""
    from repro_torch.kernels.gather_mean import ops as mean_ops
    kernel.reset_launches()
    x = torch.ones((5, 3), requires_grad=True)
    idx = torch.tensor([[0, 4], [2, 2]], dtype=torch.int32)
    out = mean_ops.gather_mean(x, idx, torch.tensor([[True, False],
                                                     [True, True]]))
    out.sum().backward()
    assert out.tolist() == [[1.0] * 3] * 2
    assert x.grad[2].tolist() == [1.0] * 3
    assert not hasattr(mean_ops, "LAUNCHES")
    assert kernel.LAUNCHES == {"gather_agg_fwd": 0, "gather_agg_bwd_dx": 0,
                               "gather_agg_bwd_dw": 0}
