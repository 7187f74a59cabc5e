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
from repro_torch.configs import GNNConfig, TrainConfig
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic
from repro_torch.graphs.csr import DeviceGraph
from repro_torch.kernels.gather_agg import kernel
from repro_torch.train.gnn_loop import GNNTrainer

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
    assert n_modules >= 20          # every slice module was imported


@pytest.fixture(scope="module")
def tiny():
    return prepare(synthetic.load("tiny"), oracle=True)


@pytest.mark.parametrize("entry", ["trainer", "stream", "device_graph"])
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
    assert out.shape == (4, 6) and dx.shape == (9, 6)
    assert kernel.LAUNCHES == {"gather_agg_fwd": 0, "gather_agg_bwd_dx": 0}
