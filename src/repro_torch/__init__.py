"""PyTorch + CUDA port of the COMM-RAND GNN trainer (`repro` is the JAX
reference it is held against).

The layout mirrors `repro`: a module here has its counterpart at the same
path under `src/repro/`. The port imports `torch` and `numpy`, never `jax`
and never `repro`; pure-numpy reference modules are copied, not imported.

Entry points (`GNNTrainer`, `BatchStream`, `DeviceGraph.from_graph`) run
on the CUDA device unless the caller passes `device="cpu"`; with no card
and no explicit CPU device they raise (`repro_torch.devices`). The fused
gather-aggregate kernels live in `csrc/` and are built with `nvcc` at
first use (`repro_torch.kernels.build`).
"""
