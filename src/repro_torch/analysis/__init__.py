"""`repro_torch.analysis`: the port's analysis gate (`repro/analysis`).

Three cooperating passes:

- **AST lint** (`lint.py` + `rules.py`): the reference's rule registry,
  keyed on `repro_torch/...` scopes (`config.py`) and extended with
  PyTorch idioms — `.cpu()`, `.tolist()`, `.numpy()`, `.synchronize()`,
  `nonzero`, blocking `.to(<device>)` / `.cuda()` and
  `torch.tensor(..., device=)` in hot-path functions, `torch.float64` /
  `.double()` in device modules, and torch's global generator in
  deterministic modules. Legitimate uses carry a per-line
  `# analysis: allow[<rule>] -- justification` waiver naming a rule the
  reference also has.

- **Op audit** (`op_audit.py`, imported lazily): runs the train step, the
  eval pass, the batch builder, the epoch-order programs and the gather
  kernels under a `TorchDispatchMode` that records every aten op, and
  checks the record for syncs outside the named windows, float64, a
  stable op stream across batches / epochs / resume, and the kernels'
  launches.

- **Sync gate** (`sync_gate.py`): CUDA's sync debug mode at "error" for a
  hot loop on the card, with `allowed_sync(name)` windows around the
  trainer's documented host reads, counted by name.

    python -m repro_torch.analysis --strict --device cpu

runs the lint and the audit (the card's sections need the card) and
writes its JSON report under `build/`.
"""
from repro_torch.analysis.config import AnalysisConfig
from repro_torch.analysis.lint import LintReport, lint_paths, lint_source
from repro_torch.analysis.rules import RULES, Violation

__all__ = [
    "AnalysisConfig",
    "LintReport",
    "lint_paths",
    "lint_source",
    "RULES",
    "Violation",
]


def __getattr__(name):
    if name == "op_audit":          # imports torch: only when asked for
        import importlib
        return importlib.import_module("repro_torch.analysis.op_audit")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
