"""repro_torch.analysis: the port's lint against the reference's on the
reference's own rule fixtures, the PyTorch idioms it adds, the port tree
strict-clean under both lints' waiver names, every op-audit section on
the CPU, the audit's detectors, the CLI, the allowance windows against
`promised_reads`, and the repaired sync stream's batches against the
reference's."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import RULES as REF_RULES
from repro.analysis.config import AnalysisConfig as RefConfig
from repro.analysis.lint import lint_source as ref_lint_source
from repro.batching import BatchStream as BatchStreamJ
from repro.batching import make_policy as make_policy_j
from repro.core import minibatch as mb_j
from repro.graphs.csr import DeviceGraph as DeviceGraphJ
from repro_torch import sampling
from repro_torch.analysis import (RULES, AnalysisConfig, LintReport,
                                  lint_paths, lint_source, op_audit,
                                  sync_gate)
from repro_torch.batching import BatchStream, make_policy
from repro_torch.batching.stream import batch_roots
from repro_torch.core import minibatch as mb
from repro_torch.core.reorder import prepare
from repro_torch.graphs import synthetic
from repro_torch.graphs.csr import DeviceGraph
from repro_torch.resilience.guard import GuardConfig
from test_torch_batching import (assert_batches_equal, injected,
                                 jax_uniforms)

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = {"ref": "repro", "port": "repro_torch"}


@pytest.fixture(scope="module")
def tiny_t():
    return prepare(synthetic.load("tiny"), oracle=True)


# ---------------------------------------------------------------------------
# lint parity on the reference's rule fixtures (tests/test_analysis.py)
# ---------------------------------------------------------------------------
# (id, source, module path under the package, config). "{pkg}" in a
# source stands for the package's name.
FIXTURES = [
    ("np-random-positive", "import numpy as np\nnp.random.seed(0)\n"
     "x = np.random.rand(3)\n", "core/foo.py", None),
    ("np-random-negative", "import numpy as np\n"
     "rng = np.random.default_rng((1, 2))\nss = np.random.SeedSequence(7)\n",
     "core/foo.py", None),
    ("np-random-waiver", "import numpy as np\nnp.random.seed(0)  "
     "# analysis: allow[no-global-numpy-random] -- fixture\n",
     "core/foo.py", None),
    ("stdlib-random-import", "import random\n", "core/foo.py", None),
    ("stdlib-random-from", "from random import shuffle\n", "core/foo.py",
     None),
    ("stdlib-random-negative", "import numpy as np\n", "core/foo.py", None),
    ("stdlib-random-waiver", "# analysis: allow[no-stdlib-random] -- "
     "fixture only\nimport random\n", "core/foo.py", None),
    ("wall-clock-positive", "import time\nt = time.time()\n"
     "m = time.monotonic()\n", "pipeline/foo.py", None),
    ("wall-clock-datetime", "from datetime import datetime\n"
     "d = datetime.now()\n", "batching/foo.py", None),
    ("wall-clock-out-of-scope", "import time\nt = time.time()\n"
     "m = time.monotonic()\n", "train/foo.py", None),
    ("wall-clock-waiver", "import time\nt = time.monotonic()  "
     "# analysis: allow[no-wall-clock] -- heartbeat\n", "pipeline/foo.py",
     None),
    ("host-sync-positive", "import numpy as np\ndef hot_fn(x):\n"
     "    a = float(x)\n    b = x.item()\n    c = np.asarray(x)\n"
     "    return a, b, c\n", "pipeline/hot.py", "hot"),
    ("host-sync-cold", "def cold_fn(x):\n    return float(x)\n",
     "pipeline/hot.py", "hot"),
    ("host-sync-literal", "def hot_fn(x):\n    return float('inf')\n",
     "pipeline/hot.py", "hot"),
    ("host-sync-star", "import jax\ndef anything(x):\n"
     "    return jax.device_get(x)\n", "kernels/k.py", "hot"),
    ("host-sync-waiver", "def hot_fn(x):\n"
     "    # analysis: allow[no-host-sync-in-hot-path] -- boundary flush\n"
     "    return float(x)\n", "pipeline/hot.py", "hot"),
    ("f64-positive", "import jax.numpy as jnp\nx = jnp.zeros(3, jnp.float64)"
     "\ny = x.astype('float64')\n", "kernels/foo.py", None),
    ("f64-host-exempt", "import numpy as np\ns = np.float64(1.0)\n",
     "featcache/plan.py", None),
    ("f64-non-device", "import numpy as np\ns = np.float64(1.0)\n",
     "core/community.py", None),
    ("rng-seed-positive", "import numpy as np\n"
     "a = np.random.default_rng(5)\nb = np.random.default_rng()\n",
     "core/foo.py", None),
    ("rng-seed-negative", "import numpy as np\n"
     "a = np.random.default_rng((5, 0))\n"
     "b = np.random.default_rng((seed, epoch, pos))\n", "core/foo.py",
     None),
    ("deprecated-from", "from {pkg}.core.cachesim import lru_misses\n",
     "featcache/foo.py", "shims"),
    ("deprecated-import", "import {pkg}.core.sampler\n",
     "sampling/foo.py", "shims"),
    ("deprecated-from-package", "from {pkg}.core import cachesim\n",
     "featcache/foo.py", "shims"),
    ("deprecated-replacement", "from {pkg}.featcache import sim\n",
     "featcache/foo.py", "shims"),
    ("deprecated-shim-itself", "from {pkg}.featcache.sim import *\n",
     "core/cachesim.py", "shims"),
    ("waiver-unjustified", "import random  "
     "# analysis: allow[no-stdlib-random]\n", "core/foo.py", None),
    ("waiver-wrong-rule", "import random  "
     "# analysis: allow[no-wall-clock] -- wrong\n", "core/foo.py", None),
]


def _config(side: str, kind):
    cls = RefConfig if side == "ref" else AnalysisConfig
    pkg = PKG[side]
    if kind == "hot":
        return cls(hot_functions={f"{pkg}/pipeline/hot.py": ("hot_fn",),
                                  f"{pkg}/kernels/k.py": ("*",)})
    if kind == "shims":
        return cls(deprecated_modules={
            f"{pkg}.core.cachesim": f"{pkg}.featcache.sim",
            f"{pkg}.core.sampler": f"{pkg}.sampling"})
    return cls()


def _found(side: str, source: str, path: str, kind):
    pkg = PKG[side]
    lint = ref_lint_source if side == "ref" else lint_source
    return {(v.rule, v.line, v.waived, v.justification)
            for v in lint(source.replace("{pkg}", pkg), f"{pkg}/{path}",
                          _config(side, kind))}


@pytest.mark.parametrize("source,path,kind",
                         [f[1:] for f in FIXTURES],
                         ids=[f[0] for f in FIXTURES])
def test_lint_parity_with_reference(source, path, kind):
    """The port's lint keyed on `repro_torch/...` finds exactly what the
    reference's finds keyed on `repro/...`, waivers included."""
    assert _found("port", source, path, kind) == \
        _found("ref", source, path, kind)


def test_port_rules_extend_the_reference_rules():
    assert set(REF_RULES) <= set(RULES)
    assert set(RULES) - set(REF_RULES) == {"no-torch-global-rng"}


# ---------------------------------------------------------------------------
# the torch idioms
# ---------------------------------------------------------------------------
HOT = AnalysisConfig(hot_functions={"repro_torch/pipeline/hot.py":
                                    ("hot_fn",)})
SYNC_IDIOMS = ["x.cpu()", "x.tolist()", "x.numpy()",
               "torch.cuda.synchronize()", "ev.synchronize()",
               "torch.nonzero(x)", "x.nonzero()", "x.to('cpu')",
               "x.to('cpu', non_blocking=True)", "x.cuda()", "x.to(device)",
               "x.to(self.device)", "x.to(dev)", "x.to('cuda')",
               "x.to(device=g.device)", "torch.tensor(0.9, device=x.device)",
               "torch.as_tensor(a, device=device)"]
NOT_SYNC = ["x.to(torch.int32)", "x.to(x.dtype)",
            "x.to(device, non_blocking=True)", "x.cuda(non_blocking=True)",
            "torch.full((), 0.9, device=x.device)", "torch.tensor(0.9)"]


def _hot_hits(expr: str, fn: str = "hot_fn", waiver: str = ""):
    src = (f"import torch\ndef {fn}(x, a, ev, g, dev, device, self):\n"
           f"    {waiver}\n    return {expr}\n")
    return [v for v in lint_source(src, "repro_torch/pipeline/hot.py", HOT)
            if v.rule == "no-host-sync-in-hot-path"]


@pytest.mark.parametrize("expr", SYNC_IDIOMS)
def test_torch_sync_idiom_fires_only_in_a_hot_function(expr):
    (v,) = _hot_hits(expr)
    assert v.line == 4 and not v.waived
    assert _hot_hits(expr, fn="cold_fn") == []
    (w,) = _hot_hits(expr, waiver="# analysis: allow["
                     "no-host-sync-in-hot-path] -- epoch boundary")
    assert w.waived and w.justification == "epoch boundary"


@pytest.mark.parametrize("expr", NOT_SYNC)
def test_casts_and_non_blocking_copies_are_not_syncs(expr):
    assert _hot_hits(expr) == []


@pytest.mark.parametrize("expr", ["torch.zeros(3, dtype=torch.float64)",
                                  "torch.ones(2).to(torch.double)",
                                  "x.double()"])
def test_torch_f64_fires_in_device_modules_only(expr):
    src = f"import torch\ndef f(x):\n    return {expr}\n"

    def hits(path):
        return [v for v in lint_source(src, path)
                if v.rule == "no-f64-in-device-code"]
    assert hits("repro_torch/kernels/foo.py")
    assert not hits("repro_torch/launch/foo.py")


@pytest.mark.parametrize("expr", ["torch.manual_seed(0)", "torch.rand(3)",
                                  "torch.randperm(5)", "x.bernoulli_()",
                                  "torch.multinomial(x, 2)",
                                  "torch.cuda.manual_seed_all(1)"])
def test_torch_global_rng_fires_in_deterministic_modules(expr):
    def hits(e, path):
        src = f"import torch\ndef f(x, g):\n    return {e}\n"
        return [v.line for v in lint_source(src, path)
                if v.rule == "no-torch-global-rng"]
    assert hits(expr, "repro_torch/sampling/foo.py") == [3]
    assert hits(expr, "repro_torch/train/foo.py") == []
    assert hits("torch.rand(3, generator=g)",
                "repro_torch/sampling/foo.py") == []


def test_port_is_strict_clean():
    """Zero unwaived violations over src/repro_torch; every waiver is
    justified and names a rule the reference's lint knows too (which
    reads src/repro_torch as well); the port-only rule has no hit."""
    report = lint_paths(SRC)
    assert report.files_checked > 90
    msgs = [f"{v.path}:{v.line} [{v.rule}] {v.message}"
            for v in report.unwaived]
    assert not msgs, "\n".join(msgs)
    assert not report.unjustified() and not report.unknown_waivers
    assert report.strict_ok()
    assert {v.rule for v in report.waived} <= set(REF_RULES)
    assert not [v for v in report.violations
                if v.rule == "no-torch-global-rng"]
    assert all(v.path.startswith("repro_torch/") for v in report.violations)
    # the trainer's documented reads are audited waivers
    assert "repro_torch/train/gnn_loop.py" in {v.path
                                               for v in report.waived}


def test_unjustified_waiver_fails_strict():
    src = "import random  # analysis: allow[no-stdlib-random]\n"
    vs = lint_source(src, "repro_torch/core/foo.py")
    assert vs[0].waived and not LintReport(vs, 1).strict_ok()


# ---------------------------------------------------------------------------
# the op audit on the CPU
# ---------------------------------------------------------------------------
_PROBE = ("import sys\nfrom repro_torch.analysis.__main__ import main\n"
          "rc = main(sys.argv[1:])\n"
          "bad = [m for m in sys.modules\n"
          "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
          "assert not bad, bad\nsys.exit(rc)\n")


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """`python -m repro_torch.analysis --strict --device cpu --json <tmp>`
    run once in a fresh interpreter that must load no jax: (the process,
    its report, the reference report's bytes before the run)."""
    tmp = tmp_path_factory.mktemp("analysis")
    bench = SRC.parent / "BENCH_analysis.json"
    before = bench.read_bytes()
    out = tmp / "report.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), HOME=str(tmp))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, "--strict", "--device", "cpu",
         "--json", str(out)], capture_output=True, text=True, env=env,
        cwd=str(tmp), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc, json.loads(out.read_text()), before


@pytest.fixture(scope="module")
def audit(cli):
    return cli[1]["audit"]


@pytest.mark.parametrize("section", op_audit.SECTIONS)
def test_audit_section_ok_on_cpu(audit, section):
    rep = audit[section]
    assert rep["ok"], rep
    if section == "kernels":
        assert rep["skipped"] == "needs a CUDA device"
        assert op_audit.section_status(rep).startswith("skipped")
        assert rep["sources"]["files"] >= 8
    elif section == "sharded_step":
        assert "ROADMAP item 10" in rep["waiting"]
    elif section in ("device_order", "fused_build"):
        for pol in op_audit.POLICIES:
            assert rep[pol]["stable"] and rep[pol]["syncs"] == 0, pol
            if section == "fused_build":
                assert rep[pol]["sync_stream_same_ops"], pol
    elif section == "train_step":
        assert rep["stable"] and rep["syncs"] == 0 and rep["f64"] == 0
        assert rep["eval"]["ok"] and rep["loop"]["windows"] == {"drain": 1}


def test_detectors_fire_on_planted_faults(tiny_t):
    """A float64 tensor, a `.item()`, a bool-mask index and a `nonzero`
    are caught; an `.item()` inside an allowance window is counted, not
    failed; a shape change or an integer argument changes the hash, a
    float argument does not."""
    x = torch.ones(3)
    f64 = op_audit.hygiene(op_audit.record(
        lambda: x.to(torch.float64) * 2)[0])
    assert f64["f64"] == 2 and not f64["ok"]
    for plant in (lambda: x.sum().item(), lambda: x[x > 0],
                  lambda: torch.nonzero(x)):
        rep = op_audit.hygiene(op_audit.record(plant)[0])
        assert rep["syncs"] >= 1 and not rep["ok"]

    def allowed():
        with sync_gate.allowed_sync("drain"):
            return x.sum().item()
    rep = op_audit.hygiene(op_audit.record(allowed)[0])
    assert rep["ok"] and rep["allowed_syncs"] == {"drain": 1}

    feats = torch.ones((5, 4))
    rows = torch.tensor([0, 1], dtype=torch.int64)
    assert op_audit.feature_gathers(op_audit.record(
        feats.index_select, 0, rows)[0], 4)
    assert not op_audit.feature_gathers(op_audit.record(
        rows.index_select, 0, rows)[0], 4)

    def h(fn, *a):
        return op_audit.record_hash(op_audit.record(fn, *a)[0])
    assert h(torch.relu, torch.ones(3)) != h(torch.relu, torch.ones(4))
    assert h(lambda t: t[1:2], x) != h(lambda t: t[2:3], x)
    assert h(lambda t: t * 2.0, x) == h(lambda t: t * 3.0, x)

    # a planted `.item()` inside the real train step fails its hygiene
    tr = op_audit.make_trainer(tiny_t, "cpu", cache=None)
    batch = next(iter(tr.stream))
    clean = op_audit.hygiene(op_audit.step_record(tr, batch))
    step = tr.train_step

    def planted(*a, **k):
        loss, ok = step(*a, **k)
        loss.item()
        return loss, ok
    tr.train_step = planted
    bad = op_audit.hygiene(op_audit.step_record(tr, batch))
    assert clean["ok"] and bad["syncs"] == 1 and not bad["ok"]


def test_cli_strict_on_cpu_without_jax(cli, tmp_path):
    """`--strict --device cpu --json <tmp>` exits 0 with no jax loaded,
    reports every section, and leaves BENCH_analysis.json untouched; the
    reference's report path is refused."""
    proc, rep, before = cli
    assert rep["strict_ok"] and rep["lint"]["n_violations"] == 0
    assert rep["lint"]["n_waived"] > 0
    for section in op_audit.SECTIONS:
        assert rep["audit"][section]["ok"], section
    assert "audit: kernels      skipped (needs a CUDA device)" in \
        proc.stdout
    assert "audit: sharded_step waiting (ROADMAP item 10)" in proc.stdout
    bench = SRC.parent / "BENCH_analysis.json"
    assert bench.read_bytes() == before
    from repro_torch.analysis.__main__ import main
    with pytest.raises(SystemExit):
        main(["--skip-audit", "--json", str(tmp_path / bench.name)])
    assert not (tmp_path / bench.name).exists()


# ---------------------------------------------------------------------------
# the allowance windows and the repaired root copy
# ---------------------------------------------------------------------------
def test_windows_opened_equal_the_promise(tiny_t, tmp_path):
    """Across an epoch boundary with the dynamic cache, a guard read every
    3 steps and a checkpoint every 4, `train_steps` opens exactly the
    windows `promised_reads` promised; an evaluation opens one "eval"."""
    tr = op_audit.make_trainer(tiny_t, "cpu", ckpt_dir=str(tmp_path),
                               ckpt_every=4)
    tr.guard = GuardConfig(check_every=3)
    nb = tr.stream.num_batches()
    tr.train_steps(nb - 3)
    for n in (5, 2):
        want = tr.promised_reads(n)
        start = sync_gate.counts()
        tr.train_steps(n)
        end = sync_gate.counts()
        got = {k: end[k] - start.get(k, 0) for k in end
               if end[k] - start.get(k, 0)}
        assert got == want
    assert tr.cache_meter.refills > 0
    assert set(tr.promised_reads(nb + 1)) == {"drain", "guard", "refill",
                                              "integrity", "checkpoint"}
    start = sync_gate.counts()
    tr.evaluate(tiny_t.val_ids[:300])
    assert sync_gate.counts()["eval"] - start.get("eval", 0) == 1
    with pytest.raises(ValueError, match="unknown allowance window"):
        with sync_gate.allowed_sync("per_step"):
            pass
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        with sync_gate.sync_gate():
            pass


@pytest.mark.parametrize("policy", ["rand", "comm_rand"])
def test_sync_stream_roots_sliced_on_device_match_reference(
        tiny_graph, tiny_t, policy):
    """The sync stream's roots now come from one device copy of the
    epoch's order, sliced on the device: every batch's roots equal the
    reference's order, the batch built from them with the reference's
    uniforms equals the reference's batch, and `_take` equals a build
    from the host roots (the path it replaced) bit for bit."""
    B, fanouts, caps = 256, (5, 5), (768, 1152)
    gj = DeviceGraphJ.from_graph(tiny_graph)
    gt = DeviceGraph.from_graph(tiny_t, device="cpu")
    sj = BatchStreamJ(tiny_graph, make_policy_j(policy), B, fanouts, caps,
                      seed=3, device_graph=gj)
    st = BatchStream(tiny_t, make_policy(policy), B, fanouts, caps, seed=3,
                     device_graph=gt, device="cpu")
    labels = torch.as_tensor(tiny_graph.labels)
    sampler = sampling.make_sampler("biased", p=0.5)
    for epoch in (0, 1):
        want = sj.root_batches(epoch)
        nb = len(want)
        for pos in (0, 1, nb - 1):
            roots = batch_roots(st.epoch_roots(epoch), pos, B)
            np.testing.assert_array_equal(roots.numpy(), want[pos])
            key = jax.random.key(100 * epoch + pos)
            jb = mb_j.build_batch(key, gj, jnp.asarray(want[pos], jnp.int32),
                                  jnp.asarray(tiny_graph.labels), fanouts,
                                  caps, 0.5)
            tb = mb._build_batch_impl(
                gt, roots, labels, fanouts, caps, sampler,
                injected(jax_uniforms(key, fanouts, caps, B)))
            assert_batches_equal(tb, jb)
            taken = st._take(epoch, pos)
            host = st.build(st.root_batches(epoch)[pos], epoch, pos)
            for a, b in zip(taken.levels + [taken.labels, taken.label_mask],
                            host.levels + [host.labels, host.label_mask]):
                assert torch.equal(a, b)
    assert (want[-1] < 0).any()         # the padded last batch was held
