"""Lint rule registry (`repro/analysis/rules.py`), extended with PyTorch
idioms: each rule encodes one written-but-unchecked invariant of the port
as a pure function over a module's AST.

A rule is a callable `(tree, ctx) -> Iterable[Violation]` registered
under a stable kebab-case name (the name the waiver syntax and the JSON
report key on). The reference's seven rules keep their names here, so a
waiver in `src/repro_torch` is a known waiver to both lints. Rules never
read scope policy themselves: scoping comes from `ctx.config`
(`AnalysisConfig`).

Rule catalog:

  no-global-numpy-random   np.random.seed / module-level np.random.<fn>
  no-stdlib-random         any import of the stdlib `random` module
  no-wall-clock            time.time/monotonic/perf_counter, datetime.now
                           in deterministic modules
  no-host-sync-in-hot-path .item()/float()/int()/bool() on values,
                           np.asarray/np.array, .cpu()/.tolist()/.numpy(),
                           .synchronize() (torch.cuda, an Event, a Stream),
                           torch.nonzero/.nonzero(), .to("cpu"), a .cuda()
                           or .to(<device>) without non_blocking=True, and
                           torch.tensor/as_tensor(..., device=...) inside
                           hot-path functions
  no-f64-in-device-code    float64 dtypes (numpy's, torch.float64 /
                           torch.double, .double()) in device modules
  rng-structured-seed      np.random.default_rng must take a literal
                           (seed, salt, ...) tuple, never a bare int
  no-deprecated-import     internal imports of deprecation shims (the port
                           has none; kept so that the names match)
  no-torch-global-rng      torch.manual_seed / torch.seed, and torch.rand*
                           / randperm / bernoulli / multinomial / normal
                           (and their in-place forms) without generator=
                           in deterministic modules
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.config import AnalysisConfig


@dataclass
class Violation:
    rule: str
    path: str               # relative to src/
    line: int
    col: int
    message: str
    waived: bool = False
    justification: Optional[str] = None

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "waived": self.waived,
                "justification": self.justification}


@dataclass
class RuleContext:
    """Per-module state shared by every rule: resolved import aliases,
    a function-span index for hot-path scoping, and the scope config."""
    relpath: str
    config: AnalysisConfig
    aliases: Dict[str, str] = field(default_factory=dict)
    # (name, start_line, end_line) for every def, innermost-last
    func_spans: List[Tuple[str, int, int]] = field(default_factory=list)

    @classmethod
    def build(cls, relpath: str, tree: ast.AST,
              config: AnalysisConfig) -> "RuleContext":
        ctx = cls(relpath=relpath, config=config)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    ctx.aliases[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    ctx.aliases[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ctx.func_spans.append(
                    (node.name, node.lineno,
                     node.end_lineno or node.lineno))
        return ctx

    def resolves(self, name: str, module: str) -> bool:
        """Does local name `name` refer to `module` (via import alias)?"""
        return self.aliases.get(name) == module

    def enclosing_function(self, line: int) -> Optional[str]:
        """Name of the innermost def containing `line` (smallest span)."""
        best, best_size = None, None
        for name, lo, hi in self.func_spans:
            if lo <= line <= hi and (best_size is None
                                     or hi - lo < best_size):
                best, best_size = name, hi - lo
        return best

    def in_hot_function(self, line: int) -> bool:
        hot = self.config.hot_names(self.relpath)
        if not hot:
            return False
        if "*" in hot:
            return True
        fn = self.enclosing_function(line)
        return fn is not None and fn in hot


RuleFn = Callable[[ast.AST, RuleContext], Iterable[Violation]]
RULES: Dict[str, RuleFn] = {}


def rule(name: str) -> Callable[[RuleFn], RuleFn]:
    def deco(fn: RuleFn) -> RuleFn:
        RULES[name] = fn
        return fn
    return deco


def _v(name: str, ctx: RuleContext, node: ast.AST, msg: str) -> Violation:
    return Violation(rule=name, path=ctx.relpath, line=node.lineno,
                     col=node.col_offset, message=msg)


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Flatten `a.b.c` to "a.b.c"; None for non-trivial bases."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _canonical(chain: str, ctx: RuleContext) -> str:
    """`chain` with its root resolved through the import aliases."""
    root, _, rest = chain.partition(".")
    target = ctx.aliases.get(root, root)
    return f"{target}.{rest}" if rest else target


def _numpy_chain(chain: str, ctx: RuleContext) -> Optional[str]:
    """If `chain` starts at a numpy alias, return it rewritten with the
    canonical "numpy" root; else None."""
    full = _canonical(chain, ctx)
    return full if full == "numpy" or full.startswith("numpy.") else None


def _torch_chain(chain: Optional[str], ctx: RuleContext) -> Optional[str]:
    """`chain` rewritten with the canonical "torch" root, or None."""
    if chain is None:
        return None
    full = _canonical(chain, ctx)
    return full if full == "torch" or full.startswith("torch.") else None


# Constructors living under np.random that are deterministic-by-seed and
# therefore fine (everything else under np.random is the implicit global
# `RandomState`, which this repo bans).
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
                 "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937"}


@rule("no-global-numpy-random")
def no_global_numpy_random(tree: ast.AST,
                           ctx: RuleContext) -> Iterable[Violation]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        chain = _attr_chain(node)
        if chain is None:
            continue
        np_chain = _numpy_chain(chain, ctx)
        if np_chain is None or not np_chain.startswith("numpy.random."):
            continue
        leaf = np_chain.split(".")[2]
        if leaf not in _NP_RANDOM_OK:
            yield _v("no-global-numpy-random", ctx, node,
                     f"module-level numpy randomness `{chain}` — use a "
                     f"seeded Generator or the counter-based hash path "
                     f"in batching/order.py")


@rule("no-stdlib-random")
def no_stdlib_random(tree: ast.AST, ctx: RuleContext) -> Iterable[Violation]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "random" or a.name.startswith("random."):
                    yield _v("no-stdlib-random", ctx, node,
                             "stdlib `random` is process-global state — "
                             "use np.random.default_rng((seed, salt))")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "random":
                yield _v("no-stdlib-random", ctx, node,
                         "stdlib `random` is process-global state — "
                         "use np.random.default_rng((seed, salt))")


_WALL_CLOCK = {
    "time": {"time", "monotonic", "perf_counter", "process_time",
             "thread_time", "monotonic_ns", "perf_counter_ns", "time_ns"},
    "datetime": {"now", "utcnow", "today"},
}


@rule("no-wall-clock")
def no_wall_clock(tree: ast.AST, ctx: RuleContext) -> Iterable[Violation]:
    if not ctx.config.in_deterministic(ctx.relpath):
        return
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        chain = _attr_chain(node.func)
        if chain is None:
            continue
        root, *rest = chain.split(".")
        target = ctx.aliases.get(root, root)
        if target == "time" and rest and rest[-1] in _WALL_CLOCK["time"]:
            yield _v("no-wall-clock", ctx, node,
                     f"wall-clock read `{chain}()` in a deterministic "
                     f"module — output must be a pure function of "
                     f"(seed, cursor)")
        elif (target in ("datetime", "datetime.datetime")
              and rest and rest[-1] in _WALL_CLOCK["datetime"]):
            yield _v("no-wall-clock", ctx, node,
                     f"wall-clock read `{chain}()` in a deterministic "
                     f"module")


_SYNC_ATTRS = {"item", "block_until_ready"}
_SYNC_NP = {"asarray", "array", "ascontiguousarray"}
_SYNC_JAX = {"device_get", "block_until_ready"}
# torch methods that read a device value on the host or wait for the device
_SYNC_TORCH_ATTRS = {"cpu", "tolist", "numpy", "synchronize", "nonzero"}
# names that, passed to `.to(...)`, name a device (a `.to(torch.int32)`
# cast names none)
_DEVICE_NAMES = {"device", "dev"}


def _kwarg(node: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_true(node: Optional[ast.AST]) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _names_device(node: ast.AST) -> Optional[str]:
    """"cpu" / "cuda" / "device" if `node` names a device, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        for kind in ("cpu", "cuda"):
            if node.value.startswith(kind):
                return kind
        return None
    if isinstance(node, ast.Name) and node.id in _DEVICE_NAMES:
        return "device"
    if isinstance(node, ast.Attribute) and node.attr in _DEVICE_NAMES:
        return "device"
    if isinstance(node, ast.Call):
        chain = _attr_chain(node.func)
        if chain is not None and chain.split(".")[-1] == "device":
            return "device"
    return None


def _torch_sync(node: ast.Call, f: ast.Attribute,
                ctx: RuleContext) -> Optional[str]:
    """Why this attribute call is a torch host-sync idiom, or None."""
    if f.attr in _SYNC_TORCH_ATTRS:
        return f"`.{f.attr}()` reads the device on the host or waits for it"
    if f.attr in ("to", "cuda"):
        target = _kwarg(node, "device")
        if target is None and node.args and f.attr == "to":
            target = node.args[0]
        kind = _names_device(target) if target is not None else \
            ("device" if f.attr == "cuda" else None)
        if kind == "cpu":
            return "`.to(\"cpu\")` copies to the host and waits for it"
        if kind is not None and not _is_true(_kwarg(node, "non_blocking")):
            return (f"`.{f.attr}(...)` to a device without "
                    f"non_blocking=True: a blocking copy that waits for "
                    f"the device")
        return None
    if f.attr in ("tensor", "as_tensor") and \
            _torch_chain(_attr_chain(f), ctx) is not None and \
            _kwarg(node, "device") is not None:
        return (f"`torch.{f.attr}(..., device=...)` copies host data to "
                f"the device with a blocking copy")
    return None


@rule("no-host-sync-in-hot-path")
def no_host_sync(tree: ast.AST, ctx: RuleContext) -> Iterable[Violation]:
    if not ctx.config.hot_names(ctx.relpath):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if not ctx.in_hot_function(node.lineno):
            continue
        fn_name = ctx.enclosing_function(node.lineno)
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("float", "int", "bool"):
            if node.args and not isinstance(node.args[0], ast.Constant):
                yield _v("no-host-sync-in-hot-path", ctx, node,
                         f"`{f.id}()` on a (possibly device) value in "
                         f"hot-path function `{fn_name}` — forces a "
                         f"blocking device->host transfer")
            continue
        if not isinstance(f, ast.Attribute):
            continue
        chain = _attr_chain(f)
        if f.attr in _SYNC_ATTRS and (chain is None
                                      or "." in (chain or "")):
            yield _v("no-host-sync-in-hot-path", ctx, node,
                     f"`.{f.attr}()` in hot-path function `{fn_name}` — "
                     f"synchronizes with the device")
            continue
        why = _torch_sync(node, f, ctx)
        if why is not None:
            yield _v("no-host-sync-in-hot-path", ctx, node,
                     f"{why} (hot-path function `{fn_name}`)")
            continue
        if chain is None:
            continue
        root, *rest = chain.split(".")
        target = ctx.aliases.get(root, root)
        if target == "numpy" and rest and rest[-1] in _SYNC_NP:
            yield _v("no-host-sync-in-hot-path", ctx, node,
                     f"`{chain}()` in hot-path function `{fn_name}` — "
                     f"pulls the operand to host memory")
        elif target == "jax" and rest and rest[-1] in _SYNC_JAX:
            yield _v("no-host-sync-in-hot-path", ctx, node,
                     f"`{chain}()` in hot-path function `{fn_name}`")


@rule("no-f64-in-device-code")
def no_f64_device(tree: ast.AST, ctx: RuleContext) -> Iterable[Violation]:
    if not ctx.config.in_device(ctx.relpath):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in ("float64",
                                                             "double"):
            chain = _attr_chain(node)
            if chain is None:
                continue
            root = chain.split(".")[0]
            target = ctx.aliases.get(root, root)
            if target in ("numpy", "jax.numpy", "jax", "torch"):
                yield _v("no-f64-in-device-code", ctx, node,
                         f"`{chain}` in device-facing code — the stack "
                         f"is f32/int32; f64 doubles feature-path "
                         f"memory traffic")
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "double" and not node.args):
            yield _v("no-f64-in-device-code", ctx, node,
                     "`.double()` in device-facing code — the stack is "
                     "f32/int32")
        elif (isinstance(node, ast.Constant)
              and node.value in ("float64", "f8", ">f8", "<f8")):
            yield _v("no-f64-in-device-code", ctx, node,
                     f"dtype string {node.value!r} in device-facing code")


@rule("rng-structured-seed")
def rng_structured_seed(tree: ast.AST,
                        ctx: RuleContext) -> Iterable[Violation]:
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "default_rng"):
            continue
        chain = _attr_chain(node.func)
        if chain is None or _numpy_chain(chain, ctx) is None:
            continue
        if not node.args and not node.keywords:
            yield _v("rng-structured-seed", ctx, node,
                     "`default_rng()` with no seed draws OS entropy — "
                     "nondeterministic")
        elif node.args and not isinstance(node.args[0], ast.Tuple):
            yield _v("rng-structured-seed", ctx, node,
                     "`default_rng` seed must be a literal structured "
                     "tuple `(seed, salt, ...)` so independent streams "
                     "can never collide on a shared bare int")


@rule("no-deprecated-import")
def no_deprecated_import(tree: ast.AST,
                         ctx: RuleContext) -> Iterable[Violation]:
    deprecated = ctx.config.deprecated_modules
    shim_paths = {m.replace(".", "/") + ".py" for m in deprecated}
    if ctx.relpath in shim_paths:
        return                  # the shim itself re-exports; that's fine
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in deprecated:
                    yield _v("no-deprecated-import", ctx, node,
                             f"`{a.name}` is a deprecation shim — "
                             f"import `{deprecated[a.name]}` instead")
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module in deprecated:
                yield _v("no-deprecated-import", ctx, node,
                         f"`{node.module}` is a deprecation shim — "
                         f"import `{deprecated[node.module]}` instead")
            else:
                for a in node.names:
                    full = f"{node.module}.{a.name}"
                    if full in deprecated:
                        yield _v("no-deprecated-import", ctx, node,
                                 f"`{full}` is a deprecation shim — "
                                 f"import `{deprecated[full]}` instead")


# torch's global-generator draws: each takes `generator=` to draw from an
# explicit (seeded, cursor-derived) generator instead
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "bernoulli", "multinomial",
                "normal", "poisson"}
_TENSOR_DRAWS = {"bernoulli", "bernoulli_", "uniform_", "normal_",
                 "random_", "exponential_", "geometric_", "cauchy_",
                 "log_normal_", "multinomial"}
_TORCH_SEEDING = {"torch.manual_seed", "torch.seed", "torch.initial_seed",
                  "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                  "torch.cuda.seed", "torch.cuda.seed_all",
                  "torch.random.manual_seed", "torch.random.seed"}


@rule("no-torch-global-rng")
def no_torch_global_rng(tree: ast.AST,
                        ctx: RuleContext) -> Iterable[Violation]:
    if not ctx.config.in_deterministic(ctx.relpath):
        return
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        chain = _attr_chain(node.func)
        full = _torch_chain(chain, ctx)
        if full in _TORCH_SEEDING:
            yield _v("no-torch-global-rng", ctx, node,
                     f"`{chain}()` seeds torch's process-global generator "
                     f"in a deterministic module — seed a "
                     f"`torch.Generator` from the cursor instead")
            continue
        if _kwarg(node, "generator") is not None:
            continue
        leaf = node.func.attr
        if (full is not None and full.count(".") == 1
                and leaf in _TORCH_DRAWS) or \
                (full is None and leaf in _TENSOR_DRAWS):
            yield _v("no-torch-global-rng", ctx, node,
                     f"`{chain or leaf}()` without generator= draws from "
                     f"torch's process-global generator in a "
                     f"deterministic module")
