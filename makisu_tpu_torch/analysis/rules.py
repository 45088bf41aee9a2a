"""The six ``makisu-tpu-torch check`` rules, each distilled from a
shipped bug.

Copy of ``makisu_tpu/analysis/rules.py``, the rules unchanged: every
rule names the reference PR whose review caught its bug class by hand;
the rule exists so the next instance fails CI instead of waiting for a
reviewer to remember. docs/ANALYSIS.md carries the full catalog and the
pragma/baseline workflow. The metric-name registry is this package's
``utils/metrics.py``.
"""

from __future__ import annotations

import ast

from makisu_tpu_torch.analysis.engine import (FileContext, Finding,
                                              Rule, call_name, expr_text,
                                              keyword_arg, last_attr)


def _file_is(ctx: FileContext, *suffixes: str) -> bool:
    return any(ctx.path.endswith(s) for s in suffixes)


class CtxPropagationRule(Rule):
    """PR 2's bug class: pool/thread work spawned without the caller's
    contextvars loses the build's telemetry registry and log sink —
    its spans/counters land in the process-global registry and
    concurrent worker builds mix. Every thread spawn must go through
    ``contextvars.copy_context().run`` (or the ``utils/concurrency``
    wrappers, which do it internally)."""

    name = "ctx-propagation"
    description = ("threading.Thread / pool .submit outside "
                   "utils/concurrency must carry contextvars via "
                   "copy_context().run")

    # Files that ARE the sanctioned wrappers (they implement the
    # propagation the rule enforces everywhere else).
    _EXEMPT = ("utils/concurrency.py", "registry/transfer.py")

    def collect(self, ctx: FileContext) -> list[Finding]:
        if _file_is(ctx, *self._EXEMPT):
            return []
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in ("threading.Thread", "Thread"):
                target = keyword_arg(node, "target")
                if target is None:
                    continue  # subclass style; run() overrides carry
                if not (isinstance(target, ast.Attribute)
                        and target.attr == "run"):
                    out.append(ctx.finding(
                        self.name, node,
                        "threading.Thread target does not ride a "
                        "copied context; use target=contextvars."
                        "copy_context().run (or a utils/concurrency "
                        "wrapper) so the build's telemetry registry "
                        "and log sink follow the thread"))
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr == "submit"):
                recv = expr_text(node.func.value).lower()
                if "pool" not in recv and "executor" not in recv:
                    continue  # not an executor-shaped receiver
                first = node.args[0] if node.args else None
                if (isinstance(first, ast.Attribute)
                        and first.attr == "run"):
                    continue  # submit(ctx.run, fn, ...)
                out.append(ctx.finding(
                    self.name, node,
                    "pool .submit without context propagation; use "
                    "concurrency.submit_ctx / ctx_map, or pass "
                    "copy_context().run as the callable"))
        return out


class SignalSafetyRule(Rule):
    """PR 4's review-fix class: the flight recorder's dump path runs
    inside SIGTERM/SIGUSR1 handlers, where the interrupted frame may
    hold any lock in the process — a timeout-less ``Lock.acquire`` (or
    a ``with lock:``) deadlocks the dying process, and logging both
    allocates and takes the logging module's own locks. This rule walks
    call-graph reachability from the actual handler installs (every
    function passed to ``signal.signal``) plus ``FlightRecorder.dump``
    and flags those operations in reachable code.

    Resolution is name-based and deliberately conservative: an
    attribute call resolves only when its name has at most
    ``_MAX_DEFS`` definitions repo-wide and does not shadow a builtin
    (a method named ``open`` must not wire its class into the signal
    set every time the dump path opens a file), so ubiquitous names
    never drag unrelated code in."""

    name = "signal-safety"
    description = ("code reachable from signal handlers / "
                   "flightrecorder.dump must not block on timeout-less "
                   "locks or log")

    _MAX_DEFS = 3
    _LOG_RECEIVERS = ("log", "logging")
    _LOG_LEVELS = {"debug", "info", "warning", "warn", "error",
                   "exception", "critical"}

    def __init__(self) -> None:
        # name -> list of (qualname, file ctx); qualname -> callee names
        self._defs: dict[str, list[tuple[str, FileContext]]] = {}
        self._edges: dict[str, set[str]] = {}
        # qualname -> potential violations [(Finding-ready args)]
        self._hazards: dict[str, list[tuple[FileContext, ast.AST,
                                            str]]] = {}
        self._roots: set[str] = set()

    def collect(self, ctx: FileContext) -> list[Finding]:
        module = ctx.path[:-3].replace("/", ".")
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # The def-count suffix keeps same-named definitions
                # (module-level wrapper + method, re-defs) from
                # overwriting each other's edges/hazards; BFS resolves
                # by NAME, so every definition still participates.
                seq = len(self._defs.setdefault(node.name, []))
                qual = f"{module}:{node.name}#{seq}"
                self._defs[node.name].append((qual, ctx))
                callees, hazards = self._scan_body(node, ctx)
                self._edges[qual] = callees
                self._hazards[qual] = hazards
            elif isinstance(node, ast.Call):
                self._note_root(node)
        # The issue's named seed: the flight recorder's dump entry.
        if _file_is(ctx, "utils/flightrecorder.py"):
            self._roots.add("dump")
        return []

    def _note_root(self, node: ast.Call) -> None:
        if call_name(node) not in ("signal.signal", "signal"):
            return
        if len(node.args) < 2:
            return
        handler = node.args[1]
        if isinstance(handler, ast.Name):
            self._roots.add(handler.id)
        elif isinstance(handler, ast.Lambda):
            for sub in ast.walk(handler.body):
                if isinstance(sub, ast.Call):
                    name = last_attr(sub)
                    if name:
                        self._roots.add(name)

    @staticmethod
    def _own_body(func: ast.AST):
        """Walk a function's OWN statements, stopping at nested
        def/lambda boundaries: a closure's hazards belong to the
        closure (collected as its own definition), not to every
        enclosing function — otherwise a pool-only worker closure
        gets flagged as signal-reachable through its parent."""
        stack = list(ast.iter_child_nodes(func))
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.Lambda)):
                stack.extend(ast.iter_child_nodes(node))

    def _scan_body(self, func: ast.AST, ctx: FileContext
                   ) -> tuple[set[str], list]:
        callees: set[str] = set()
        hazards: list = []
        for node in self._own_body(func):
            if isinstance(node, ast.Call):
                name = last_attr(node)
                if name:
                    callees.add(name)
                hazard = self._call_hazard(node)
                if hazard:
                    hazards.append((ctx, node, hazard))
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    text = expr_text(item.context_expr).lower()
                    if "lock" in text and ".acquire" not in text:
                        hazards.append((
                            ctx, node,
                            f"`with {expr_text(item.context_expr)}` is "
                            f"a timeout-less lock acquire"))
        return callees, hazards

    def _call_hazard(self, node: ast.Call) -> str | None:
        if isinstance(node.func, ast.Attribute):
            recv = expr_text(node.func.value)
            if (node.func.attr == "acquire" and "lock" in recv.lower()
                    and not node.args and not node.keywords):
                return (f"timeout-less {recv}.acquire() — probe with "
                        f"acquire(timeout=...) and skip on failure")
            if (isinstance(node.func.value, ast.Name)
                    and node.func.value.id in self._LOG_RECEIVERS
                    and node.func.attr in self._LOG_LEVELS):
                return (f"logging call ({recv}.{node.func.attr}) — "
                        f"logging allocates and takes the log sink's "
                        f"locks")
        return None

    def finalize(self) -> list[Finding]:
        # BFS over name-resolved edges from the handler roots.
        reachable: dict[str, str] = {}  # qualname -> via-path
        frontier: list[tuple[str, str]] = []
        for root in sorted(self._roots):
            for qual, _ctx in self._defs.get(root, []):
                if qual not in reachable:
                    reachable[qual] = root
                    frontier.append((qual, root))
        import builtins
        shadowed = set(dir(builtins))
        while frontier:
            qual, path = frontier.pop()
            for callee in sorted(self._edges.get(qual, ())):
                if callee in shadowed:
                    continue  # `open`, `print`, ...: almost certainly
                    # the builtin, not the same-named repo method
                defs = self._defs.get(callee, [])
                if not defs or len(defs) > self._MAX_DEFS:
                    continue
                for cqual, _ctx in defs:
                    if cqual not in reachable:
                        via = f"{path} -> {callee}"
                        reachable[cqual] = via
                        frontier.append((cqual, via))
        out: list[Finding] = []
        for qual, via in sorted(reachable.items()):
            for ctx, node, hazard in self._hazards.get(qual, []):
                lineno = getattr(node, "lineno", 1)
                if ctx.allowed(self.name, lineno):
                    continue
                out.append(ctx.finding(
                    self.name, node,
                    f"{hazard} [signal-reachable via {via}]"))
        return out


class MetricRegistryRule(Rule):
    """PR 11's FLEET_* dedup review fix, generalized: every name passed
    to ``counter_add``/``gauge_set``/``observe`` must be a constant
    defined in ``utils/metrics.py`` (one spelling per series — raw
    literals are where the `makisu_fleet_route_total` /
    `makisu_fleet_routes_total` drift came from), and user-influenced
    ``tenant`` labels must route through a cardinality-capping helper
    so a hostile tenant mix cannot explode the process registry."""

    name = "metric-registry"
    description = ("metric names must be utils/metrics.py constants; "
                   "tenant-like labels must be cardinality-capped")

    _WRITES = {"counter_add", "gauge_set", "observe", "observe_batch"}
    _CAP_HELPERS = ("tenant_label", "cap_label")

    def __init__(self) -> None:
        self._constants: set[str] = set(self._module_constants())
        self._pending: list[tuple[FileContext, ast.Call, str]] = []

    @staticmethod
    def _module_constants() -> set[str]:
        """The registry: every ALL-CAPS string constant utils/metrics.py
        defines, read from the installed module so single-file scans
        (tests, editors) see the same registry a repo scan does."""
        try:
            from makisu_tpu_torch.utils import metrics
        except Exception:  # pragma: no cover - broken tree mid-refactor
            return set()
        return {attr for attr in dir(metrics)
                if attr.isupper()
                and isinstance(getattr(metrics, attr), str)}

    def collect(self, ctx: FileContext) -> list[Finding]:
        if _file_is(ctx, "utils/metrics.py"):
            # The registry itself: constants live here, and its helpers
            # take the name as a parameter.
            for node in ast.walk(ctx.tree):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id.isupper()
                        and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)):
                    self._constants.add(node.targets[0].id)
            return []
        # Module-level aliases of registry constants
        # (``PEER_CHUNK_HITS = metrics.FLEET_PEER_CHUNK_HITS``) resolve
        # one hop before the check.
        aliases: dict[str, str] = {}
        for node in ctx.tree.body if isinstance(ctx.tree, ast.Module) \
                else []:
            if (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id.isupper()):
                target = self._const_name(node.value)
                if target and target.isupper():
                    aliases[node.targets[0].id] = target
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if last_attr(node) not in self._WRITES:
                continue
            name_expr = (node.args[0] if node.args
                         else keyword_arg(node, "name"))
            if name_expr is not None:
                verdict = self._check_name(name_expr, aliases)
                if verdict == "literal":
                    out.append(ctx.finding(
                        self.name, node,
                        f"raw metric name literal "
                        f"{expr_text(name_expr)}; define a constant "
                        f"in utils/metrics.py and reference it"))
                elif verdict == "computed":
                    out.append(ctx.finding(
                        self.name, node,
                        "computed metric name; metric names must be "
                        "utils/metrics.py constants"))
                elif verdict == "unknown-constant":
                    const = self._const_name(name_expr)
                    self._pending.append((ctx, node,
                                          aliases.get(const, const)))
            tenant = keyword_arg(node, "tenant")
            if tenant is not None and not self._capped(tenant):
                out.append(ctx.finding(
                    self.name, node,
                    "user-influenced tenant label is not routed "
                    "through a cardinality-capping helper "
                    "(e.g. scheduler.tenant_label)"))
        return out

    @staticmethod
    def _const_name(expr: ast.expr) -> str:
        if isinstance(expr, ast.Attribute):
            return expr.attr
        if isinstance(expr, ast.Name):
            return expr.id
        return ""

    def _check_name(self, expr: ast.expr,
                    aliases: dict[str, str]) -> str:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return "literal"
        if isinstance(expr, (ast.JoinedStr, ast.BinOp)):
            return "computed"
        name = self._const_name(expr)
        if name and name.isupper():
            name = aliases.get(name, name)
            # Defer: utils/metrics.py may not have been scanned yet.
            return ("ok" if name in self._constants
                    else "unknown-constant")
        # A lowercase variable: a pass-through helper's parameter —
        # checked at ITS call sites, not here.
        return "ok"

    def _capped(self, expr: ast.expr) -> bool:
        if isinstance(expr, ast.Constant):
            return True  # a static label is not user-influenced
        if isinstance(expr, ast.Call):
            return any(h in (last_attr(expr) or "")
                       for h in self._CAP_HELPERS)
        return False

    def finalize(self) -> list[Finding]:
        out: list[Finding] = []
        for ctx, node, const in self._pending:
            if const in self._constants:
                continue
            lineno = getattr(node, "lineno", 1)
            if ctx.allowed(self.name, lineno):
                continue
            out.append(ctx.finding(
                self.name, node,
                f"metric name constant {const} is not defined in "
                f"utils/metrics.py"))
        return out


class AtomicWriteRule(Rule):
    """PR 10's statcache fix: a ``json.dump`` straight onto a state
    file leaves a truncated half-JSON behind when the process dies
    mid-write (SIGTERM, OOM, power cut) — the next build then fails on
    the torn file or silently starts cold. Durable JSON goes through
    ``fileio.write_json_atomic`` (unique temp + fsync + rename)."""

    name = "atomic-write"
    description = ("json.dump to durable files must use "
                   "fileio.write_json_atomic")

    # The sanctioned implementations of the atomic write itself.
    _EXEMPT = ("utils/fileio.py", "utils/metrics.py")

    def collect(self, ctx: FileContext) -> list[Finding]:
        if _file_is(ctx, *self._EXEMPT):
            return []
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and last_attr(node) == "dump"
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in ("json", "json_mod")):
                out.append(ctx.finding(
                    self.name, node,
                    "direct json.dump to a file; a crash mid-write "
                    "truncates durable state — use "
                    "fileio.write_json_atomic"))
        return out


class SilentSwallowRule(Rule):
    """The sink/thread review staple: a broad ``except Exception``
    whose body neither re-raises nor makes ANY call (no log line, no
    dropped-counter bump) erases the failure completely — the bug
    class behind every "the build silently did nothing" report. Narrow
    exception types are fine; broad catches must leave a trace."""

    name = "silent-swallow"
    description = ("broad except blocks must log, count, or re-raise "
                   "— never swallow silently")

    _BROAD = {"Exception", "BaseException"}

    def collect(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad(node.type):
                continue
            if self._leaves_trace(node):
                continue
            out.append(ctx.finding(
                self.name, node,
                "broad except swallows the failure without logging, "
                "counting, or re-raising; narrow the type, log it, or "
                "bump a dropped-counter"))
        return out

    def _is_broad(self, type_node: ast.expr | None) -> bool:
        if type_node is None:
            return True  # bare except
        if isinstance(type_node, ast.Name):
            return type_node.id in self._BROAD
        if isinstance(type_node, ast.Tuple):
            return any(self._is_broad(e) for e in type_node.elts)
        return False

    @staticmethod
    def _leaves_trace(handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, (ast.Raise, ast.Call)):
                return True
        return False


class UnboundedIORule(Rule):
    """The timeout discipline the transport layer already follows,
    enforced: a socket or HTTP connection constructed without a
    timeout turns a wedged peer into a wedged build — the exact
    failure mode the stall watchdog exists to catch, except the
    watchdog can only dump it, not prevent it."""

    name = "unbounded-io"
    description = ("socket/HTTPConnection construction must carry a "
                   "timeout")

    def collect(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            tail = last_attr(node)
            message = None
            if name.endswith("socket.create_connection"):
                if not self._has_timeout(node, min_positional=2):
                    message = ("socket.create_connection without a "
                               "timeout")
            elif (tail.endswith("HTTPConnection")
                  or tail.endswith("HTTPSConnection")):
                # Only this repo's Unix-socket subclasses take
                # (path, timeout, ...) positionally; for everything
                # else — most importantly stdlib
                # http.client.HTTPConnection(host, port) — two
                # positional args are NOT a timeout.
                min_pos = 2 if tail.startswith("_Unix") else 99
                if not self._has_timeout(node, min_positional=min_pos):
                    message = (f"{tail} constructed without a timeout")
            elif tail == "urlopen":
                if not self._has_timeout(node, min_positional=3):
                    message = "urllib.request.urlopen without a timeout"
            if message:
                out.append(ctx.finding(
                    self.name, node,
                    f"{message}; a wedged peer becomes a wedged "
                    f"build — pass timeout="))
        return out

    @staticmethod
    def _has_timeout(node: ast.Call, min_positional: int) -> bool:
        if keyword_arg(node, "timeout") is not None:
            return True
        return len(node.args) >= min_positional


ALL_RULES = (CtxPropagationRule, SignalSafetyRule, MetricRegistryRule,
             AtomicWriteRule, SilentSwallowRule, UnboundedIORule)


def default_rules() -> list[Rule]:
    """Fresh rule instances (whole-program rules carry state; a run
    must never reuse another run's)."""
    return [cls() for cls in ALL_RULES]
