"""Diagnostic model for the static pipeline analyzer (nns-lint).

Copy of ``nnstreamer_tpu/analysis/diagnostics.py``.

A :class:`Diagnostic` is one finding: a stable code, a severity, the
element-path it anchors to (``appsrc[0]:src → tensor_transform[2]:sink``)
and — when the graph came from a pipeline string — the character offset of
the offending element so tools can print a source caret.  A :class:`Report`
collects every finding from every pass, because the whole point of the
analyzer is to surface ALL problems in one run instead of the runtime's
fail-on-first-push behavior.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding."""

    code: str  # stable kebab-case class, e.g. "caps-mismatch"
    severity: str  # ERROR | WARNING
    message: str  # field-level reason ("dtype uint8 ⊄ float32")
    path: str = ""  # element path ("appsrc[0]:src → tensor_filter[2]:sink")
    pos: Optional[int] = None  # char offset in the pipeline string

    def __str__(self) -> str:
        loc = f"{self.path}: " if self.path else ""
        at = f" (at char {self.pos})" if self.pos is not None else ""
        return f"{self.severity}[{self.code}] {loc}{self.message}{at}"


def node_label(node) -> str:
    """Stable element-path label: user name when given, else kind[id]."""
    return node.name if node.name else f"{node.kind}[{node.id}]"


def edge_path(graph, edge) -> str:
    src = node_label(graph.nodes[edge.src])
    dst = node_label(graph.nodes[edge.dst])
    return f"{src}:{edge.src_pad} → {dst}:{edge.dst_pad}"


class Report:
    """All findings of one analyzer run over one pipeline."""

    def __init__(self, source: Optional[str] = None):
        self.source = source  # original pipeline string (caret rendering)
        self.diagnostics: List[Diagnostic] = []
        #: the deep pass's static memory and census estimate
        #: (:class:`~.tracecheck.ResourceReport`); None unless
        #: analyze(deep=True) ran
        self.resources = None

    def add(self, code: str, severity: str, message: str, *, path: str = "",
            pos: Optional[int] = None) -> None:
        self.diagnostics.append(Diagnostic(code, severity, message, path, pos))

    def extend(self, diags) -> None:
        self.diagnostics.extend(diags)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == WARNING]

    @property
    def ok(self) -> bool:
        """No errors (warnings allowed)."""
        return not self.errors

    @property
    def clean(self) -> bool:
        """Nothing at all to report."""
        return not self.diagnostics

    def codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics})

    def render(self, *, carets: bool = True) -> str:
        """Human-readable report; diagnostics ordered by source position,
        each followed by a caret line into the pipeline string when its
        position is known."""
        if not self.diagnostics:
            return "OK: no diagnostics"
        order = sorted(
            self.diagnostics,
            key=lambda d: (d.pos if d.pos is not None else 1 << 30, d.code),
        )
        lines: List[str] = []
        for d in order:
            lines.append(str(d))
            if carets and self.source and d.pos is not None \
                    and d.pos < len(self.source):
                # pos is a GLOBAL char offset; pipeline strings may span
                # lines, so resolve it to (line, column) before drawing
                before = self.source[:d.pos]
                col = d.pos - (before.rfind("\n") + 1)
                src_line = self.source.splitlines()[before.count("\n")]
                lines.append(f"    {src_line}")
                lines.append(f"    {' ' * col}^")
        n_e, n_w = len(self.errors), len(self.warnings)
        lines.append(f"{n_e} error(s), {n_w} warning(s)")
        return "\n".join(lines)

    def raise_if_errors(self) -> None:
        """One exception carrying EVERY error (the validate=True hook)."""
        if self.errors:
            raise PipelineLintError(self)

    def __str__(self) -> str:
        return self.render()

    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self) -> int:
        return len(self.diagnostics)


class PipelineLintError(ValueError):
    """Raised by Report.raise_if_errors(); carries the full report."""

    def __init__(self, report: Report):
        super().__init__(
            "pipeline failed static analysis:\n" + report.render(carets=False)
        )
        self.report = report
