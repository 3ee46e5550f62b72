"""Finding model shared by the analysis engines.

Port of ``repro.analysis.findings``, unchanged: the same fields, the same
line-number-free fingerprint, so a finding of either package matches the
same baseline entry.  A :class:`Finding` is one rule violation at one
source location.  Its ``fingerprint`` intentionally ignores the line
*number* (only the rule, the file, the enclosing symbol and the stripped
source text participate) so a checked-in baseline survives unrelated
edits that shift lines.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class Finding:
    rule: str               # rule id, e.g. "CA101"
    path: str               # repo-relative posix path
    line: int               # 1-based line number (0 = whole-module/entry)
    message: str            # human explanation of this occurrence
    context: str = ""       # enclosing symbol (function/class qualname,
    #                         or manifest entry name for dispatch findings)
    snippet: str = ""       # stripped source line / aten op text

    def fingerprint(self) -> tuple:
        return (self.rule, self.path, self.context, self.snippet)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        ctx = f" [{self.context}]" if self.context else ""
        out = f"{loc}: {self.rule}{ctx}: {self.message}"
        if self.snippet:
            out += f"\n    {self.snippet}"
        return out


def sort_findings(findings) -> list:
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
