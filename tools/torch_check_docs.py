#!/usr/bin/env python
"""Docs drift gate for the port: its documented sweeps must stay real.

The counterpart of ``tools/check_docs.py`` for ``repro_torch``.  Two
checks over README.md and ROADMAP.md (or the files given):

1. every ``--grid NAME`` mentioned anywhere must name a registered grid
   or suite of ``repro_torch.experiments.grids``;
2. every documented ``python -m repro_torch.experiments ...`` command line
   (in fenced code blocks or inline code spans) must parse against the
   port's CLI parser (``repro_torch.experiments.cli.build_parser``): a
   ``--help``-level smoke test with no simulation run.

Snippets holding an obvious placeholder (``<suite>``, ``...``, ``{a,b}``,
``a | b``) are skipped as templates.  The gate also holds a floor on how
many lines and names it found, so that a broken extractor cannot turn the
check into a no-op.

Usage: python tools/torch_check_docs.py [FILE ...]
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path
from typing import List, Optional, Tuple

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

DOC_FILES = ["README.md", "ROADMAP.md"]

# a documented line found fewer times than this means the extractor broke
MIN_CLI_LINES = 5
MIN_GRID_MENTIONS = 5

_GRID_RE = re.compile(r"--grid[= ]+(\S+)")
_CLI_RE = re.compile(r"python -m repro_torch\.experiments(?:\s|$)")
_FENCE_RE = re.compile(r"^```")
_INLINE_RE = re.compile(r"`([^`]+)`", re.S)


def _is_template(snippet: str) -> bool:
    return any(tok in snippet for tok in ("<", ">", "...", "…", "{", "}", " | "))


def _code_snippets(text: str) -> List[str]:
    """Lines of fenced code blocks and whitespace-normalised inline spans;
    shell comments stripped, ``\\`` continuations folded, fenced blocks
    taken out before the inline spans are matched."""
    out: List[str] = []
    prose: List[str] = []
    in_fence = False
    for line in text.splitlines():
        if _FENCE_RE.match(line.strip()):
            in_fence = not in_fence
            continue
        if in_fence:
            stripped = line.split(" #")[0].strip()
            if out and out[-1].endswith("\\"):
                out[-1] = out[-1][:-1].rstrip() + " " + stripped
            else:
                out.append(stripped)
        else:
            prose.append(line)
    for m in _INLINE_RE.finditer("\n".join(prose)):
        out.append(" ".join(m.group(1).split()))
    return out


def check_text(name: str, text: str, known: set, parser) -> Tuple[List[str], int, int]:
    """(failures, --grid mentions, CLI lines) of one document."""
    failures: List[str] = []
    n_grids = n_lines = 0
    for m in _GRID_RE.finditer(text):
        tok = m.group(1)
        if _is_template(tok):
            continue
        word = re.match(r"[\w.-]+", tok)
        grid = word.group(0) if word else tok
        n_grids += 1
        if grid not in known:
            failures.append(f"{name}: `--grid {grid}` is not a registered grid or suite "
                            f"of repro_torch.experiments")
    for snippet in _code_snippets(text):
        m = _CLI_RE.search(snippet)
        if not m or _is_template(snippet):
            continue
        argv = snippet[m.end():].split()
        if not argv:
            continue
        n_lines += 1
        try:
            parser.parse_args(argv)
        except SystemExit as e:
            if e.code not in (0, None):
                failures.append(f"{name}: CLI line does not parse: {snippet}")
    return failures, n_grids, n_lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/torch_check_docs.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="*", help=f"documents to check (default: {DOC_FILES})")
    args = ap.parse_args(argv)

    from repro_torch.experiments import grids
    from repro_torch.experiments.cli import build_parser

    known = set(grids.GRIDS) | set(grids.SUITES)
    parser = build_parser()
    failures: List[str] = []
    total_grids = total_lines = 0
    for f in args.files or [str(REPO / rel) for rel in DOC_FILES]:
        path = Path(f)
        if not path.exists():
            failures.append(f"{path}: documented file is missing")
            continue
        fails, n_grids, n_lines = check_text(path.name, path.read_text(), known, parser)
        failures.extend(fails)
        total_grids += n_grids
        total_lines += n_lines
        print(f"{path.name}: {n_grids} --grid mention(s), {n_lines} CLI line(s) checked")
    if total_lines < MIN_CLI_LINES:
        failures.append(f"extractor found only {total_lines} CLI lines (< {MIN_CLI_LINES}); "
                        f"the docs check may have rotted")
    if total_grids < MIN_GRID_MENTIONS:
        failures.append(f"extractor found only {total_grids} --grid mentions "
                        f"(< {MIN_GRID_MENTIONS}); the docs check may have rotted")
    if failures:
        print()
        for f in failures:
            print(f"FAIL: {f}")
        return 1
    print(f"docs OK: {total_grids} grid mentions and {total_lines} CLI lines resolve "
          f"against repro_torch.experiments")
    return 0


if __name__ == "__main__":
    sys.exit(main())
