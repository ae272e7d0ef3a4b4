"""Findings baseline / ratchet — ``lint --baseline <file>``.

New interprocedural rules should land STRICT without demanding a
big-bang suppression sweep of pre-existing findings.  The baseline is
the middle path: a checked-in JSON file (``netsdb_tpu_torch/docs/lint_baseline.json``)
recording the findings the team has accepted *for now*.

Ratchet semantics:

* a finding matching a baseline entry is **accepted** — reported as
  baselined, not a failure;
* a finding matching NO entry is **new** — it fails, exactly as
  without a baseline (the ratchet never loosens);
* a baseline entry matching NO finding is **stale** — and a stale
  entry is itself a finding (``stale-baseline``): when a debt item is
  fixed, the baseline must shrink in the same change
  (``--write-baseline`` regenerates it), so the file can only ever
  ratchet toward empty.

Matching is by ``(rule, path, normalized message)`` — line numbers
and other digits are normalized out so unrelated edits shifting a
finding by a few lines don't churn the file; moving a finding to a
different file or changing what it says is a different finding.
Acceptance is COUNTED: an entry records how many occurrences of its
shape were accepted, so adding an Nth+1 duplicate of a baselined
finding still fails, and fixing one of N occurrences makes the entry
stale until the count shrinks.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Tuple

from netsdb_tpu_torch.analysis.lint import REPO, STALE_BASELINE, Diagnostic

_VERSION = 1
_NUM_RE = re.compile(r"\d+")

Fingerprint = Tuple[str, str, str]


def fingerprint(rule: str, path: str, message: str) -> Fingerprint:
    """Line numbers (and every other digit run) normalize to ``N`` so
    the baseline survives unrelated line drift."""
    return (rule, path, _NUM_RE.sub("N", message))


def load(path: str) -> List[Dict[str, str]]:
    """Read a baseline file → its entry list ([] for a missing file —
    an absent baseline accepts nothing, same as no flag)."""
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    entries = payload.get("findings")
    if not isinstance(entries, list):
        raise ValueError(f"{path}: not a lint baseline "
                         f"(no 'findings' list)")
    return entries


def apply(diags: List[Diagnostic], baseline_path: str,
          repo: str = REPO) -> Tuple[List[Diagnostic],
                                     List[Diagnostic]]:
    """Split ``diags`` against the baseline.

    Returns ``(surviving, accepted)`` where ``surviving`` is the
    failures — new findings plus one ``stale-baseline`` diagnostic
    per entry that no longer matches anything — and ``accepted`` is
    the baselined findings (reported, not failed)."""
    entries = load(baseline_path)
    by_fp: Dict[Fingerprint, Dict[str, object]] = {}
    remaining: Dict[Fingerprint, int] = {}
    for e in entries:
        fp = fingerprint(str(e.get("rule", "")),
                         str(e.get("path", "")),
                         str(e.get("message", "")))
        by_fp[fp] = e
        # counted acceptance: one entry absorbs exactly the recorded
        # number of occurrences — an Nth+1 duplicate of a baselined
        # finding shape is a NEW finding, so the ratchet never
        # loosens (entries written before counts existed accept 1)
        remaining[fp] = remaining.get(fp, 0) + int(e.get("count", 1))
    matched: Dict[Fingerprint, int] = {}
    surviving: List[Diagnostic] = []
    accepted: List[Diagnostic] = []
    for d in diags:
        fp = fingerprint(d.rule, d.path, d.message)
        if remaining.get(fp, 0) > 0:
            remaining[fp] -= 1
            matched[fp] = matched.get(fp, 0) + 1
            accepted.append(d)
        else:
            surviving.append(d)
    rel = os.path.relpath(os.path.abspath(baseline_path),
                          repo).replace(os.sep, "/")
    for fp, e in sorted(by_fp.items()):
        left = remaining.get(fp, 0)
        if left <= 0:
            continue
        got = matched.get(fp, 0)
        what = "no longer matches any finding — the debt was paid" \
            if got == 0 else \
            f"records {got + left} occurrence(s) but only {got} " \
            f"remain — part of the debt was paid"
        surviving.append(Diagnostic(
            rule=STALE_BASELINE, path=rel, line=1, col=0,
            message=f"baseline entry {what}; shrink it (rule "
                    f"{e.get('rule')!r} at {e.get('path')!r}: "
                    f"{str(e.get('message', ''))[:120]!r}) or "
                    f"regenerate with --write-baseline"))
    surviving.sort(key=lambda d: (d.path, d.line, d.col, d.rule))
    return surviving, accepted


def write(diags: List[Diagnostic], baseline_path: str) -> int:
    """Record ``diags`` as the new accepted baseline; returns the
    entry count. An empty findings list writes an empty baseline —
    the goal state."""
    by_fp: Dict[Fingerprint, Dict[str, object]] = {}
    order: List[Fingerprint] = []
    for d in sorted(diags, key=lambda d: (d.path, d.rule, d.line)):
        fp = fingerprint(d.rule, d.path, d.message)
        if fp in by_fp:
            by_fp[fp]["count"] = int(by_fp[fp]["count"]) + 1
            continue
        order.append(fp)
        by_fp[fp] = {"rule": d.rule, "path": d.path,
                     "message": d.message, "count": 1}
    entries = [by_fp[fp] for fp in order]
    payload = {"version": _VERSION, "findings": entries}
    with open(baseline_path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    return len(entries)
