"""The port's AST lint framework (``netsdb_tpu_torch/analysis/``):
known-bad fixtures must be detected, known-good fixtures must pass,
suppressions must be honored only when documented, and the CLI surface
must behave (json shape, exit codes, rule listing) — the expectations of
the reference's ``tests/test_analysis.py`` held of the port — plus
finding-for-finding parity with the reference's analyser on every
fixture, and the port's baseline."""

import json
import os

import pytest

from netsdb_tpu_torch.analysis import lint as L
from netsdb_tpu_torch.analysis import run_lint

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "analysis")


def fx(*names):
    return [os.path.join(FIXTURES, n) for n in names]


def rules_of(diags):
    return {d.rule for d in diags}


# --- lock-order -------------------------------------------------------

def test_lock_order_detects_module_level_ab_ba_cycle():
    diags = run_lint(paths=fx("bad_lock_cycle.py"), rules=["lock-order"])
    assert len(diags) == 1
    d = diags[0]
    assert d.rule == "lock-order"
    assert "pool_mu" in d.message and "index_mu" in d.message
    # both edges' sites are named
    assert d.message.count("bad_lock_cycle.py") >= 2


def test_lock_order_sees_call_through_and_alias():
    diags = run_lint(paths=fx("bad_lock_cycle_methods.py"),
                     rules=["lock-order"])
    assert diags, "cycle through call-through + alias went undetected"
    msg = " ".join(d.message for d in diags)
    assert "Engine._sched_lock" in msg
    assert "Engine._wal_mu" in msg


def test_lock_order_passes_consistent_ordering():
    diags = run_lint(paths=fx("good_locks.py"), rules=["lock-order"])
    assert diags == []


def test_lock_order_clean_tree_with_seeds():
    # the REAL tree against the seeded hierarchy: any regression that
    # introduces an inversion (a store lock held across a paged append)
    # becomes a failing edge here
    diags = run_lint(rules=["lock-order"])
    assert diags == [], "\n".join(str(d) for d in diags)


# --- lock-blocking-call ----------------------------------------------

def test_blocking_calls_under_lock_detected():
    diags = run_lint(paths=fx("bad_blocking.py"),
                     rules=["lock-blocking-call"])
    msgs = [d.message for d in diags]
    assert len(diags) == 3
    assert any("recv" in m for m in msgs)
    assert any("device_put" in m for m in msgs)
    assert any("get() without a timeout" in m for m in msgs)
    assert all("state_mu" in m for m in msgs)


def test_bounded_queue_get_not_flagged():
    diags = run_lint(paths=fx("good_locks.py"),
                     rules=["lock-blocking-call"])
    assert diags == []


# --- iter-close -------------------------------------------------------

def test_unclosed_stream_iterators_detected():
    diags = run_lint(paths=fx("bad_unclosed.py"), rules=["iter-close"])
    assert len(diags) == 3
    assert any("stream()" in d.message for d in diags)
    assert any("never closed" in d.message for d in diags)
    # the attribute form (staging.stage_stream) counts as a producer
    assert any("stage_stream" in d.message for d in diags)


def test_ownership_transfer_patterns_pass():
    diags = run_lint(paths=fx("good_closed.py"), rules=["iter-close"])
    assert diags == []


# --- suppressions -----------------------------------------------------

def test_documented_suppressions_silence_findings():
    diags = run_lint(paths=fx("suppressed.py"),
                     rules=["lock-blocking-call", "iter-close"])
    assert diags == [], "\n".join(str(d) for d in diags)


def test_reasonless_suppression_is_a_finding_and_does_not_silence():
    diags = run_lint(paths=fx("bad_suppression.py"))
    got = rules_of(diags)
    assert "bad-suppression" in got  # the reason-less comment itself
    assert "lock-blocking-call" in got  # ... and it silenced nothing


def test_stale_suppression_flagged_on_full_runs_only():
    full = run_lint(paths=fx("bad_suppression.py"))
    assert "unused-suppression" in rules_of(full)
    single = run_lint(paths=fx("bad_suppression.py"),
                      rules=["iter-close"])
    assert "unused-suppression" not in rules_of(single)


def test_typoed_suppression_id_is_flagged_not_silently_dead():
    diags = run_lint(paths=fx("bad_suppression.py"),
                     rules=["iter-close"])
    msgs = [d.message for d in diags if d.rule == "bad-suppression"]
    assert any("iter-closs" in m and "unknown rule" in m for m in msgs)
    # ... and the typo silenced nothing: the finding still fires
    assert any(d.rule == "iter-close" for d in diags)


# --- framework surface ------------------------------------------------

def test_unknown_rule_id_raises():
    with pytest.raises(ValueError, match="unknown rule"):
        run_lint(rules=["no-such-rule"])


def test_diagnostics_sorted_and_json_shape():
    diags = run_lint(paths=fx("bad_blocking.py", "bad_unclosed.py"))
    keys = [(d.path, d.line, d.col, d.rule) for d in diags]
    assert keys == sorted(keys)
    payload = L.to_json(diags)
    base = {"rule", "path", "line", "col", "message"}
    # "suggestion" rides only findings with a rendered remedy diff
    assert all(set(d) in (base, base | {"suggestion"})
               for d in payload)
    json.dumps(payload)  # round-trips


def test_every_rule_has_id_and_rationale():
    rules = L.all_rules()
    assert len(rules) >= 14
    for rule in rules:
        assert rule.id and rule.rationale, rule


def test_parse_error_is_a_diagnostic(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def broken(:\n")
    diags = run_lint(paths=[str(bad)], repo=str(tmp_path))
    assert [d.rule for d in diags].count("parse-error") == 1


# --- cli --------------------------------------------------------------

def test_cli_lint_json_and_exit_codes(capsys):
    from netsdb_tpu_torch.cli import main

    rc = main(["lint", "--json",
               os.path.join(FIXTURES, "bad_blocking.py")])
    out = capsys.readouterr().out
    assert rc == 1
    payload = json.loads(out)
    assert any(d["rule"] == "lock-blocking-call" for d in payload)

    rc = main(["lint", "--json",
               os.path.join(FIXTURES, "good_locks.py"),
               "--rule", "lock-order", "--rule", "lock-blocking-call"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out) == []

    assert main(["lint", "--rule", "bogus"]) == 2


def test_cli_list_rules(capsys):
    from netsdb_tpu_torch.cli import main

    assert main(["lint", "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "lock-order" in out and "iter-close" in out


# --- docs drift -------------------------------------------------------

def test_analysis_docs_catalog_in_sync():
    diags = run_lint(rules=["analysis-docs-drift"])
    assert diags == [], "\n".join(str(d) for d in diags)


def test_docs_drift_detects_missing_row(tmp_path, monkeypatch):
    # a repo whose ANALYSIS.md lacks every row: one finding per rule
    docs = tmp_path / "netsdb_tpu_torch" / "docs"
    docs.mkdir(parents=True)
    (docs / "ANALYSIS.md").write_text(
        "| id |\n|---|\n| `lock-order` |\n| `ghost-rule` |\n")
    src = tmp_path / "empty.py"
    src.write_text("x = 1\n")
    diags = run_lint(paths=[str(src)], rules=["analysis-docs-drift"],
                     repo=str(tmp_path))
    msgs = " ".join(d.message for d in diags)
    assert "ghost-rule" in msgs  # documented but unregistered
    assert "iter-close" in msgs  # registered but undocumented


# ------------------------------------------------------------- lint --fix
def _copy_fixture(tmp_path, name="bad_unclosed.py"):
    import shutil

    dst = tmp_path / name
    shutil.copy(os.path.join(FIXTURES, name), dst)
    return str(dst)


def test_fix_wraps_direct_for_in_closing(tmp_path):
    from netsdb_tpu_torch.analysis import fix as F
    from netsdb_tpu_torch.analysis.lint import run_lint

    path = _copy_fixture(tmp_path)
    res = F.run_fix(paths=[path])
    assert res["fixed"] == 1 and res["files"]
    src = open(path, encoding="utf-8").read()
    assert "with contextlib.closing(pc.stream()) as _closing_stream:" \
        in src
    assert "import contextlib" in src
    import py_compile

    py_compile.compile(path, doraise=True)
    # the direct-for finding is gone; the assignment findings (which
    # need a human-chosen try/finally extent) remain reported
    diags = run_lint(paths=[path], rules=["iter-close"],
                     select_all=True)
    assert all("iterating" not in d.message for d in diags)
    assert len(diags) == 2


def test_fix_is_idempotent(tmp_path):
    from netsdb_tpu_torch.analysis import fix as F

    path = _copy_fixture(tmp_path)
    first = F.run_fix(paths=[path])
    assert first["fixed"] == 1
    src1 = open(path, encoding="utf-8").read()
    second = F.run_fix(paths=[path])
    assert second["fixed"] == 0 and not second["files"]
    assert open(path, encoding="utf-8").read() == src1


def test_fix_dry_run_prints_diff_touches_nothing(tmp_path):
    from netsdb_tpu_torch.analysis import fix as F

    path = _copy_fixture(tmp_path)
    before = open(path, encoding="utf-8").read()
    res = F.run_fix(paths=[path], dry_run=True)
    assert res["fixed"] == 1
    assert "+    with contextlib.closing(pc.stream())" in res["diff"]
    assert "-    for chunk, valid, _start in pc.stream():" in res["diff"]
    assert open(path, encoding="utf-8").read() == before


def test_fix_skips_multiline_string_bodies(tmp_path):
    from netsdb_tpu_torch.analysis import fix as F

    path = tmp_path / "ml.py"
    path.write_text(
        "def f(pc):\n"
        "    for c in pc.stream():\n"
        "        s = \"\"\"a\n"
        "multi-line literal the rewriter must not re-indent\n"
        "\"\"\"\n"
        "        print(s, c)\n")
    res = F.run_fix(paths=[str(path)])
    assert res["fixed"] == 0 and res["skipped"] == 1


def test_cli_lint_fix_dry_run(tmp_path, capsys):
    from netsdb_tpu_torch import cli

    path = _copy_fixture(tmp_path)
    rc = cli.main(["lint", "--fix", "--dry-run", path])
    out_text = capsys.readouterr().out
    assert "lint --fix --dry-run: 1 fix(es)" in out_text
    assert "+    with contextlib.closing" in out_text
    assert rc == 0


def test_whole_tree_has_no_fixable_findings():
    """The package tree itself must stay clean under the fixer — a
    flagged direct-for would mean a regression the gate (and --fix)
    would both catch."""
    from netsdb_tpu_torch.analysis import fix as F

    res = F.run_fix(dry_run=True)
    assert res["fixed"] == 0, res["files"]


def test_fix_nested_flagged_loops_inside_out(tmp_path):
    """Review regression: a flagged producer-for nested inside another
    flagged producer-for fixes inside-out across passes — the outer
    rewrite must never slice with stale line numbers."""
    from netsdb_tpu_torch.analysis import fix as F
    from netsdb_tpu_torch.analysis.lint import run_lint

    path = tmp_path / "nested.py"
    path.write_text(
        "def f(pc, qc):\n"
        "    total = 0\n"
        "    for a in pc.stream_tables():\n"
        "        for b in qc.stream_tables():\n"
        "            total += 1\n"
        "        total += 10\n"
        "    return total\n")
    res = F.run_fix(paths=[str(path)])
    assert res["fixed"] == 2, res
    import py_compile

    py_compile.compile(str(path), doraise=True)
    src = path.read_text()
    # the outer body's trailing statement stayed inside the loop
    assert src.count("with contextlib.closing(") == 2
    diags = run_lint(paths=[str(path)], rules=["iter-close"],
                     select_all=True)
    assert diags == []
    ns = {}
    exec(compile(src, str(path), "exec"), ns)

    class _It:
        def __init__(self, n):
            self._it = iter(range(n))

        def __iter__(self):
            return self._it

        def close(self):
            pass

    class _S:
        def __init__(self, n):
            self._n = n

        def stream_tables(self):
            return _It(self._n)

    # semantics preserved: 3 outer x (2 inner + 10)
    assert ns["f"](_S(3), _S(2)) == 36


# ------------------------------------------------------- suggestion diffs
def test_assigned_never_closed_carries_suggestion_diff():
    diags = run_lint(paths=fx("bad_unclosed.py"), rules=["iter-close"],
                     select_all=True)
    assigned = [d for d in diags if "never closed" in d.message]
    assert assigned and all(d.suggestion for d in assigned)
    sug = next(d.suggestion for d in assigned
               if "it = " in d.suggestion)
    # the rendered remedy: try around the rest of the block, close in
    # a finally — a unified diff a human applies, not an auto-fix
    assert "+    try:" in sug
    assert "+    finally:" in sug
    assert "+        it.close()" in sug
    assert "-    return next(iter(it))" in sug
    assert "+        return next(iter(it))" in sug


def test_suggestion_rides_json_not_text_output(capsys):
    from netsdb_tpu_torch.cli import main

    rc = main(["lint", "--json", "--rule", "iter-close",
               os.path.join(FIXTURES, "bad_unclosed.py")])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    assert any("suggestion" in d and "finally:" in d["suggestion"]
               for d in payload)


def test_suggestion_skips_when_nothing_follows(tmp_path):
    from netsdb_tpu_torch.analysis.fix import suggest_close
    from netsdb_tpu_torch.analysis.lint import Module

    p = tmp_path / "tail.py"
    p.write_text("def f(pc):\n    it = pc.stream()\n")
    mod = Module(str(p), repo=str(tmp_path))
    import ast

    call = next(n for n in ast.walk(mod.tree)
                if isinstance(n, ast.Call))
    assert suggest_close(mod, "it", call) is None


def test_suggestion_skips_when_handle_escapes(tmp_path):
    """Review regression: closing a RETURNED iterator in a finally
    would hand the caller a dead handle — no suggestion for escaping
    handles (returned, yielded, aliased), while derived-value returns
    (`return next(iter(it))`) still get one."""
    from netsdb_tpu_torch.analysis.fix import suggest_close
    from netsdb_tpu_torch.analysis.lint import Module
    import ast

    def first_call(mod):
        return next(n for n in ast.walk(mod.tree)
                    if isinstance(n, ast.Call))

    for body in ("    return it\n",
                 "    yield it\n",
                 "    alias = it\n",
                 "    self.it = it\n",
                 "    return {'k': it}\n",
                 "    register(it)\n",
                 "    self.cache.append(it)\n",
                 "    return enumerate(it)\n",   # lazy rewrapper
                 "    return map(str, it)\n",
                 "    return (x for x in it)\n",  # lazy genexp
                 "    wrapped = iter(it)\n"):
        p = tmp_path / "esc.py"
        p.write_text("def f(self, pc):\n    it = pc.stream()\n"
                     + body)
        mod = Module(str(p), repo=str(tmp_path))
        assert suggest_close(mod, "it", first_call(mod)) is None, body
    for body in ("    return next(iter(it))\n",   # eager outermost
                 "    return list(map(str, it))\n",
                 "    rows = [r for r in it]\n"
                 "    print(len(rows))\n"):       # eager comprehension
        p = tmp_path / "esc.py"
        p.write_text("def f(pc):\n    it = pc.stream()\n" + body)
        mod = Module(str(p), repo=str(tmp_path))
        assert suggest_close(mod, "it", first_call(mod)) \
            is not None, body


# ------------------------------------------------------- baseline ratchet
def test_baseline_accepts_recorded_findings(tmp_path, capsys):
    from netsdb_tpu_torch.cli import main

    bad = os.path.join(FIXTURES, "bad_blocking.py")
    base = str(tmp_path / "baseline.json")
    rc = main(["lint", bad, "--baseline", base, "--write-baseline"])
    assert rc == 0
    capsys.readouterr()
    # recorded findings are accepted → clean exit, reported as such
    rc = main(["lint", bad, "--baseline", base])
    out = capsys.readouterr().out
    assert rc == 0
    assert "baselined" in out


def test_baseline_new_findings_still_fail(tmp_path, capsys):
    from netsdb_tpu_torch.cli import main

    bad = os.path.join(FIXTURES, "bad_blocking.py")
    base = str(tmp_path / "baseline.json")
    main(["lint", bad, "--baseline", base, "--write-baseline"])
    capsys.readouterr()
    # a file with findings NOT in the baseline: the ratchet holds
    rc = main(["lint", bad, os.path.join(FIXTURES, "bad_unclosed.py"),
               "--baseline", base, "--json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert all(d["path"].endswith("bad_unclosed.py")
               for d in payload), payload


def test_baseline_stale_entry_is_itself_a_finding(tmp_path, capsys):
    from netsdb_tpu_torch.cli import main

    bad = os.path.join(FIXTURES, "bad_blocking.py")
    good = os.path.join(FIXTURES, "good_locks.py")
    base = str(tmp_path / "baseline.json")
    main(["lint", bad, "--baseline", base, "--write-baseline"])
    capsys.readouterr()
    # the debt was "fixed" (finding gone) but the baseline still
    # records it: stale entries fail until the file shrinks
    rc = main(["lint", good, "--baseline", base, "--json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert payload and all(d["rule"] == "stale-baseline"
                           for d in payload)
    # ... and --write-baseline shrinks it back to empty
    rc = main(["lint", good, "--baseline", base, "--write-baseline"])
    assert rc == 0
    capsys.readouterr()
    assert main(["lint", good, "--baseline", base]) == 0


def test_baseline_acceptance_is_counted(tmp_path):
    """Review regression: one baseline entry must not absorb an
    unlimited number of same-shape findings — the Nth+1 duplicate is
    NEW debt and fails the ratchet."""
    from netsdb_tpu_torch.analysis import baseline as B
    from netsdb_tpu_torch.analysis.lint import Diagnostic

    d = Diagnostic(rule="lock-blocking-call", path="m.py", line=10,
                   col=0, message="blocking call recv() at m.py:10")
    base = str(tmp_path / "b.json")
    B.write([d], base)
    dup = Diagnostic(rule="lock-blocking-call", path="m.py", line=90,
                     col=0, message="blocking call recv() at m.py:90")
    surviving, accepted = B.apply([d, dup], base)
    assert len(accepted) == 1 and len(surviving) == 1
    # ... and fixing one of N recorded occurrences goes stale
    B.write([d, dup], base)
    surviving, accepted = B.apply([d], base)
    assert len(accepted) == 1
    assert [s.rule for s in surviving] == ["stale-baseline"]
    assert "only 1 remain" in surviving[0].message


def test_write_baseline_requires_baseline_flag(capsys):
    from netsdb_tpu_torch.cli import main

    rc = main(["lint", "--write-baseline",
               os.path.join(FIXTURES, "good_locks.py")])
    assert rc == 2
    assert "--write-baseline requires --baseline" \
        in capsys.readouterr().err


def test_baseline_survives_line_drift(tmp_path):
    from netsdb_tpu_torch.analysis import baseline as B
    from netsdb_tpu_torch.analysis.lint import Diagnostic

    d1 = Diagnostic(rule="lock-blocking-call", path="m.py", line=10,
                    col=0, message="blocking call recv() at m.py:10")
    base = str(tmp_path / "b.json")
    B.write([d1], base)
    drifted = Diagnostic(rule="lock-blocking-call", path="m.py",
                         line=14, col=0,
                         message="blocking call recv() at m.py:14")
    surviving, accepted = B.apply([drifted], base)
    assert surviving == [] and accepted == [drifted]


def test_checked_in_baseline_holds_only_the_store_uploads():
    # the port's accepted debt: the store's synchronous uploads under
    # SetStore._lock (netsdb_tpu_torch/docs/ANALYSIS.md) and nothing else
    from netsdb_tpu_torch.analysis import baseline as B
    from netsdb_tpu_torch.analysis.lint import PKG_DIR

    entries = B.load(os.path.join(PKG_DIR, "docs", "lint_baseline.json"))
    assert entries and all(
        e["rule"] == "lock-blocking-call"
        and e["path"] == "netsdb_tpu_torch/storage/store.py"
        and "SetStore._lock" in e["message"]
        and "a synchronous upload" in e["message"] for e in entries)


# ------------------------------------------------------- parse-once cache
def test_project_cache_reuses_unchanged_modules():
    from netsdb_tpu_torch.analysis.lint import load_project

    p1 = load_project(paths=fx("good_locks.py"))
    p2 = load_project(paths=fx("good_locks.py"))
    assert p1.modules[0] is p2.modules[0]  # same parsed Module


def test_project_cache_invalidates_on_content_change(tmp_path):
    # deliberately NO sleep: a same-size rewrite inside the
    # filesystem timestamp granularity must still invalidate (the
    # cache verifies content on a stat-key hit)
    from netsdb_tpu_torch.analysis.lint import load_project

    p = tmp_path / "m.py"
    p.write_text("x = 1\n")
    m1 = load_project(paths=[str(p)], repo=str(tmp_path)).modules[0]
    p.write_text("x = 2\n")
    m2 = load_project(paths=[str(p)], repo=str(tmp_path)).modules[0]
    assert m1 is not m2 and m2.source == "x = 2\n"


def test_cached_module_resets_suppression_accounting():
    # run 1 marks the fixture's suppressions used; a cached reuse must
    # start clean or unused-suppression accounting would lie
    first = run_lint(paths=fx("suppressed.py"))
    second = run_lint(paths=fx("suppressed.py"))
    assert rules_of(first) == rules_of(second)


def test_fix_skips_multiline_bytes_and_fstrings(tmp_path):
    from netsdb_tpu_torch.analysis import fix as F

    path = tmp_path / "mlb.py"
    path.write_text(
        "def f(pc):\n"
        "    for c in pc.stream():\n"
        "        payload = b\"\"\"ab\n"
        "cd\"\"\"\n"
        "        print(payload, c)\n")
    res = F.run_fix(paths=[str(path)])
    assert res["fixed"] == 0 and res["skipped"] == 1


def test_fix_import_check_is_module_scope(tmp_path):
    """A function-local `import contextlib` (or docstring text) must
    not satisfy the module-level import the rewrite references."""
    from netsdb_tpu_torch.analysis import fix as F

    path = tmp_path / "localimp.py"
    path.write_text(
        '"""docstring mentioning import contextlib in prose."""\n'
        "def g():\n"
        "    import contextlib\n"
        "    return contextlib\n"
        "def f(pc):\n"
        "    for c in pc.stream():\n"
        "        print(c)\n")
    res = F.run_fix(paths=[str(path)])
    assert res["fixed"] == 1
    src = path.read_text()
    lines = src.splitlines()
    # a top-level import was inserted (after the docstring)
    assert "import contextlib" in [ln.strip() for ln in lines
                                   if not ln.startswith((" ", "\t"))]
    ns = {}
    exec(compile(src, str(path), "exec"), ns)

    class _It:
        def __iter__(self):
            return iter([1])

        def close(self):
            pass

    class _S:
        def stream(self):
            return _It()

    ns["f"](_S())  # no NameError


# ------------------------------------------ parity with the reference
#: where the two analysers' messages may differ, and how: the port
#: names its own upload (``device_put`` is one of the forms it matches)
#: and its own package paths and seeded ranks. Each pair maps the
#: reference's text to the port's.
MESSAGE_SUBSTITUTIONS = (
    ("direct device_put (call)", "direct upload (call device_put)"),
    ("netsdb_tpu/", "netsdb_tpu_torch/"),
)


def _fixture_sets():
    names = sorted(n for n in os.listdir(FIXTURES) if n.endswith(".py"))
    return [[n] for n in names] + [["xmod_inv_a.py", "xmod_inv_b.py"]]


@pytest.mark.parametrize("select_all", [False, True])
@pytest.mark.parametrize("names", _fixture_sets(),
                         ids=lambda ns: "+".join(ns))
def test_fixture_findings_match_the_reference(names, select_all):
    """The same explicit paths through both analysers, every rule (and,
    with ``select_all``, every rule over every fixture whatever its
    scope): the same ``(rule, path, line, col)`` set, and the same
    messages after the listed substitutions."""
    from netsdb_tpu.analysis import run_lint as ref_run_lint

    ref = ref_run_lint(paths=fx(*names), select_all=select_all)
    port = run_lint(paths=fx(*names), select_all=select_all)

    def keyed(diags):
        return {(d.rule, d.path, d.line, d.col): d.message for d in diags}

    want, got = keyed(ref), keyed(port)
    assert set(got) == set(want)
    for key, msg in want.items():
        for old, new in MESSAGE_SUBSTITUTIONS:
            msg = msg.replace(old, new)
        assert got[key] == msg, key
    assert [d.suggestion for d in port] == [d.suggestion for d in ref]
