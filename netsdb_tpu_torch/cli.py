"""Operator CLI — the port's ``netsdb_tpu/cli.py``: the reference's
binaries + scripts layer, collapsed, with the same subcommands, flags
and printed JSON.

    python -m netsdb_tpu_torch info                 # devices (ResourceManager)
    python -m netsdb_tpu_torch pdml PROG.pdml       # run a LA DSL program
    python -m netsdb_tpu_torch demo-ff [...]        # FFTest.cc equivalent
    python -m netsdb_tpu_torch tpch [--query q01]   # TPC-H demo queries
    python -m netsdb_tpu_torch selftest             # integratedTests.py
    python -m netsdb_tpu_torch serve --port 8108    # the resident daemon
    python -m netsdb_tpu_torch obs --addr H:P       # a daemon's readouts
    python -m netsdb_tpu_torch micro-bench [--only n]  # serviceBenchmarks
    python -m netsdb_tpu_torch serve-bench [--scale]   # serving benches
    python -m netsdb_tpu_torch lint [--json]        # the static analysis

Every command runs on the card unless asked for the CPU: the reference
chooses its platform through ``JAX_PLATFORMS`` (and ``serve
--platform``); here one top-level ``--device`` (default ``cuda``) goes
to every command's client or daemon, and ``serve --platform cpu`` maps
to it. Without a card and without ``--device cpu`` a command fails (it
never carries on on the CPU). ``lint`` touches no device and runs
anywhere. ``bench`` belongs to a later ROADMAP.md item and exits
non-zero naming it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _client(args, config=None):
    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.config import Configuration

    return Client(config if config is not None else Configuration(),
                  device=args.device)


def _cmd_info(args) -> int:
    from netsdb_tpu_torch.config import resolve_device
    from netsdb_tpu_torch.parallel.distributed import cluster_info

    dev = resolve_device(args.device)
    info = cluster_info(dev.type)
    info["backend"] = dev.type
    print(json.dumps(info, indent=2))
    return 0


def _later(what: str, item: str) -> int:
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md {item}")


def _cmd_bench(args) -> int:
    return _later("the benchmark harness (bench)", "A9")


def _bench_positions(device):
    """The mesh the shuffle and SUMMA benches run over: the visible
    positions of ``device``'s type when there are at least two, else 4
    virtual positions of the one device (the reference forces 4 host
    devices for ``--summa`` the same way)."""
    import contextlib

    from netsdb_tpu_torch.config import resolve_device
    from netsdb_tpu_torch.parallel.mesh import (virtual_devices,
                                                visible_devices)

    dev = resolve_device(device)
    if len(visible_devices(dev.type)) >= 2:
        return contextlib.nullcontext()
    return virtual_devices(4, dev)


_MICRO_MODES = (("staging", "bench_staging"),
                ("bucket_sweep", "bench_bucket_sweep"),
                ("obs_overhead", "bench_obs_overhead"),
                ("explain_overhead", "bench_explain_overhead"),
                ("lint_overhead", "bench_lint_overhead"),
                ("fusion", "bench_fusion"), ("summa", "bench_summa"))


def _cmd_micro_bench(args) -> int:
    from netsdb_tpu_torch.workloads import micro_bench

    with _bench_positions(args.device):
        for flag, fn in _MICRO_MODES:
            if getattr(args, flag, False):
                out = getattr(micro_bench, fn)(device=args.device)
                print(json.dumps(out, indent=2, default=str))
                return 0
        names = None
        if args.only is not None:
            names = [n.strip() for n in args.only.split(",") if n.strip()]
            if not names:
                print(f"--only given but no benchmark names; available: "
                      f"{', '.join(micro_bench.BENCHMARKS)}",
                      file=sys.stderr)
                return 2
            unknown = [n for n in names if n not in micro_bench.BENCHMARKS]
            if unknown:
                print(f"unknown benchmark(s) {unknown}; available: "
                      f"{', '.join(micro_bench.BENCHMARKS)}",
                      file=sys.stderr)
                return 2
        micro_bench.run_all(names=names, device=args.device)
    return 0


def _cmd_serve_bench(args) -> int:
    from netsdb_tpu_torch.workloads import serve_bench as sb

    device = args.device
    if getattr(args, "fusion_distributed", False):
        out = sb.run_fusion_distributed_bench(
            daemons=getattr(args, "daemons", 4), device=device)
    elif getattr(args, "scale", False):
        out = sb.run_scaleout_bench(daemons=getattr(args, "daemons", 4),
                                    device=device)
    elif getattr(args, "rebalance", False):
        out = sb.run_rebalance_bench(daemons=getattr(args, "daemons", 4),
                                     device=device)
    elif getattr(args, "scheduler", False):
        out = sb.run_scheduler_bench(
            clients=args.clients if args.clients is not None else 8,
            device=device)
    elif getattr(args, "partial_cache", False):
        out = sb.run_partial_cache_bench(device=device)
    elif getattr(args, "device_cache", False):
        out = sb.run_device_cache_bench(device=device)
    elif getattr(args, "data_plane", False):
        out = sb.run_data_plane_bench(table_mb=args.table_mb, device=device)
    else:
        out = sb.run_serve_bench(clients=args.clients
                                 if args.clients is not None else 2,
                                 jobs_per_client=args.jobs,
                                 batch=args.batch, port=args.port,
                                 platform=args.platform, device=device)
    print(json.dumps(out, indent=2))
    return 0


def _cmd_lint(args) -> int:
    """``lint`` — the one static-analysis entry point the tests and
    humans share (``netsdb_tpu_torch/analysis/``): file:line:col
    diagnostics over the port's own tree, ``--json`` for scripting,
    exit 1 on any finding. It touches no device, so it runs with or
    without a card and needs no ``--device cpu``."""
    from netsdb_tpu_torch.analysis import lint as L

    if args.list_rules:
        for rule in L.all_rules():
            print(f"{rule.id:<22} {rule.rationale}")
        return 0
    if args.witness_coverage:
        from netsdb_tpu_torch.analysis import witnesscov as W

        try:
            dyn = W.load_witness_dump(args.witness_coverage)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"witness-coverage: cannot read "
                  f"{args.witness_coverage}: {e}", file=sys.stderr)
            return 2
        report = W.coverage(dyn)
        if args.json:
            print(json.dumps(report, indent=2))
        else:
            print(W.render(report))
        return 0  # a coverage REPORT, not a gate: no false failures
    if args.fix:
        from netsdb_tpu_torch.analysis import fix as F

        res = F.run_fix(paths=args.paths or None, dry_run=args.dry_run)
        if args.dry_run:
            if res["diff"]:
                print(res["diff"], end="")
            print(f"lint --fix --dry-run: {res['fixed']} fix(es) in "
                  f"{len(res['files'])} file(s), {res['skipped']} "
                  f"skipped (safety gates)")
            return 0
        print(f"lint --fix: applied {res['fixed']} fix(es) in "
              f"{len(res['files'])} file(s), {res['skipped']} "
              f"skipped (safety gates)")
        for rel in res["files"]:
            print(f"  fixed: {rel}")
        # fall through: report what remains after the rewrite
    if args.write_baseline and not args.baseline:
        print("--write-baseline requires --baseline FILE (where to "
              "record the accepted findings)", file=sys.stderr)
        return 2
    try:
        diags = L.run_lint(paths=args.paths or None,
                           rules=args.rule or None)
    except ValueError as e:  # unknown rule id
        print(str(e), file=sys.stderr)
        return 2
    accepted = []
    if args.baseline:
        from netsdb_tpu_torch.analysis import baseline as B

        if args.write_baseline:
            n = B.write(diags, args.baseline)
            print(f"lint: wrote {n} accepted finding(s) to "
                  f"{args.baseline}")
            return 0
        diags, accepted = B.apply(diags, args.baseline)
    if args.json:
        print(json.dumps(L.to_json(diags), indent=2))
    else:
        for d in diags:
            print(str(d))
        tail = f", {len(accepted)} baselined" if accepted else ""
        print(f"lint: {'FAIL' if diags else 'ok'} "
              f"({len(diags)} finding(s), "
              f"{len(L.rule_ids())} rule(s){tail})")
    return 1 if diags else 0


def _cmd_pdml(args) -> int:
    from netsdb_tpu_torch.dsl import run_pdml

    with open(args.file) as f:
        text = f.read()
    env = run_pdml(text, client=_client(args))
    for name, tensor in env.items():
        print(f"{name}: shape={tensor.shape} block={tensor.meta.block_shape}")
        if args.print_values:
            print(tensor.to_dense().cpu().numpy())
    return 0


def _cmd_demo_ff(args) -> int:
    import numpy as np

    from netsdb_tpu_torch.models.ff import FFModel

    client = _client(args)
    block = (args.block, args.block)
    model = FFModel(block=block)
    model.setup(client)
    model.load_random_weights(client, args.features, args.hidden, args.labels)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((args.batch, args.features)).astype(np.float32)
    model.load_inputs(client, x)
    t0 = time.perf_counter()
    out = model.inference(client)
    probs = out.to_dense().cpu().numpy()
    dt = time.perf_counter() - t0
    print(json.dumps({
        "batch": args.batch, "features": args.features,
        "hidden": args.hidden, "labels": args.labels,
        "output_shape": list(probs.shape),
        "cols_sum_to_one": bool(np.allclose(probs.sum(0), 1.0, atol=1e-3)),
        "elapsed_s": round(dt, 4),
    }))
    return 0


def _cmd_tpch(args) -> int:
    from netsdb_tpu_torch.workloads import tpch

    client = _client(args)
    tpch.load_tables(client, scale=args.scale)
    queries = [args.query] if args.query else list(tpch.QUERIES)
    for q in queries:
        t0 = time.perf_counter()
        rows = tpch.run_query(client, q)
        dt = time.perf_counter() - t0
        n = len(rows) if hasattr(rows, "__len__") else 1
        print(f"{q}: {n} rows in {dt*1e3:.1f} ms")
        if args.print_values:
            print(rows)
    return 0


def _cmd_tpch_bench(args) -> int:
    """Columnar TPC-H on the device at dbgen scale — the perf counterpart
    of ``tpch``."""
    from netsdb_tpu_torch.relational import bench

    res = bench.main(sf=args.sf, iters=args.iters, device=args.device)
    print(json.dumps(res, indent=2))
    return 0


def _cmd_transformer_bench(args) -> int:
    from netsdb_tpu_torch.workloads.transformer_bench import (
        bench_transformer_layer)

    print(json.dumps(bench_transformer_layer(
        seq_lens=tuple(args.seq), batch=args.batch, embed=args.embed,
        heads=args.heads, device=args.device)))
    return 0


def _cmd_reddit_bench(args) -> int:
    from netsdb_tpu_torch.workloads.reddit_columnar import (
        bench_label_propagation)

    print(json.dumps(bench_label_propagation(rows=args.rows,
                                             n_authors=args.authors,
                                             device=args.device)))
    return 0


def _cmd_ooc_bench(args) -> int:
    from netsdb_tpu_torch.relational.outofcore import bench_out_of_core

    print(json.dumps(bench_out_of_core(rows=args.rows,
                                       pool_bytes=args.pool_mb << 20,
                                       device=args.device)))
    return 0


def _cmd_paged_api_bench(args) -> int:
    from netsdb_tpu_torch.relational.outofcore import bench_paged_set_api

    print(json.dumps(bench_paged_set_api(rows=args.rows,
                                         pool_bytes=args.pool_mb << 20,
                                         device=args.device),
                     default=str))
    return 0


def _cmd_lsh_bench(args) -> int:
    from netsdb_tpu_torch.dedup.lsh import bench_lsh_zoo

    print(json.dumps(bench_lsh_zoo(n_models=args.models,
                                   device=args.device)))
    return 0


def _cmd_ab_bench(args) -> int:
    from netsdb_tpu_torch.learning.ab_bench import bench_placement_ab

    print(json.dumps(bench_placement_ab(rounds=args.rounds,
                                        advisor_kind=args.advisor,
                                        device=args.device)))
    return 0


def _cmd_autotune(args) -> int:
    """Measure the physical-strategy crossovers on the device and
    persist them per device kind (the planner reads them back;
    ``netsdb_tpu_torch.relational.tuning``)."""
    from netsdb_tpu_torch.config import resolve_device
    from netsdb_tpu_torch.relational import tuning

    dev = resolve_device(args.device)
    measured = tuning.autotune(device=dev, persist=not args.no_persist)
    print(json.dumps({"device_kind": tuning.device_kind(dev), **measured}))
    return 0


def _cmd_selftest(args) -> int:
    """Scripted integration sequence — the reference's
    ``scripts/integratedTests.py:72-240`` (boot pseudo-cluster, then run
    selection, aggregation, LDA, FF, LSTM programs checking exit codes).
    Here: the same workload sequence in-process on ``--device``, each
    step validated; any failed step makes the command exit 1."""
    import tempfile

    import numpy as np
    import torch

    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.config import Configuration

    device = args.device
    client = _client(args)
    dev = client.device
    rng = np.random.default_rng(0)
    failures = []

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def check(cond, what):
        # explicit raise (not assert): must still fail under python -O,
        # since this command's whole job is exit-code-checked validation
        if not cond:
            raise RuntimeError(f"check failed: {what}")

    def step(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            print(f"[ok]   {name} ({time.perf_counter() - t0:.2f}s)")
        except Exception as e:  # mirror exit-code checking: keep going
            failures.append(name)
            print(f"[FAIL] {name}: {type(e).__name__}: {e}")

    def selection():  # bin/test74-style selection over an object set
        from netsdb_tpu_torch.plan.computations import Filter, ScanSet, WriteSet

        client.create_database("st")
        client.create_set("st", "emps")
        client.send_data("st", "emps",
                         [{"id": i, "salary": i * 100} for i in range(100)])
        res = client.execute_computations(
            WriteSet(Filter(ScanSet("st", "emps"),
                            lambda r: r["salary"] > 5000), "st", "rich"),
            job_name="selftest-selection")
        check(len(next(iter(res.values()))) == 49, "selection row count")

    def aggregation():  # bin/test90-style group-by
        from netsdb_tpu_torch.plan.computations import (Aggregate, ScanSet,
                                                        WriteSet)

        res = client.execute_computations(
            WriteSet(Aggregate(ScanSet("st", "emps"),
                               key=lambda r: r["id"] % 5,
                               value=lambda r: r["salary"],
                               combine=lambda a, b: a + b),
                     "st", "by_dept"), job_name="selftest-agg")
        out = next(iter(res.values()))
        check(len(out) == 5 and sum(out.values()) == sum(
            i * 100 for i in range(100)), "aggregation groups/total")

    def lda():
        from netsdb_tpu_torch.workloads.lda import lda_em

        counts = rng.integers(0, 5, size=(20, 30)).astype(np.float32)
        state = lda_em(on_dev(counts), k=3, iters=5)
        check(bool(torch.isfinite(state.doc_topic).all()),
              "lda finite doc_topic")

    def ff():  # FFTest 100 100
        from netsdb_tpu_torch.models.ff import FFModel

        m = FFModel(db="stff", block=(32, 32))
        m.setup(client)
        m.load_random_weights(client, 100, 100, 10)
        m.load_inputs(client,
                      rng.standard_normal((64, 100)).astype(np.float32))
        probs = m.inference(client).to_dense().cpu().numpy()
        check(bool(np.allclose(probs.sum(0), 1.0, atol=1e-3)),
              "ff softmax columns sum to 1")

    def lstm():
        from netsdb_tpu_torch.models.lstm_model import LSTMModel

        nin, nh, batch, T = 16, 16, 8, 4
        m = LSTMModel(db="stlstm", block=(8, 8))
        m.setup(client)
        w = {}
        for g in "ifco":
            w[f"w_{g}"] = rng.standard_normal((nh, nin)).astype(np.float32) * 0.3
            w[f"u_{g}"] = rng.standard_normal((nh, nh)).astype(np.float32) * 0.3
            w[f"b_{g}"] = rng.standard_normal(nh).astype(np.float32) * 0.1
        m.load_weights(client, w)
        m.load_state(client, np.zeros((nh, batch), np.float32),
                     np.zeros((nh, batch), np.float32))
        xs = rng.standard_normal((T, nin, batch)).astype(np.float32)
        hT, _cT, _hs = m.run_sequence(client, xs)
        check(bool(torch.isfinite(hT.to_dense()).all()),
              "lstm finite hidden state")

    def conv():  # Conv2dProjTest shapes, numpy differential oracle
        from netsdb_tpu_torch.ops.conv import conv2d_direct, conv2d_im2col

        x = on_dev(rng.standard_normal((2, 3, 16, 16)).astype(np.float32))
        k = on_dev(rng.standard_normal((4, 3, 3, 3)).astype(np.float32))
        d = conv2d_direct(x, k).cpu().numpy()
        m = conv2d_im2col(x, k).cpu().numpy()
        check(bool(np.allclose(d, m, rtol=1e-4, atol=1e-4)),
              "conv direct vs im2col agree")

    def tpch_columnar():  # columnar engine vs host row engine, Q01/Q06
        from netsdb_tpu_torch.relational.queries import (COLUMNAR_QUERIES,
                                                         tables_from_rows)
        from netsdb_tpu_torch.utils.compare import structurally_close
        from netsdb_tpu_torch.workloads import tpch as row_engine

        data = row_engine.generate(scale=1, seed=4)
        tabs = tables_from_rows(data, device=dev)
        row_engine.load_tables(client, tables=data)
        for qn in ("q01", "q06"):
            rows = sorted(row_engine.run_query(client, qn), key=str)
            col = sorted(COLUMNAR_QUERIES[qn](tabs), key=str)
            check(structurally_close(col, rows),
                  f"columnar {qn} equals row engine")

    def pdml():  # LA DSL program (TestLA-style)
        from netsdb_tpu_torch.dsl.interp import run_pdml

        env = run_pdml("A = ones(4,4,2,2)\nB = identity(4,2)\n"
                       "C = (A + B) %*% B\nD = rowSum(C)", client=client)
        check(env["D"].shape == (8, 1), "pdml rowSum shape")

    def dedup():  # shared-weight block fingerprinting
        from netsdb_tpu_torch.core.blocked import BlockedTensor
        from netsdb_tpu_torch.dedup.detector import block_fingerprints

        t = rng.standard_normal((16, 16)).astype(np.float32)
        bt = BlockedTensor.from_dense(t, (8, 8), device=dev)
        fps = block_fingerprints(bt)
        check(len(fps) == 4, "dedup fingerprints one per block")

    def planner_stats():  # stats-driven join choice (round 2)
        from netsdb_tpu_torch.relational import planner as PLN
        from netsdb_tpu_torch.relational.table import ColumnTable

        dense = ColumnTable({"k": torch.arange(512, dtype=torch.int32,
                                               device=dev)})
        probe = ColumnTable({"fk": torch.arange(512, dtype=torch.int32,
                                                device=dev)})
        sparse = ColumnTable({"k": on_dev(
            np.linspace(0, 4e8, 64).astype(np.int32))})
        check(PLN.plan_join(dense, "k", probe, "fk").strategy == "lut",
              "planner picks LUT for dense keys")
        check(PLN.plan_join(sparse, "k", probe, "fk").strategy == "sort",
              "planner picks sort for sparse keys")

    def outofcore():  # paged q06 vs in-memory (round 2)
        import shutil

        from netsdb_tpu_torch.relational import outofcore as O
        from netsdb_tpu_torch.relational.queries import (cq06,
                                                         tables_from_rows)
        from netsdb_tpu_torch.storage.paged import PagedTensorStore
        from netsdb_tpu_torch.workloads import tpch as row_engine

        data = row_engine.generate(scale=1, seed=6)
        tabs = tables_from_rows(data, device=dev)
        root = tempfile.mkdtemp(prefix="selftest_ooc_")
        try:
            store = PagedTensorStore(Configuration(
                root_dir=root, page_size_bytes=1 << 14))
            pc = O.PagedColumns.from_table(store, "li",
                                           tabs["lineitem"],
                                           O.Q06_COLUMNS, device=dev)
            got = O.ooc_q06(pc)[0][1]
            want = cq06(tabs)[0][1]
            store.close()
        finally:
            shutil.rmtree(root, ignore_errors=True)
        check(abs(got - want) <= max(1e-4 * abs(want), 1e-2),
              "out-of-core q06 equals in-memory")

    def reddit_columnar():  # device label propagation (round 2)
        from netsdb_tpu_torch.workloads import reddit as R
        from netsdb_tpu_torch.workloads import reddit_columnar as RC

        cm, au, su = R.generate(num_comments=150, num_authors=12,
                                num_subs=4, seed=2)
        tabs = RC.columnarize(cm, au, su, device=dev)
        prop = RC.propagate_labels(tabs["comments"]).cpu().numpy()
        pos = {c.author for c in cm if c.label == 1}
        want = np.array([1 if c.author in pos else 0 for c in cm])
        check(bool((prop == want).all()), "reddit propagation oracle")

    def placement_api():  # distribution through the set API (round 3)
        from netsdb_tpu_torch.parallel.placement import Placement
        from netsdb_tpu_torch.relational import dag as rdag
        from netsdb_tpu_torch.relational.queries import (cq01,
                                                         tables_from_rows)
        from netsdb_tpu_torch.workloads import tpch as row_engine

        data = row_engine.generate(scale=1, seed=8)
        client.create_database("stp")
        client.create_set("stp", "lineitem", type_name="table",
                          placement=Placement.data_parallel(ndim=1))
        client.send_table("stp", "lineitem", data["lineitem"])
        got = rdag.run_query(
            client, rdag.q01_sink("stp", output_set="q01o")).to_rows()
        want = cq01(tables_from_rows(data, device=dev))
        check(len(got) == len(want) and all(
            g["count"] == v["count"] for g, (_, v) in zip(got, want)),
            "placement-set q01 equals columnar engine")

    def ooc_join():  # streamed-probe join (round 3)
        import shutil

        from netsdb_tpu_torch.relational import outofcore as O
        from netsdb_tpu_torch.relational.queries import (cq03,
                                                         tables_from_rows)
        from netsdb_tpu_torch.relational.table import date_to_int
        from netsdb_tpu_torch.storage.paged import PagedTensorStore
        from netsdb_tpu_torch.workloads import tpch as row_engine

        data = row_engine.generate(scale=1, seed=9)
        tabs = tables_from_rows(data, device=dev)
        root = tempfile.mkdtemp(prefix="selftest_oocj_")
        try:
            store = PagedTensorStore(Configuration(
                root_dir=root, page_size_bytes=1 << 14))
            pc = O.PagedColumns.from_table(store, "li", tabs["lineitem"],
                                           O.Q03_COLUMNS, device=dev)
            orders = {n: tabs["orders"][n].cpu().numpy() for n in
                      ("o_orderkey", "o_custkey", "o_orderdate",
                       "o_shippriority")}
            cust = {n: tabs["customer"][n].cpu().numpy() for n in
                    ("c_custkey", "c_mktsegment")}
            n_keys = int(orders["o_orderkey"].max()) + 1
            O.build_q03_side(store, orders, cust,
                             tabs["customer"].code("c_mktsegment",
                                                   "BUILDING"),
                             date_to_int("1995-03-15"),
                             max(1, n_keys // 3))
            got = O.ooc_q03(pc, store)
            store.close()
        finally:
            shutil.rmtree(root, ignore_errors=True)
        want = cq03(tabs)
        check([r["okey"] for r in got] == [r["okey"] for r in want],
              "out-of-core q03 join equals in-memory")

    def autojoin():  # automatic string-key device join (round 3)
        from netsdb_tpu_torch.relational.autojoin import (equijoin,
                                                          table_from_objects)
        from netsdb_tpu_torch.workloads import reddit as R

        cm, au, _su = R.generate(num_comments=120, num_authors=10,
                                 num_subs=3, seed=3)
        j = equijoin(table_from_objects(cm, device=dev), "author",
                     table_from_objects(au, device=dev), "author",
                     take=["author_id"])
        by = {a.author: a.author_id for a in au}
        got = sorted((r["id"], r["author_id"]) for r in j.to_rows())
        check(got == sorted((c.id, by[c.author]) for c in cm),
              "autojoin equals host hash join")

    def dedup_pool():  # serve-time device dedup (round 3)
        from netsdb_tpu_torch.core.blocked import BlockedTensor
        from netsdb_tpu_torch.dedup.pool import pool_models

        base = rng.standard_normal((64, 64)).astype(np.float32)
        variant = base.copy()
        variant[:16, :16] += 1.0
        pooled, rep = pool_models(
            {"a": BlockedTensor.from_dense(base, (16, 16), device=dev),
             "b": BlockedTensor.from_dense(variant, (16, 16), device=dev)})
        check(rep["shared_block_refs"] == 15
              and bool(np.array_equal(
                  pooled["b"].assemble().data.cpu().numpy(), variant)),
              "dedup pool shares identical blocks, assembly exact")

    def paged_set_api():  # round 4: out-of-core as a SET property
        from netsdb_tpu_torch.relational import dag as rdag
        from netsdb_tpu_torch.relational.queries import (cq06,
                                                         tables_from_rows)
        from netsdb_tpu_torch.workloads import tpch

        tabs = tables_from_rows(tpch.generate(scale=4, seed=2), device=dev)
        pc = Client(Configuration(
            root_dir=tempfile.mkdtemp(prefix="st_paged_"),
            page_size_bytes=4096, page_pool_bytes=16384), device=device)
        pc.create_database("d")
        for n, t in tabs.items():
            pc.create_set("d", n, type_name="table",
                          storage="paged" if n == "lineitem" else "memory")
            pc.send_table("d", n, t)
        out = rdag.run_query(pc, rdag.q06_sink("d"))
        ref = dict(cq06(tabs))["revenue"]
        store = pc.store.page_store()
        check(abs(float(out["revenue"].reshape(-1)[0]) - ref)
              <= 1e-5 * max(abs(ref), 1)
              and (not store.native or store.stats()["spills"] > 0),
              "paged q06 matches resident (spills>0 when native)")

    def placement_arm():  # round 4: the advisor decides SHARDING
        from netsdb_tpu_torch.learning.ab_bench import bench_distribution_ab

        out = bench_distribution_ab(scale=4, rounds=2,
                                    advisor_kind="rule", device=device)
        check(len(out["applied"]) == 2
              and all(v is not None for v in out["mean_s"].values()),
              "placement arms applied by create_set and measured")

    def paged_matmul():  # round 4: larger-than-pool weights stream
        pc = Client(Configuration(
            root_dir=tempfile.mkdtemp(prefix="st_pm_"),
            page_size_bytes=65536, page_pool_bytes=262144), device=device)
        pc.create_database("d")
        pc.create_set("d", "w", storage="paged")
        w = rng.standard_normal((2048, 128)).astype(np.float32)
        x = rng.standard_normal((128, 32)).astype(np.float32)
        pc.send_matrix("d", "w", w)
        out = pc.paged_matmul("d", "w", x).cpu().numpy()
        store = pc.store.page_store()
        check(np.allclose(out, w @ x, rtol=2e-4, atol=2e-4)
              and (not store.native or store.stats()["spills"] > 0),
              "paged matmul matches numpy (spills>0 when native)")

    def paged_weights():  # round 5: inference over PAGED weight sets
        from netsdb_tpu_torch.models.ff import FFModel

        def run(storages):
            pc = Client(Configuration(
                root_dir=tempfile.mkdtemp(prefix="st_pw_"),
                page_size_bytes=4096, page_pool_bytes=16384),
                device=device)
            m = FFModel(db="ff", block=(32, 32))
            m.setup(pc, storages=storages)
            m.load_random_weights(pc, 96, 128, 10, seed=0)
            m.load_inputs(pc, rng.standard_normal(
                (32, 96)).astype(np.float32))
            return (m.inference(pc).to_dense().cpu().numpy(),
                    pc.store.page_store() if storages else None)

        # deterministic inputs: same rng state both runs
        state = rng.bit_generator.state
        ref, _ = run(None)
        rng.bit_generator.state = state
        out, store = run({"w1": "paged", "wo": "paged"})
        check(bool(np.array_equal(ref, out))
              and (not store.native or store.stats()["spills"] > 0),
              "FF inference over paged weight sets bit-matches resident "
              "(spills>0 when native)")

    steps = [("selection", selection), ("aggregation", aggregation),
             ("lda", lda), ("ff", ff), ("lstm", lstm), ("conv", conv),
             ("tpch-columnar", tpch_columnar), ("pdml", pdml),
             ("dedup", dedup), ("planner-stats", planner_stats),
             ("out-of-core", outofcore),
             ("reddit-columnar", reddit_columnar),
             ("placement-api", placement_api), ("ooc-join", ooc_join),
             ("autojoin", autojoin), ("dedup-pool", dedup_pool),
             ("paged-set-api", paged_set_api),
             ("placement-arm", placement_arm),
             ("paged-matmul", paged_matmul),
             ("paged-weights", paged_weights)]
    for name, fn in steps:
        step(name, fn)
    print(f"{len(steps) - len(failures)}/{len(steps)} passed")
    return 1 if failures else 0


def _cmd_la_bench(args) -> int:
    """The reference's headline LA tasks (Gram / linreg / matmul at
    200000x1000 scale — BASELINE.md rows 1-3) via the PDML DSL."""
    from netsdb_tpu_torch.workloads import la_tasks

    tasks = list(la_tasks.TASKS) if args.task == "all" else [args.task]
    for t in tasks:
        res = la_tasks.run_task(t, rows=args.rows, cols=args.cols,
                                block=args.block, iters=args.iters,
                                device=args.device)
        print(json.dumps(res))
    return 0


def _cmd_conv_bench(args) -> int:
    """Conv2d batch-latency p50 (both modes) vs the reference's ATen
    CPU path at its documented shapes."""
    from netsdb_tpu_torch.workloads.conv_bench import run_conv_bench

    print(json.dumps(run_conv_bench(
        batch=args.batch, hw=args.hw, cin=args.cin, cout=args.cout,
        k=args.k, iters=args.iters,
        compute_dtype=args.compute_dtype, device=args.device), indent=2))
    return 0


def _cmd_model_bench(args) -> int:
    """word2vec / LSTM / text-classifier inference throughput vs the
    netsDB-equivalent CPU path (no reference-published numbers exist)."""
    from netsdb_tpu_torch.workloads.model_bench import run_model_bench

    print(json.dumps(run_model_bench(scale=args.scale, device=args.device),
                     indent=2))
    return 0


def _cmd_attention_bench(args) -> int:
    """Long-context flash-vs-naive attention (beyond-reference)."""
    from netsdb_tpu_torch.workloads.attention_bench import bench_attention

    seqs = [int(s) for s in args.seqs.split(",")]
    print(json.dumps(bench_attention(seq_lens=seqs, batch=args.batch,
                                     heads=args.heads,
                                     head_dim=args.head_dim,
                                     device=args.device), indent=2))
    return 0


def _cmd_serve(args) -> int:
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.serve.server import run_daemon

    # the reference's --platform picks the jax platform; here it names
    # the daemon's device type and overrides --device
    device = args.platform or args.device
    overrides = {}
    if args.root:
        overrides["root_dir"] = args.root
    if args.device_cache_mb is not None:
        overrides["device_cache_bytes"] = args.device_cache_mb << 20
    if args.page_pool_mb is not None:
        overrides["page_pool_bytes"] = args.page_pool_mb << 20
    if args.page_kb is not None:
        overrides["page_size_bytes"] = args.page_kb << 10
    if args.rebalance:
        overrides["rebalance"] = True
    config = Configuration(**overrides)
    followers = ([a.strip() for a in args.followers.split(",") if a.strip()]
                 if args.followers else None)
    workers = ([a.strip() for a in args.workers.split(",") if a.strip()]
               if args.workers else None)
    # a process of a joined cluster joins before it serves (a no-op
    # without NETSDB_TPU_COORDINATOR in the environment)
    from netsdb_tpu_torch.parallel.distributed import initialize_cluster

    initialize_cluster(device=device or "cuda")
    return run_daemon(config, host=args.host, port=args.port,
                      token=args.token, max_jobs=args.max_jobs,
                      followers=followers, workers=workers, device=device)


def _print_obs(stats, traces) -> None:
    """Human-readable observability readout (the --json flag skips
    this and dumps the raw payloads)."""
    m = stats.get("metrics") or {}
    if m or stats.get("device_cache") or stats.get("followers"):
        print("== metrics ==")
    for k, v in sorted((m.get("counters") or {}).items()):
        print(f"  {k:<44} {v}")
    for k, v in sorted((m.get("gauges") or {}).items()):
        print(f"  {k:<44} {v}")
    for k, h in sorted((m.get("histograms") or {}).items()):
        if not h.get("count"):
            continue
        print(f"  {k:<44} n={h['count']} mean={h['mean']:.4g} "
              f"p50={h['p50']:.4g} p95={h['p95']:.4g} "
              f"p99={h['p99']:.4g} max={h['max']:.4g}")
    for section in ("compile", "staging", "stages"):
        if m.get(section):
            print(f"  -- {section}: {json.dumps(m[section])}")
    if stats.get("device_cache"):
        print(f"  -- device_cache: {json.dumps(stats['device_cache'])}")
    for addr, f in sorted((stats.get("followers") or {}).items()):
        dc = f.get("device_cache") if isinstance(f, dict) else None
        print(f"  -- follower {addr}: "
              f"{json.dumps(dc if dc is not None else f)}")

    profiles = traces.get("profiles") or []
    print(f"== traces ({len(profiles)} profile(s), newest last) ==")

    def show(prof, indent=""):
        total = prof.get("total_s") or 0.0
        print(f"{indent}{prof.get('qid')} [{prof.get('origin')}] "
              f"total={total * 1e3:.2f}ms "
              f"counters={prof.get('counters') or {}}")
        hd = prof.get("host_device")
        if hd:
            print(f"{indent}  host/device: "
                  f"host={hd['host_s'] * 1e3:.2f}ms "
                  f"device_est={hd['device_est_s'] * 1e3:.2f}ms")
        if prof.get("meta"):
            print(f"{indent}  meta: {json.dumps(prof['meta'])}")
        for sp in prof.get("spans") or ():
            pad = indent + "  " * (sp.get("depth", 0) + 1)
            extra = f"  {sp['counters']}" if sp.get("counters") else ""
            print(f"{pad}{sp['name']} +{sp['start_s'] * 1e3:.2f}ms "
                  f"{sp['duration_s'] * 1e3:.3f}ms{extra}")
        client_prof = prof.get("client")
        if client_prof:
            # the PUT_TRACE-shipped client half of the same qid
            print(f"{indent}  client:")
            show(client_prof, indent + "    ")
        for addr, fprofs in sorted((prof.get("followers") or {}).items()):
            print(f"{indent}  follower {addr}:")
            for fp in fprofs:
                show(fp, indent + "    ")

    for prof in profiles:
        show(prof)


def _print_health(health) -> None:
    """Human-readable SLO/health readout (the HEALTH frame)."""
    def show_section(h, indent=""):
        for o in h.get("objectives") or ():
            state = "BREACHED" if o.get("breached") else "ok"
            val = o.get("value")
            val_s = f"{val:.4g}" if isinstance(val, (int, float)) else "-"
            burn = o.get("worst_burn_rate")
            burn_s = f"{burn:.3g}" if isinstance(burn, (int, float)) \
                else "-"
            print(f"{indent}  {o['name']:<24} [{state}] "
                  f"value={val_s} target={o['target']} "
                  f"worst_burn={burn_s}  ({o['kind']})")
            for wname, w in sorted((o.get("windows") or {}).items()):
                wv = w.get("value")
                wv_s = f"{wv:.4g}" if isinstance(wv, (int, float)) else "-"
                wb = w.get("burn_rate")
                wb_s = f"{wb:.3g}" if isinstance(wb, (int, float)) else "-"
                print(f"{indent}      {wname:<10} value={wv_s} "
                      f"burn={wb_s} [{w.get('scope')}]")
        for ev in (h.get("events") or ())[-5:]:
            print(f"{indent}  event: {json.dumps(ev, default=str)}")
        sl = h.get("slowlog") or {}
        print(f"{indent}  slowlog: {sl.get('entries', 0)} entries "
              f"(threshold {sl.get('threshold_s')}s, "
              f"newest {sl.get('newest')})")

    print("== health ==")
    show_section(health)
    for addr, f in sorted((health.get("followers") or {}).items()):
        print(f"  follower {addr}:")
        if isinstance(f, dict) and "objectives" in f:
            show_section(f, "  ")
        else:
            print(f"    {json.dumps(f, default=str)}")


def _render_explain(prof) -> None:
    """Render one profile's per-operator tree — the classic EXPLAIN
    ANALYZE readout, per-node % of the plan total."""
    from netsdb_tpu_torch.obs import operators

    tree = prof.get("operators")
    qid = prof.get("qid")
    if not tree:
        print(f"{qid}: profile has no operator tree (obs_explain off, "
              f"or the plan ran before this daemon enabled it)")
        return
    print(f"qid={qid} [{prof.get('origin')}] "
          f"total={1e3 * (prof.get('total_s') or 0.0):.2f}ms")
    print(operators.render_tree(tree, total_s=prof.get("total_s")))
    shard_ops = prof.get("shard_operators")
    if shard_ops:
        # the distributed region tree: each shard's regions under the
        # coordinator's, all under one qid
        print(operators.render_shard_forest(
            shard_ops, total_s=prof.get("total_s")))
    for addr, fprofs in sorted((prof.get("followers") or {}).items()):
        for fp in fprofs:
            if fp.get("operators"):
                print(f"-- follower {addr}:")
                print(operators.render_tree(
                    fp["operators"], total_s=fp.get("total_s")))


def _cmd_obs_explain(c, args) -> int:
    """`obs --explain <qid>`: the per-operator EXPLAIN ANALYZE tree of
    one traced query — in-memory ring first, slowlog fallback."""
    reply = c.get_trace(qid=args.explain)
    profiles = [p for p in reply.get("profiles") or ()]
    if not profiles:
        reply = c.get_trace(qid=args.explain, slow=True)
        profiles = [p for p in reply.get("profiles") or ()]
    if not profiles:
        print(f"no profile for qid {args.explain!r} (ring rotated, or "
              f"the query was never traced)", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(profiles, indent=2, default=str))
        return 0
    for prof in profiles:
        _render_explain(prof)
    return 0


def _render_top(payload) -> str:
    """One `obs --top` frame: derived rates from the daemon's
    telemetry history plus the busiest (client, set) attribution rows.
    Pure text-in/text-out so tests can pin the shape."""
    lines = []
    hist = payload.get("history") or {}
    deltas = payload.get("deltas") or {}
    lines.append(f"== top (history: {hist.get('readings', 0)} readings"
                 f" / {hist.get('span_s', 0.0):.0f}s span, "
                 f"window {deltas.get('dt_s', 0.0):.1f}s) ==")
    derived = deltas.get("derived") or {}
    for k in ("qps", "staged_mb_s", "staged_chunks_s",
              "devcache_hit_rate", "availability",
              "devcache_installs_s"):
        v = derived.get(k)
        v_s = f"{v:.4g}" if isinstance(v, (int, float)) else "-"
        lines.append(f"  {k:<22} {v_s}")
    rates = deltas.get("rates") or {}
    moving = sorted(rates.items(), key=lambda kv: -abs(kv[1]))[:8]
    if moving:
        lines.append("  -- moving counters (per second):")
        for name, rate in moving:
            lines.append(f"     {name:<40} {rate:.4g}/s")
    attribution = ((payload.get("metrics") or {})
                   .get("attribution") or {})
    rows = []
    for client, scopes in attribution.items():
        if not isinstance(scopes, dict):
            continue
        for scope, metrics in scopes.items():
            rows.append((client, scope,
                         metrics.get("requests", 0),
                         metrics.get("staged_bytes", 0)))
    rows.sort(key=lambda r: (-r[2], -r[3]))
    if rows:
        lines.append("  -- clients (requests / staged MB):")
        for client, scope, reqs, sb in rows[:8]:
            lines.append(f"     {client:<16} {scope:<24} "
                         f"{int(reqs):>8} {sb / 1e6:>10.1f}")
    return "\n".join(lines)


def _cmd_obs_top(c, args) -> int:
    """`obs --top`: live terminal view refreshing from the daemon's
    history deltas (bounded iterations for scripting/tests; default
    runs until interrupted)."""
    import time as _time

    n = args.iterations
    i = 0
    try:
        while True:
            payload = c.get_metrics(window_s=args.interval * 5)
            if args.json:
                print(json.dumps({"history": payload.get("history"),
                                  "deltas": payload.get("deltas")},
                                 indent=2, default=str))
            else:
                print(_render_top(payload))
            i += 1
            if n and i >= n:
                return 0
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def _sched_view(stats) -> dict:
    """The scheduler slice of one COLLECT_STATS reply — the ONE
    extractor both `obs --sched` renderings (pretty and --json)
    consume, so the two outputs cannot drift."""
    m = stats.get("metrics") or {}
    return {
        "sched": m.get("sched") or {},
        "counters": {k: v for k, v in (m.get("counters") or {}).items()
                     if k.startswith("sched.")},
        "queue_wait_s": (m.get("histograms") or {})
        .get("sched.queue_wait_s"),
    }


def _print_sched(view) -> None:
    """The `obs --sched` readout: the scheduler's lane table (the
    registry's "sched" collector section) plus every sched.*
    instrument — admissions, rejections, coalesce and affinity
    decisions, queue-wait distribution."""
    sched = view["sched"]
    print(f"== scheduler (slots {sched.get('slots')}, free "
          f"{sched.get('free_slots')}, queued {sched.get('queued')}, "
          f"quota {sched.get('quota') or 'off'}, aging every "
          f"{sched.get('aging_every') or 'off'}, coalesce "
          f"{'on' if sched.get('coalesce_enabled') else 'off'}, "
          f"affinity "
          f"{'on' if sched.get('affinity_enabled') else 'off'}) ==")
    lanes = sched.get("lanes") or {}
    for name, ln in sorted(lanes.items()):
        w = ln.get("wait") or {}
        line = (f"  lane {name:<20} weight={ln.get('weight'):<6} "
                f"depth={ln.get('depth'):<4} served={ln.get('served')}")
        if w.get("p50") is not None:
            line += (f" wait_p50={w['p50'] * 1e3:.2f}ms"
                     f" wait_p99={w['p99'] * 1e3:.2f}ms")
        print(line)
    for k, v in sorted(view["counters"].items()):
        print(f"  {k:<44} {v}")
    h = view["queue_wait_s"]
    if h and h.get("count"):
        print(f"  sched.queue_wait_s  n={h['count']} "
              f"mean={h['mean'] * 1e3:.2f}ms p50={h['p50'] * 1e3:.2f}ms "
              f"p99={h['p99'] * 1e3:.2f}ms max={h['max'] * 1e3:.2f}ms")


def _sessions_view(stats) -> dict:
    """The session/decode slice of COLLECT_STATS — one extractor for
    both `obs --sessions` renderings (pretty and --json)."""
    m = stats.get("metrics") or {}
    counters = m.get("counters") or {}
    gauges = m.get("gauges") or {}
    return {
        "sessions": stats.get("sessions") or {},
        "counters": {k: v for k, v in counters.items()
                     if k.startswith("session.")},
        "gauges": {k: v for k, v in gauges.items()
                   if k.startswith(("session.", "dedup."))},
    }


def _print_sessions(view) -> None:
    """The `obs --sessions` readout: the open-session table (owner,
    step counts), batcher coalescing stats, arena spill accounting,
    decode program/trace counts, resident-state bytes, and — when
    model_dedup pooled anything — the per-model page attribution."""
    s = view["sessions"]
    batcher = s.get("batcher") or {}
    arena = s.get("arena") or {}
    dec = s.get("decode") or {}
    print(f"== sessions (open {s.get('open', 0)}, resident "
          f"{s.get('resident_bytes', 0)} B) ==")
    for row in s.get("sessions") or []:
        print(f"  session {row['sid'][:12]:<14} db={row['db']:<12} "
              f"steps={row['steps']:<6} owner={row['owner']}")
    print(f"  batcher batches={batcher.get('batches', 0)} "
          f"coalesced={batcher.get('coalesced', 0)} "
          f"max_occupancy={batcher.get('max_occupancy', 0)} "
          f"pending={batcher.get('pending', 0)}")
    print(f"  arena entries={arena.get('entries', 0)} "
          f"reads={arena.get('reads', 0)} "
          f"writes={arena.get('writes', 0)} "
          f"bytes={arena.get('bytes', 0)}")
    print(f"  decode programs={dec.get('programs', 0)} "
          f"traces={dec.get('traces', 0)} "
          f"batches={dec.get('batches', 0)} "
          f"steps={dec.get('steps', 0)} "
          f"pad_rows={dec.get('pad_rows', 0)}")
    rep = s.get("residency")
    if rep:
        print(f"  dedup models={rep.get('models', 0)} "
              f"unique_page_bytes={rep.get('unique_page_bytes', 0)} "
              f"undeduped={rep.get('total_page_bytes', 0)} "
              f"(pooling "
              f"{'on' if rep.get('model_dedup') else 'off'})")
        for name, b in sorted(
                (rep.get("charged_by_model") or {}).items()):
            print(f"    model {name:<16} charged_bytes={b}")
    for k, v in sorted(view["counters"].items()):
        print(f"  {k:<34} {v}")
    for k, v in sorted(view["gauges"].items()):
        print(f"  {k:<34} {v}")


def _print_placement(view) -> None:
    """The `obs --placement` readout: per-member heat/byte/slot
    totals, the per-slot ownership table for every sharded set, and
    the rebalancer's status + last-move log (serve/rebalance.py)."""
    st = view.get("status") or {}
    print(f"== placement (epoch {st.get('epoch')}, skew "
          f"{view.get('skew_ratio')}, rebalance "
          f"{'on' if st.get('enabled') else 'off'}, "
          f"{'running' if st.get('running') else 'idle'}, "
          f"streak {st.get('streak')}) ==")
    for m in view.get("members") or []:
        print(f"  member {m['addr']:<22} slots={m['slots']:<3} "
              f"heat={m['heat']:<10} bytes={m['nbytes']}")
    for s in view.get("sets") or []:
        print(f"  set {s['db']}:{s['set']} mode={s['mode']} "
              f"epoch={s['epoch']} heat={s['heat']}")
        for sl in s.get("slots") or []:
            print(f"    slot {sl['slot']:<3} {sl['addr']:<22} "
                  f"{sl['state']:<8} bytes={sl['nbytes']:<10} "
                  f"heat={sl['heat']}")
    moves = st.get("moves") or []
    if moves:
        print(f"  -- last {len(moves)} move(s) --")
        for mv in moves:
            print(f"    {mv.get('db')}:{mv.get('set')}[{mv.get('slot')}]"
                  f" {mv.get('src')} -> {mv.get('dst')} "
                  f"{'ok' if mv.get('ok') else 'ABORT'} "
                  f"bytes={mv.get('nbytes', 0)}"
                  + (f" ({mv.get('error')})" if mv.get('error')
                     else ""))


def _cmd_obs(args) -> int:
    """Pretty-print a running daemon's observability surface: the
    COLLECT_STATS "metrics" section (central registry), the last N
    completed query profiles (GET_TRACE), the SLO/health readout
    (--health), the scheduler's lane/coalesce/affinity view (--sched),
    the persisted slow-query ring (--slowlog), one query's
    per-operator tree (--explain), the Prometheus scrape text
    (--openmetrics), or the live rate view (--top)."""
    from netsdb_tpu_torch.serve.client import RemoteClient

    c = RemoteClient(args.addr, token=args.token)
    try:
        if getattr(args, "explain", None):
            return _cmd_obs_explain(c, args)
        if getattr(args, "sched", False):
            view = _sched_view(c.collect_stats())
            if args.json:
                print(json.dumps(view, indent=2, default=str))
            else:
                _print_sched(view)
            return 0
        if getattr(args, "sessions", False):
            view = _sessions_view(c.collect_stats())
            if args.json:
                print(json.dumps(view, indent=2, default=str))
            else:
                _print_sessions(view)
            return 0
        if getattr(args, "placement", False):
            view = c.placement_view()
            if args.json:
                print(json.dumps(view, indent=2, default=str))
            else:
                _print_placement(view)
            return 0
        if getattr(args, "openmetrics", False):
            print(c.get_metrics(format="openmetrics")["text"], end="")
            return 0
        if getattr(args, "top", False):
            return _cmd_obs_top(c, args)
        if getattr(args, "health", False):
            health = c.health()
            if args.json:
                print(json.dumps(health, indent=2, default=str))
            else:
                _print_health(health)
            return 0
        if getattr(args, "slowlog", False):
            traces = c.get_trace(last=args.traces, qid=args.qid,
                                 slow=True)
            if args.json:
                print(json.dumps(traces, indent=2, default=str))
                return 0
            sl = traces.get("slowlog") or {}
            print(f"== slowlog ({sl.get('entries', 0)} persisted, "
                  f"threshold {sl.get('threshold_s')}s) ==")
            _print_obs({"metrics": {}}, traces)
            return 0
        stats = c.collect_stats()
        traces = c.get_trace(last=args.traces, qid=args.qid)
    finally:
        c.close()
    if args.json:
        print(json.dumps({"stats": stats, "traces": traces}, indent=2,
                         default=str))
        return 0
    _print_obs(stats, traces)
    return 0



def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="netsdb_tpu_torch")
    parser.add_argument("--device", default="cuda",
                        help="the device every command runs on (default "
                             "cuda; 'cpu' runs on the CPU explicitly)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("info", help="cluster and device info")
    sub.add_parser("bench", help="run the benchmark harness")

    p = sub.add_parser("pdml", help="run a PDML linear-algebra program")
    p.add_argument("file")
    p.add_argument("--print-values", action="store_true")

    p = sub.add_parser("demo-ff", help="FF inference demo (FFTest shape)")
    p.add_argument("--batch", type=int, default=1000)
    p.add_argument("--features", type=int, default=512)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--labels", type=int, default=10)
    p.add_argument("--block", type=int, default=256)

    p = sub.add_parser("la-bench",
                       help="headline LA tasks (Gram/linreg/matmul) vs "
                            "the reference's published numbers")
    p.add_argument("--task", default="all",
                   choices=["all", "gram", "linreg", "matmul"])
    p.add_argument("--rows", type=int, default=200000)
    p.add_argument("--cols", type=int, default=1000)
    p.add_argument("--block", type=int, default=1000)
    p.add_argument("--iters", type=int, default=5)

    p = sub.add_parser("conv-bench",
                       help="conv2d batch latency p50 vs ATen CPU path")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--hw", type=int, default=112)
    p.add_argument("--cin", type=int, default=3)
    p.add_argument("--cout", type=int, default=64)
    p.add_argument("--k", type=int, default=7)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--compute-dtype", default=None)

    p = sub.add_parser("model-bench",
                       help="word2vec/LSTM/text-classifier throughput "
                            "vs netsDB-equivalent CPU path")
    p.add_argument("--scale", type=float, default=1.0,
                   help="multiplier on all benchmark dimensions")

    p = sub.add_parser("attention-bench",
                       help="flash vs naive attention at long seq lens")
    p.add_argument("--seqs", default="1024,2048,4096,8192")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=128)

    p = sub.add_parser("micro-bench",
                       help="runtime micro-benchmarks (serviceBenchmarks)")
    p.add_argument("--only", default=None,
                   help="comma-separated benchmark names")
    p.add_argument("--staging", action="store_true",
                   help="overlapped vs synchronous device staging on "
                        "the out-of-core matmul and fold streams")
    p.add_argument("--bucket-sweep", action="store_true",
                   help="pad-waste vs trace-count per shape-ladder "
                        "density (the bucket_density knob: 2 vs 4 "
                        "buckets per octave)")
    p.add_argument("--obs-overhead", action="store_true",
                   help="cost of always-on query tracing on the staged "
                        "fold stream (traced vs untraced; < 3%% is the "
                        "budget)")
    p.add_argument("--explain-overhead", action="store_true",
                   help="cost of per-node operator attribution on the "
                        "staged fold stream (explain on vs off; < 1%% "
                        "budget, ~0 when off)")
    p.add_argument("--lint-overhead", action="store_true",
                   help="cost of the runtime lock-order witness on "
                        "the staged fold stream (witness on vs off; "
                        "< 2%% budget, ~0 when off)")
    p.add_argument("--fusion", action="store_true",
                   help="fusion-aware plan compilation paired A/B "
                        "(plan_fusion on vs off on the staged fold "
                        "stream + a resident-spine mixed plan; "
                        "reports plan_fusion_speedup + trace counts)")
    p.add_argument("--summa", action="store_true",
                   help="distributed linear algebra paired A/B: SUMMA "
                        "panel staging vs replicated operands on the "
                        "virtual mesh (per-host staged bytes ~1/N, "
                        "byte-equality gated) + reshard-via-"
                        "collectives vs re-stage-from-arena (zero "
                        "arena reads proof)")

    sub.add_parser("selftest",
                   help="scripted integration sequence (integratedTests.py)")

    p = sub.add_parser("tpch", help="run TPC-H demo queries")
    p.add_argument("--query", default=None,
                   choices=["q01", "q02", "q03", "q04", "q06", "q12", "q13",
                            "q14", "q17", "q22"])
    p.add_argument("--scale", type=int, default=1)
    p.add_argument("--print-values", action="store_true")

    p = sub.add_parser("tpch-bench",
                       help="columnar TPC-H device benchmark (dbgen scale)")
    p.add_argument("--sf", type=float, default=0.1,
                   help="TPC-H scale factor (lineitem ≈ 6M rows at sf=1)")
    p.add_argument("--iters", type=int, default=10)

    p = sub.add_parser("serve", help="run the resident controller daemon "
                       "(ref MasterMain: the server that owns the device "
                       "and keeps model sets loaded across clients)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8108)
    p.add_argument("--root", default=None, help="database root dir")
    p.add_argument("--token", default=None, help="shared auth token")
    p.add_argument("--max-jobs", type=int, default=None,
                   help="concurrent job admission cap (default num_threads)")
    p.add_argument("--followers", default=None,
                   help="comma-separated worker daemon addresses: fan "
                        "every mutating/job frame out for multi-host "
                        "SPMD (join every process into one cluster: "
                        "NETSDB_TPU_COORDINATOR, NETSDB_TPU_NUM_PROCESSES "
                        "and NETSDB_TPU_PROCESS_ID in each)")
    p.add_argument("--workers", default=None,
                   help="comma-separated shard daemon addresses "
                        "forming this leader's partitioned worker "
                        "pool (horizontal scale-out: sets created "
                        "with placement='hash'/'range' partition "
                        "across the pool)")
    p.add_argument("--device-cache-mb", type=int, default=None,
                   help="override config.device_cache_bytes (MB); "
                        "0 disables the device cache")
    p.add_argument("--page-pool-mb", type=int, default=None,
                   help="override config.page_pool_bytes (MB) — the "
                        "paged-set arena cap")
    p.add_argument("--page-kb", type=int, default=None,
                   help="override config.page_size_bytes (KB)")
    p.add_argument("--rebalance", action="store_true",
                   help="enable live shard rebalancing on this "
                        "daemon (config.rebalance): the leader's "
                        "skew detector moves slot ownership between "
                        "pool members with zero client-visible "
                        "downtime")
    p.add_argument("--platform", default=None,
                   help="the daemon's device type (e.g. cpu); overrides "
                        "--device")

    p = sub.add_parser("serve-bench",
                       help="FF inference throughput over the RPC hop, "
                       "concurrent client processes against one daemon")
    p.add_argument("--clients", type=int, default=None,
                   help="concurrent clients (default: 2, or 8 for "
                        "--scheduler); explicit values always win")
    p.add_argument("--jobs", type=int, default=8,
                   help="inference jobs per client")
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--port", type=int, default=0,
                   help="0 = spawn a private daemon on an ephemeral port")
    p.add_argument("--platform", default=None,
                   help="the spawned daemon's device type (e.g. cpu)")
    p.add_argument("--data-plane", action="store_true",
                   help="v3 data-plane numbers instead: single-frame vs "
                   "streamed pipelined ingest MB/s, scan MB/s, zero-copy "
                   "tensor push/pull, hedged-read p99")
    p.add_argument("--table-mb", type=int, default=64)
    p.add_argument("--device-cache", action="store_true",
                   help="cold vs warm EXECUTE latency over a "
                        "device-cache-resident paged set instead "
                        "(hit/miss counters included)")
    p.add_argument("--partial-cache", action="store_true",
                   help="partial-run caching paired A/B instead: "
                        "warm re-query after a 1%% append under "
                        "dirty-range vs whole-run invalidation")
    p.add_argument("--scheduler", action="store_true",
                   help="query-scheduler paired A/B instead: N "
                        "concurrent identical cold EXECUTEs, "
                        "scheduler on vs off (executions run, "
                        "devcache installs, coalesce hits, p50/p99)")
    p.add_argument("--scale", action="store_true",
                   help="horizontal scale-out instead: paired 1 vs N "
                        "daemon arm — aggregate routed-ingest MB/s, "
                        "cold scatter-gather q01 QPS and "
                        "byte-equality incl. a distributed-shuffle "
                        "join")
    p.add_argument("--daemons", type=int, default=4,
                   help="pool size for --scale (leader + N-1 shards)")
    p.add_argument("--rebalance", action="store_true",
                   help="self-rebalancing paired A/B instead: a "
                        "4-daemon pool under an 80/20 skewed mix "
                        "registers a 5th daemon mid-run — rebalance "
                        "on vs frozen (recovery throughput ratio, "
                        "zero failed requests, exact totals)")
    p.add_argument("--fusion-distributed", action="store_true",
                   help="distributed fusion paired A/B instead: "
                        "4-daemon scatter q01 + 3-sink fan under "
                        "the optimal mapper vs greedy vs "
                        "plan_fusion=off — one-program-per-shard, "
                        "one-subplan fan and byte-equality gates")

    p = sub.add_parser("obs",
                       help="observability readout of a running daemon: "
                            "central metrics (COLLECT_STATS) + the last "
                            "query trace profiles (GET_TRACE)")
    p.add_argument("--addr", default="127.0.0.1:8108",
                   help="daemon address host:port")
    p.add_argument("--token", default=None, help="shared auth token")
    p.add_argument("--traces", type=int, default=5,
                   help="how many completed query profiles to show")
    p.add_argument("--qid", default=None,
                   help="show only the profile(s) of one query id")
    p.add_argument("--health", action="store_true",
                   help="SLO/health readout instead (HEALTH frame): "
                        "every objective with multi-window burn rates, "
                        "recent breach/recovery events, slowlog "
                        "summary; leaders merge follower sections")
    p.add_argument("--sched", action="store_true",
                   help="the query scheduler's view instead: lane "
                        "table (weights, depths, queue-wait "
                        "percentiles) + admission/coalesce/affinity "
                        "counters")
    p.add_argument("--placement", action="store_true",
                   help="the leader's live placement table instead: "
                        "per-slot owner/state/bytes/heat for every "
                        "sharded set, per-member totals, skew ratio, "
                        "rebalancer status + last-move log")
    p.add_argument("--sessions", action="store_true",
                   help="the stateful-serving view instead: open "
                        "decode sessions (owner, steps), batch "
                        "coalescing stats, arena spill accounting, "
                        "resident-state bytes and the dedup page "
                        "attribution")
    p.add_argument("--slowlog", action="store_true",
                   help="the persisted slow-query ring instead "
                        "(<root>/slowlog/ — outliers that survived "
                        "ring rotation and restarts)")
    p.add_argument("--explain", default=None, metavar="QID",
                   help="render one traced query's per-operator "
                        "EXPLAIN ANALYZE tree (per-node wall/device "
                        "time, rows, cache + compile counters, %% of "
                        "total); falls back to the slowlog when the "
                        "ring rotated")
    p.add_argument("--openmetrics", action="store_true",
                   help="print the Prometheus text exposition "
                        "(GET_METRICS format=openmetrics) — the "
                        "scrape-endpoint payload, leader-merged")
    p.add_argument("--top", action="store_true",
                   help="live rate view refreshing from the daemon's "
                        "telemetry history deltas (QPS, staged MB/s, "
                        "hit-rate trend, busiest clients)")
    p.add_argument("--iterations", type=int, default=0,
                   help="--top refresh count (0 = until interrupted)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--top refresh period seconds")
    p.add_argument("--json", action="store_true",
                   help="raw JSON instead of the pretty readout")

    p = sub.add_parser("lint",
                       help="static concurrency-correctness analysis "
                            "(netsdb_tpu_torch/analysis/): AST rules — "
                            "lock ordering, blocking-under-lock, "
                            "resource discipline, and every ported "
                            "guard — over the package tree; exit 1 on "
                            "any finding; touches no device")
    p.add_argument("paths", nargs="*",
                   help="explicit files to lint (default: the whole "
                        "netsdb_tpu_torch/ package; per-rule directory "
                        "scoping applies either way)")
    p.add_argument("--rule", action="append", metavar="RULE_ID",
                   help="run only this rule (repeatable)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog (id + rationale)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable diagnostics")
    p.add_argument("--fix", action="store_true",
                   help="auto-apply the mechanical iter-close fixes "
                        "(wrap directly-iterated stream producers in "
                        "contextlib.closing) before reporting; "
                        "idempotent — a second run changes nothing")
    p.add_argument("--dry-run", action="store_true",
                   help="with --fix: print the unified diff instead "
                        "of writing files")
    p.add_argument("--baseline", metavar="FILE", default=None,
                   help="findings ratchet (netsdb_tpu_torch/docs/"
                        "lint_baseline.json): "
                        "findings recorded there are accepted, new "
                        "findings fail, and a stale entry is itself "
                        "a finding — the file only shrinks")
    p.add_argument("--write-baseline", action="store_true",
                   help="with --baseline: record the current "
                        "findings as the new accepted baseline and "
                        "exit")
    p.add_argument("--witness-coverage", metavar="DUMP", default=None,
                   help="reconcile the static lock-order graph with "
                        "a runtime witness dump (utils/locks."
                        "LockWitness.dump; chip_smoke.py phase 23 "
                        "writes one from the card): "
                        "statically-possible-but-never-exercised "
                        "edges report as untested concurrency, "
                        "runtime edges the static graph missed as "
                        "blind spots; always exits 0")

    p = sub.add_parser("autotune",
                       help="measure physical-strategy crossovers "
                       "(dense-vs-scatter segments, LUT-vs-sort joins) on "
                       "the live backend and persist per device kind")
    p.add_argument("--no-persist", action="store_true")

    p = sub.add_parser("transformer-bench",
                       help="set-backed long-context transformer layer "
                       "forward (flash attention), tokens/s + TFLOP/s")
    p.add_argument("--seq", type=int, nargs="+", default=[4096, 8192])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--embed", type=int, default=1024)
    p.add_argument("--heads", type=int, default=8)

    p = sub.add_parser("reddit-bench",
                       help="columnar reddit label propagation at scale")
    p.add_argument("--rows", type=int, default=1_000_000)
    p.add_argument("--authors", type=int, default=50_000)

    p = sub.add_parser("ooc-bench",
                       help="out-of-core TPC-H q01/q06 through the paged "
                       "store under a pool cap")
    p.add_argument("--rows", type=int, default=60_000_000)
    p.add_argument("--pool-mb", type=int, default=1024)

    p = sub.add_parser("paged-api-bench",
                       help="SF10-scale q01 + one-pass grace q03 through "
                            "the SET-API paged path (create_set(storage="
                            "'paged') + suite/q03 sinks) under a pool cap")
    p.add_argument("--rows", type=int, default=60_000_000)
    p.add_argument("--pool-mb", type=int, default=1024)

    p = sub.add_parser("lsh-bench",
                       help="LSH dedup index over a synthetic model zoo")
    p.add_argument("--models", type=int, default=100)

    p = sub.add_parser("ab-bench",
                       help="live placement-advisor A/B (Lachesis loop)")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--advisor", choices=["rule", "drl"], default="rule",
                   help="rule-based bandit or live actor-critic (DRL)")

    args = parser.parse_args(argv)
    try:
        return _COMMANDS[args.cmd](args)
    except NotImplementedError as e:  # a later ROADMAP.md item
        print(f"{parser.prog} {args.cmd}: {e}", file=sys.stderr)
        return 2


_COMMANDS = {
    "info": _cmd_info, "bench": _cmd_bench, "pdml": _cmd_pdml,
    "lint": _cmd_lint, "autotune": _cmd_autotune,
    "transformer-bench": _cmd_transformer_bench,
    "reddit-bench": _cmd_reddit_bench, "ooc-bench": _cmd_ooc_bench,
    "paged-api-bench": _cmd_paged_api_bench, "lsh-bench": _cmd_lsh_bench,
    "ab-bench": _cmd_ab_bench, "serve": _cmd_serve,
    "serve-bench": _cmd_serve_bench, "obs": _cmd_obs,
    "demo-ff": _cmd_demo_ff, "tpch": _cmd_tpch,
    "micro-bench": _cmd_micro_bench, "tpch-bench": _cmd_tpch_bench,
    "model-bench": _cmd_model_bench,
    "attention-bench": _cmd_attention_bench,
    "la-bench": _cmd_la_bench, "conv-bench": _cmd_conv_bench,
    "selftest": _cmd_selftest}


if __name__ == "__main__":
    sys.exit(main())
