"""Runtime micro-benchmarks — the port's ``netsdb_tpu/workloads/
micro_bench.py`` (the reference's serviceBenchmarks family).

``src/serviceBenchmarks/source`` times four substrate pieces in
isolation: allocator throughput (``AllocationTest.cc``), int- and
string-keyed hash-map inserts (``HashMapTest.cc``,
``StringHashMapTest.cc``), and the shuffle write path
(``ShuffleTest.cc``). The equivalents here time the port's building
blocks: the native arena (pagestore), host group-by, keyed aggregation on
the device (``index_add_``, what ``jax.ops.segment_sum`` was), and the
all-to-all resharding over the mesh's positions (what the shuffle
became).

Each benchmark of :data:`BENCHMARKS` returns ``(ops, seconds,
ops_per_sec)``; ``run_all`` prints one line per benchmark. The mode
benches (``bench_staging`` … ``bench_summa``) return the reference's
payloads, key for key. Everything runs on ``device`` (the card unless
the caller asks for the CPU), and every timed section ends by waiting
for the device (a synchronise, or a scalar read as the reference's
``float(jnp.sum(...))``): otherwise it would time the enqueue, not the
work. Where the reference counts XLA traces of one jitted step, the port
counts the new signatures of one :class:`~netsdb_tpu_torch.plan.
programs.Program` — a CUDA graph captured per signature on the card, a
first build on the CPU. Used by the CLI (``micro-bench``) and by
``chip_smoke.py`` phase 24.
"""

from __future__ import annotations

import contextlib
import shutil
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.config import resolve_device

Result = Tuple[int, float, float]

N_KEYS = 4096  # the fold benches' group count (the reference's n_keys)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(n_ops: int, fn: Callable[[], None]) -> Result:
    """``fn`` once on the host clock; a device bench's ``fn`` ends with a
    scalar read, so the device's work is inside."""
    t0 = time.perf_counter()
    fn()
    dt = max(time.perf_counter() - t0, 1e-9)
    return n_ops, dt, n_ops / dt


def _med(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


def _paired(one: Callable[[bool], float], repeats: int) -> Dict[str, float]:
    """The reference's paired A/B: the arms alternate which runs first
    within each repeat (a monotone drift cannot bias the deltas); the
    median off time, the median delta and the deltas' IQR."""
    pairs = []
    for i in range(repeats):
        if i % 2 == 0:
            off = one(False)
            on = one(True)
        else:
            on = one(True)
            off = one(False)
        pairs.append((off, on))
    off_med = _med([u for u, _ in pairs])
    deltas = sorted(t - u for u, t in pairs)
    return {"off": off_med, "delta": _med(deltas),
            "q1": _med(deltas[:len(deltas) // 2 + 1]),
            "q3": _med(deltas[len(deltas) // 2:])}


def arena_backend() -> str:
    """``"native"`` when the native page arena (``native/pagestore.cpp``)
    builds and loads, else ``"python"`` (the reference's host bytearray
    fallback)."""
    from netsdb_tpu_torch.native import pagestore

    try:
        pagestore._load()
    except Exception:  # noqa: BLE001 — a failed build means the fallback
        return "python"
    return "native"


def bench_arena_alloc(n: int = 20_000, size: int = 4096,
                      pool_mb: int = 64,
                      info: Optional[Dict[str, Any]] = None) -> Result:
    """Native arena page write/free churn — ``AllocationTest.cc`` /
    ``SlabAllocator`` role. Falls back to a host bytearray pool (as the
    reference does) when the native library cannot be built; ``info``
    receives ``backend``: which of the two ran."""
    payload = bytes(size)
    backend = arena_backend()
    if info is not None:
        info["backend"] = backend
    if backend == "native":
        from netsdb_tpu_torch.native.pagestore import NativePageStore

        with tempfile.TemporaryDirectory() as d:
            store = NativePageStore(pool_bytes=pool_mb << 20, spill_dir=d)
            store.create_set(1)

            def run():
                live: List[int] = []
                for _ in range(n):
                    live.append(store.write_page(1, payload))
                    if len(live) > 64:  # bounded live set → free-list churn
                        store.free_page(live.pop(0))
                for h in live:
                    store.free_page(h)

            res = _timed(n, run)
            store.close()
            return res

    def run():
        live: List[bytearray] = []
        for _ in range(n):
            live.append(bytearray(size))
            if len(live) > 64:
                live.pop(0)

    return _timed(n, run)


def bench_int_groupby(n: int = 1_000_000, keys: int = 10_000) -> Result:
    """Int-keyed hash aggregation on the host — ``HashMapTest.cc``'s
    unordered_map insert loop (what CombinerProcessor did per page)."""
    ks = np.random.default_rng(0).integers(0, keys, n).tolist()

    def run():
        acc: Dict[int, int] = {}
        for k in ks:
            acc[k] = acc.get(k, 0) + 1

    return _timed(n, run)


def bench_string_groupby(n: int = 300_000, keys: int = 10_000) -> Result:
    """String-keyed variant — ``StringHashMapTest.cc``."""
    ks = [str(x) for x in
          np.random.default_rng(1).integers(0, keys, n).tolist()]

    def run():
        acc: Dict[str, int] = {}
        for k in ks:
            acc[k] = acc.get(k, 0) + 1

    return _timed(n, run)


def segment_sum_inputs(n: int, keys: int, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The segment-sum bench's (segment ids, values) on ``device``, drawn
    as the reference draws them (seed 2; ids, then f32 values)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(2)
    seg = torch.from_numpy(rng.integers(0, keys, n)).to(dev)
    val = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    return seg, val


def segment_sum(seg: torch.Tensor, val: torch.Tensor,
                keys: int) -> torch.Tensor:
    """Per-key sums of ``val`` (``jax.ops.segment_sum``): one
    ``index_add_`` into ``keys`` zeros."""
    return torch.zeros(keys, dtype=val.dtype, device=val.device
                       ).index_add_(0, seg, val)


def bench_segment_sum(n: int = 1_000_000, keys: int = 10_000,
                      device=None) -> Result:
    """The same keyed aggregation where it runs in this framework: on the
    device — the path that replaces the host hash map for tensor
    aggregations. The timed call ends with a scalar read."""
    seg, val = segment_sum_inputs(n, keys, device)
    float(segment_sum(seg, val, keys).sum())  # warm + sync

    def run():
        float(segment_sum(seg, val, keys).sum())

    return _timed(n, run)


def shuffle_mesh(device=None):
    """The shuffle bench's 1-d ``data`` mesh: every visible position of
    ``device``'s type (the virtual positions while ``virtual_devices`` is
    active)."""
    from netsdb_tpu_torch.parallel.mesh import make_mesh, visible_devices

    dev = resolve_device(device)
    devices = visible_devices(dev.type)
    return make_mesh((len(devices),), ("data",), devices=devices)


def shuffle_inputs(mesh, elems_per_dev: int) -> torch.Tensor:
    """``(positions, elems)`` f32 ``arange`` on the mesh's first device
    (the reference's input)."""
    n_dev = mesh.size
    return torch.arange(n_dev * elems_per_dev, dtype=torch.float32,
                        device=mesh.devices.flat[0]
                        ).reshape(n_dev, elems_per_dev)


def shuffle(x: torch.Tensor, mesh):
    """``x`` sharded on dim 0 over ``data``, resharded onto dim 1 with
    one all-to-all (``parallel/collectives.all_to_all_resharding``)."""
    from netsdb_tpu_torch.parallel.collectives import all_to_all_resharding

    return all_to_all_resharding(x, mesh, "data", from_dim=0, to_dim=1)


def _sharded_sum(st) -> float:
    """The logical tensor's sum, read as one scalar (the reference's
    ``float(jnp.sum(...))`` over a sharded array)."""
    from netsdb_tpu_torch.parallel.mesh import move

    dev = st.device
    total = None
    for idx in st.distinct_positions():
        s = move(st.shards[idx].sum(), dev)
        total = s if total is None else total + s
    return float(total)


def bench_shuffle(elems_per_dev: int = 1 << 16, device=None) -> Result:
    """All-to-all resharding over the mesh's positions — ``ShuffleTest.
    cc``'s role (the ShuffleSink/combiner/snappy/TCP path became one
    collective)."""
    mesh = shuffle_mesh(device)
    x = shuffle_inputs(mesh, elems_per_dev)
    _sharded_sum(shuffle(x, mesh))  # warm + sync
    total = mesh.size * elems_per_dev

    def run():
        _sharded_sum(shuffle(x, mesh))

    return _timed(total, run)


def bench_planner(n: int = 2_000) -> Result:
    """Plan build + textual dump + re-parse round-trips on a
    selection⋈join DAG — the reference's ``src/optimizerBenchmark``
    (MovieStar⋈StarsIn TCAP generation/optimization experiments). Times
    the planner substrate itself, not query execution."""
    from netsdb_tpu_torch.plan.computations import (Aggregate, Filter, Join,
                                                    ScanSet, WriteSet)
    from netsdb_tpu_torch.plan.parser import parse_plan
    from netsdb_tpu_torch.plan.planner import plan_from_sinks

    def build():
        movies = ScanSet("mdb", "movies")
        stars = ScanSet("mdb", "starsin")
        sel = Filter(movies, lambda m: True, label="SimpleMovieSelection")
        j = Join(sel, stars, left_key=lambda m: m["title"],
                 right_key=lambda s: s["movie"], label="SimpleMovieJoin")
        agg = Aggregate(j, key=lambda p: p[0]["title"], value=lambda p: 1,
                        combine=lambda a, b: a + b, label="countStars")
        return WriteSet(agg, "mdb", "out")

    def run():
        for _ in range(n):
            plan = plan_from_sinks([build()])
            parse_plan(plan.to_plan_string())

    return _timed(n, run)


def _fold_columns(rng, n: int, full: bool) -> Dict[str, np.ndarray]:
    """The q01-shaped fold's columns, drawn in the reference's order."""
    fc = {
        "k": rng.integers(0, N_KEYS, n, dtype=np.int32),
        "qty": rng.uniform(1.0, 50.0, n).astype(np.float32),
        "price": rng.uniform(1.0, 100.0, n).astype(np.float32),
    }
    if full:
        fc["disc"] = rng.uniform(0.0, 0.1, n).astype(np.float32)
        fc["tax"] = rng.uniform(0.0, 0.08, n).astype(np.float32)
    return fc


def _fold3_step(acc, k, qty, price, valid):
    """Three masked per-key sums (qty, price, count) into ``acc``."""
    seg = torch.where(valid, k, 0).long()
    vals = torch.stack([qty, price, torch.ones_like(price)], dim=1)
    vals = torch.where(valid[:, None], vals, 0.0)
    return acc.index_add(0, seg, vals)


def _fold3_runner(pc, device: torch.device, key: str):
    """``run_once`` of the overhead benches: the warmed q01-shaped fold
    over ``pc``'s staged stream through one program, ending with a host
    read of the state (the reference's ``np.asarray(acc)``)."""
    from netsdb_tpu_torch.plan.programs import Program

    step = Program(key, lambda: None)

    def run_once():
        acc = torch.zeros((N_KEYS, 3), dtype=torch.float32, device=device)
        with contextlib.closing(pc.stream()) as chunks:
            for ccols, valid, _start in chunks:
                acc = step(_fold3_step, acc, ccols["k"], ccols["qty"],
                           ccols["price"], valid)
        acc.cpu()

    return run_once


def bench_staging(rows: int = 65_536, cols: int = 1024,
                  rhs_cols: int = 256, page_rows: int = 4096,
                  pool_mb: int = 32, fold_rows: int = 2_000_000,
                  repeats: int = 3, device=None) -> Dict[str, object]:
    """Overlapped vs synchronous device staging on the two out-of-core
    hot paths (the ``--staging`` mode of the CLI):

    * **blocked matmul** — ``PagedTensorStore.matmul_streamed`` with the
      matrix spilling (pool < matrix), ``stage_depth=0`` (every upload
      synchronous, prefetch off — the pre-staging executor) vs the
      staged pipeline (host read-ahead + background device stage). Warms
      once, then times the best of ``repeats`` runs.
    * **fold stream** — a masked segment-sum fold over a sequence of
      paged relations with differing row counts, timed cold per run (a
      fresh program per configuration, like a fresh daemon's step
      cache): the exact-shape baseline builds a variant per ingest size
      inside the timed region while the bucketed path builds one. Best
      of ``repeats`` whole rounds.

    ``*_speedup`` is sync/staged; ``*_traces`` counts the shared step's
    new signatures (captures on the card)."""
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.plan.programs import Program
    from netsdb_tpu_torch.plan.staging import bucket_rows
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.storage.paged import PagedTensorStore

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    root = tempfile.mkdtemp(prefix="staging_bench_")
    out: Dict[str, object] = {"rows": rows, "cols": cols,
                              "rhs_cols": rhs_cols,
                              "fold_rows": fold_rows}
    cfg = Configuration(root_dir=root,
                        page_size_bytes=page_rows * cols * 4)
    store = PagedTensorStore(cfg, pool_bytes=pool_mb << 20)
    try:
        m = rng.standard_normal((rows, cols)).astype(np.float32)
        rhs = torch.from_numpy(rng.standard_normal(
            (cols, rhs_cols)).astype(np.float32)).to(dev)
        store.put("m", m, row_block=page_rows)
        out["matrix_mb"] = m.nbytes >> 20
        out["pool_mb"] = pool_mb
        del m

        def timed_mm(depth: int, prefetch: int) -> float:
            cfg.stream_prefetch_pages = prefetch
            store.matmul_streamed("m", rhs, stage_depth=depth)  # warm
            _sync(dev)
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                store.matmul_streamed("m", rhs, stage_depth=depth)
                _sync(dev)
                best = min(best, time.perf_counter() - t0)
            return best

        out["matmul_sync_s"] = round(timed_mm(0, 0), 4)
        out["matmul_staged_s"] = round(timed_mm(2, 2), 4)
        out["matmul_speedup"] = round(
            out["matmul_sync_s"] / out["matmul_staged_s"], 2)

        # fold stream: a q01-shaped multi-aggregate chunk step (five
        # weighted per-key sums + a count) over a SEQUENCE of paged
        # relations with differing row counts — 12 ingest sizes spread
        # ±8% around a base chosen so they all land in ONE bucket: the
        # exact-shape baseline builds once PER SIZE, the bucketed path
        # once in all
        base = int(fold_rows * 0.1125)
        bucket = bucket_rows(base)
        sizes = sorted({min(int(base * (0.92 + 0.15 * i / 11)), bucket)
                        for i in range(12)})
        rels = []
        for i, n in enumerate(sizes):
            rels.append(PagedColumns.ingest(
                store, f"fold{i}", _fold_columns(rng, n, full=True),
                device=dev))
        out["fold_sizes"] = sizes

        def raw_step(acc, k, qty, price, disc, tax, valid):
            seg = torch.where(valid, k, 0).long()
            rev = price * (1.0 - disc)
            vals = torch.stack([qty, price, rev, rev * (1.0 + tax),
                                disc, torch.ones_like(price)], dim=1)
            vals = torch.where(valid[:, None], vals, 0.0)
            return acc.index_add(0, seg, vals)

        def timed_fold(bucketing: bool, depth: int,
                       prefetch: int) -> Tuple[float, int]:
            cfg.shape_bucketing = bucketing
            cfg.stage_depth = depth
            cfg.stream_prefetch_pages = prefetch
            traces = [0]

            def on_trace():
                traces[0] += 1

            # ONE cached step, like the executor's program across serve
            # EXECUTEs
            step = Program("micro_bench.staging.fold", on_trace)
            t0 = time.perf_counter()
            for pc in rels:
                acc = torch.zeros((N_KEYS, 6), dtype=torch.float32,
                                  device=dev)
                with contextlib.closing(pc.stream()) as chunks:
                    for ccols, valid, _start in chunks:
                        acc = step(raw_step, acc, ccols["k"], ccols["qty"],
                                   ccols["price"], ccols["disc"],
                                   ccols["tax"], valid)
                acc.cpu()
            return time.perf_counter() - t0, traces[0]

        best_sync, best_staged = float("inf"), float("inf")
        tr_s = tr_g = 0
        for _ in range(repeats):
            s, tr_s = timed_fold(False, 0, 0)
            g, tr_g = timed_fold(True, 2, 2)
            best_sync, best_staged = min(best_sync, s), min(best_staged, g)
        out["fold_sync_s"] = round(best_sync, 4)
        out["fold_staged_s"] = round(best_staged, 4)
        out["fold_sync_traces"] = tr_s
        out["fold_staged_traces"] = tr_g
        out["fold_speedup"] = round(
            out["fold_sync_s"] / out["fold_staged_s"], 2)
        out["store_stats"] = store.stats()
        out["native"] = store.native
    finally:
        store.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


def bench_bucket_sweep(base: int = 45_000, spread: float = 0.6,
                       samples: int = 48, seed: int = 0,
                       densities: Tuple[int, ...] = (2, 4),
                       device=None) -> Dict[str, object]:
    """Pad-waste vs trace-count per shape-ladder density — the
    ``micro-bench --bucket-sweep`` mode.

    Draws ``samples`` serve-style ingest sizes log-uniformly across
    ±``spread`` octaves around ``base``, then for each
    ``bucket_density``:

    * **pad_waste_pct** — padded rows beyond the valid rows, as a
      fraction of the valid rows (deterministic);
    * **buckets** — distinct bucket shapes the sizes land in;
    * **traces** — the new signatures of one shared program fed each
      bucketed shape (captures on the card): must equal ``buckets``.

    Density 2 is the default ladder {2^k, 3·2^(k-1)}; density 4 adds the
    1.25×/1.75× rungs (<25% worst-case pad, ~2× the builds)."""
    from netsdb_tpu_torch.plan.programs import Program
    from netsdb_tpu_torch.plan.staging import bucket_rows

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sizes = sorted(int(base * (2.0 ** e)) for e in
                   rng.uniform(-spread, spread, samples))
    out: Dict[str, object] = {"base": base, "samples": samples,
                              "spread_octaves": spread,
                              "size_min": sizes[0], "size_max": sizes[-1]}
    for d in densities:
        buckets = [bucket_rows(n, d) for n in sizes]
        valid = sum(sizes)
        padded = sum(buckets)
        distinct = sorted(set(buckets))
        traces = [0]

        def on_trace():
            traces[0] += 1

        step = Program(f"micro_bench.bucket_sweep.d{d}", on_trace)
        for b in buckets:
            # 1-d probes of the real bucketed lengths: the count is
            # shape-driven, not data-driven
            float(step(torch.sum, torch.zeros((b,), dtype=torch.float32,
                                              device=dev)))
        out[f"density{d}"] = {
            "buckets": len(distinct),
            "traces": traces[0],
            "pad_waste_pct": round(100.0 * (padded - valid) / valid, 2),
            "bucket_shapes": distinct,
        }
    return out


def bench_obs_overhead(rows: int = 2_000_000, page_rows: int = 65_536,
                       repeats: int = 15, device=None) -> Dict[str, object]:
    """Cost of always-on query tracing on the staged fold stream — the
    ``--obs-overhead`` mode. The same warmed fold (a q01-shaped masked
    segment-sum over a paged relation, chunks staged through
    ``plan/staging.stage_stream``) runs with no trace installed vs inside
    an ``obs.trace`` (every chunk then pays the span/counter accounting).

    * ``overhead_pct``/``noise_pct`` — end-to-end paired A/B (arms
      alternating within each repeat): the median per-pair delta over
      the median untraced time, and the deltas' IQR.
    * ``accounting_overhead_pct`` — the deterministic bound: the exact
      per-chunk accounting a trace adds on the consumer's path (three
      counter adds), timed in isolation (best of 8) and scaled to this
      stream's chunk count. The < 3% budget is pinned on it.

    ``sampled``: with 1-in-N minting (``obs.sample_qid``) every request
    pays the decision; the accounting lands on 1 in ``sample``."""
    from netsdb_tpu_torch import obs
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.storage.paged import PagedTensorStore

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    root = tempfile.mkdtemp(prefix="obs_bench_")
    cfg = Configuration(root_dir=root)
    store = PagedTensorStore(cfg, pool_bytes=256 << 20)
    out: Dict[str, object] = {"rows": rows, "page_rows": page_rows,
                              "repeats": repeats}
    try:
        pc = PagedColumns.ingest(store, "obsbench",
                                 _fold_columns(rng, rows, full=False),
                                 row_block=page_rows, device=dev)
        out["chunks"] = pc.num_pages()
        run_once = _fold3_runner(pc, dev, "micro_bench.obs")
        run_once()  # build
        run_once()  # warm the page cache / spill state (and capture)

        def one(traced: bool) -> float:
            t0 = time.perf_counter()
            if traced:
                with obs.trace(origin="bench"):
                    run_once()
            else:
                run_once()
            return time.perf_counter() - t0

        ab = _paired(one, repeats)
        untraced, d_med = ab["off"], ab["delta"]
        out["untraced_s"] = round(untraced, 4)
        out["traced_s"] = round(untraced + d_med, 4)
        out["overhead_pct"] = round(100.0 * d_med / untraced, 2)
        out["noise_pct"] = round(
            100.0 * abs(ab["q3"] - ab["q1"]) / untraced, 2)
        prof = obs.DEFAULT_RING.last(1)  # the last traced fold run
        if prof:
            out["trace_counters"] = prof[-1].get("counters", {})

        # deterministic bound: the exact accounting the staged stream adds
        # per chunk on the consumer thread under a trace
        n_acct = 5_000
        trials = []
        with obs.trace(origin="bench") as tr:
            for _ in range(8):  # best of trials: preemption only adds
                t0 = time.perf_counter()
                for _ in range(n_acct):
                    tr.add("stage.chunks")
                    tr.add("stage.bytes", 851968)
                    tr.add("stage.wait_s", 1e-4)
                trials.append((time.perf_counter() - t0) / n_acct)
        per_chunk = min(trials)
        out["accounting_us_per_chunk"] = round(per_chunk * 1e6, 3)
        out["accounting_overhead_pct"] = round(
            100.0 * per_chunk * int(out["chunks"]) / untraced, 4)

        # sampled minting: the per-request decision, then the accounting
        # amortized over 1-in-N traced queries
        sample = 16
        n_mint = 5_000
        mint_trials = []
        for _ in range(8):
            t0 = time.perf_counter()
            for _ in range(n_mint):
                obs.sample_qid(sample)
            mint_trials.append((time.perf_counter() - t0) / n_mint)
        decision_s = min(mint_trials)
        acct_s = per_chunk * int(out["chunks"])
        out["sampled"] = {
            "sample": sample,
            "sample_qid_us": round(decision_s * 1e6, 3),
            "accounting_overhead_pct_sample1": round(
                100.0 * (decision_s + acct_s) / untraced, 4),
            f"accounting_overhead_pct_sample{sample}": round(
                100.0 * (decision_s + acct_s / sample) / untraced, 4),
        }
    finally:
        store.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


class _BenchNode:
    op_kind = "Apply"
    label = "explain-bench"

    def plan_atom(self):
        return "bench <= APPLY(scan, 'explain-bench')"


def bench_explain_overhead(rows: int = 2_000_000,
                           page_rows: int = 65_536,
                           repeats: int = 15,
                           device=None) -> Dict[str, object]:
    """Cost of per-node attribution (``obs/operators.py``) on the staged
    fold stream — the ``--explain-overhead`` mode, built like
    ``--obs-overhead``: the same warmed fold runs with an operator record
    installed (every staged chunk ticks counters on the current node)
    vs bare.

    * ``overhead_pct``/``noise_pct`` — end-to-end paired A/B;
    * ``accounting_overhead_pct`` — the deterministic bound: the three
      ``OpRecord.add`` calls staging pays per chunk with an op captured,
      timed in isolation and scaled to the chunk count (the < 1% budget);
    * ``off_path_ns`` — what every uninstrumented query pays per
      ``op_add`` with no recorder installed (the "~0 when off" claim)."""
    from netsdb_tpu_torch import obs
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.storage.paged import PagedTensorStore

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    root = tempfile.mkdtemp(prefix="explain_bench_")
    cfg = Configuration(root_dir=root)
    store = PagedTensorStore(cfg, pool_bytes=256 << 20)
    out: Dict[str, object] = {"rows": rows, "page_rows": page_rows,
                              "repeats": repeats}
    try:
        pc = PagedColumns.ingest(store, "explbench",
                                 _fold_columns(rng, rows, full=False),
                                 row_block=page_rows, device=dev)
        out["chunks"] = pc.num_pages()
        run_once = _fold3_runner(pc, dev, "micro_bench.explain")
        run_once()
        run_once()

        def one(explained: bool) -> float:
            t0 = time.perf_counter()
            if explained:
                rec = obs.operators.OperatorRecorder("explain-bench")
                with rec.op(0, _BenchNode(), []):
                    run_once()
            else:
                run_once()
            return time.perf_counter() - t0

        ab = _paired(one, repeats)
        off_med, d_med = ab["off"], ab["delta"]
        out["explain_off_s"] = round(off_med, 4)
        out["explain_on_s"] = round(off_med + d_med, 4)
        out["overhead_pct"] = round(100.0 * d_med / off_med, 2)
        out["noise_pct"] = round(
            100.0 * abs(ab["q3"] - ab["q1"]) / off_med, 2)

        n_acct = 5_000
        trials = []
        rec = obs.operators.OperatorRecorder("explain-bench")
        with rec.op(1, _BenchNode(), []) as opr:
            for _ in range(8):
                t0 = time.perf_counter()
                for _ in range(n_acct):
                    opr.add("stage.chunks")
                    opr.add("stage.bytes", 851968)
                    opr.add("stage.wait_s", 1e-4)
                trials.append((time.perf_counter() - t0) / n_acct)
        per_chunk = min(trials)
        out["accounting_us_per_chunk"] = round(per_chunk * 1e6, 3)
        out["accounting_overhead_pct"] = round(
            100.0 * per_chunk * int(out["chunks"]) / off_med, 4)

        # the off path: op_add with no recorder — one context-var read
        off_trials = []
        for _ in range(8):
            t0 = time.perf_counter()
            for _ in range(n_acct):
                obs.operators.op_add("stage.chunks")
            off_trials.append((time.perf_counter() - t0) / n_acct)
        out["off_path_ns"] = round(min(off_trials) * 1e9, 1)
        out["off_path_overhead_pct"] = round(
            100.0 * min(off_trials) * int(out["chunks"]) / off_med, 6)
    finally:
        store.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


def bench_lint_overhead(rows: int = 2_000_000, page_rows: int = 65_536,
                        repeats: int = 15,
                        device=None) -> Dict[str, object]:
    """Cost of the runtime lock-order witness (``utils/locks``) on the
    staged fold stream — the ``--lint-overhead`` mode, built like
    ``--obs-overhead``: the same warmed fold runs with the witness
    installed (every tracked acquisition pays stack + edge bookkeeping)
    vs bare.

    * ``overhead_pct``/``noise_pct`` — end-to-end paired A/B (the < 2%
      budget reads against it and against the bound below);
    * ``accounting_overhead_pct`` — the deterministic bound: one enabled
      acquire+release pair timed in isolation, scaled by the stream's
      measured acquisition count;
    * ``off_path_ns`` — what every acquisition pays with the witness
      off: one module-global read + an is-None check, over the raw
      ``threading.Lock`` floor."""
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.storage.paged import PagedTensorStore
    from netsdb_tpu_torch.utils import locks

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    root = tempfile.mkdtemp(prefix="lint_bench_")
    cfg = Configuration(root_dir=root)
    store = PagedTensorStore(cfg, pool_bytes=256 << 20)
    out: Dict[str, object] = {"rows": rows, "page_rows": page_rows,
                              "repeats": repeats}
    prev_witness = locks.witness()
    locks.disable_witness()
    try:
        pc = PagedColumns.ingest(store, "lintbench",
                                 _fold_columns(rng, rows, full=False),
                                 row_block=page_rows, device=dev)
        out["chunks"] = pc.num_pages()
        run_once = _fold3_runner(pc, dev, "micro_bench.lint")
        run_once()
        run_once()

        def one(witnessed: bool) -> float:
            if witnessed:
                with locks.witness_scope():
                    t0 = time.perf_counter()
                    run_once()
                    return time.perf_counter() - t0
            t0 = time.perf_counter()
            run_once()
            return time.perf_counter() - t0

        ab = _paired(one, repeats)
        off_med, d_med = ab["off"], ab["delta"]
        out["witness_off_s"] = round(off_med, 4)
        out["witness_on_s"] = round(off_med + d_med, 4)
        out["overhead_pct"] = round(100.0 * d_med / off_med, 2)
        out["noise_pct"] = round(
            100.0 * abs(ab["q3"] - ab["q1"]) / off_med, 2)

        # the stream's tracked-acquisition count (one witnessed run)
        with locks.witness_scope() as w:
            run_once()
            out["acquisitions_per_run"] = int(w.report()["acquisitions"])
            out["rank_edges"] = int(w.report()["edges"])

        # deterministic bound: one enabled acquire+release pair in
        # isolation (a held outer lock so the edge path runs), scaled by
        # the measured acquisition count
        n_acct = 5_000
        trials = []
        with locks.witness_scope():
            outer = locks.TrackedLock("lintbench.outer")
            inner = locks.TrackedLock("lintbench.inner")
            with outer:
                for _ in range(8):
                    t0 = time.perf_counter()
                    for _ in range(n_acct):
                        with inner:
                            pass
                    trials.append((time.perf_counter() - t0) / n_acct)
        per_acq = min(trials)
        out["enabled_us_per_acquire"] = round(per_acq * 1e6, 3)
        out["accounting_overhead_pct"] = round(
            100.0 * per_acq * int(out["acquisitions_per_run"])
            / off_med, 4)

        # the off path: the same pair with no witness installed, minus the
        # raw threading.Lock floor = the is-None check's cost
        bare = threading.Lock()
        off_trials, floor_trials = [], []
        probe = locks.TrackedLock("lintbench.off")
        for _ in range(8):
            t0 = time.perf_counter()
            for _ in range(n_acct):
                with probe:
                    pass
            off_trials.append((time.perf_counter() - t0) / n_acct)
            t0 = time.perf_counter()
            for _ in range(n_acct):
                with bare:
                    pass
            floor_trials.append((time.perf_counter() - t0) / n_acct)
        off_ns = max(0.0, (min(off_trials) - min(floor_trials)) * 1e9)
        out["off_path_ns"] = round(off_ns, 1)
        out["off_path_overhead_pct"] = round(
            100.0 * (off_ns / 1e9)
            * int(out["acquisitions_per_run"]) / off_med, 6)
    finally:
        if prev_witness is not None:
            locks._WITNESS = prev_witness
        store.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


def bench_fusion(spine: int = 12, dim_rows: int = 65_536,
                 fact_rows: int = 8_000, fold_rows: int = 2_000_000,
                 page_rows: int = 65_536, repeats: int = 9,
                 inner: int = 3, device=None) -> Dict[str, object]:
    """Fusion-aware plan compilation paired A/B — the ``--fusion`` mode.
    Two workloads, each through the real executor with ``plan_fusion`` on
    vs off (arms alternating within every repeat):

    * **resident spine** (``plan_fusion_speedup``) — a small paged q06
      fold joined against a ``spine``-node Apply chain over a resident
      dimension table: per node the spine pays ``spine+1`` programs and
      cache entries an execution; fused it is one region program.
    * **staged fold stream** (``fold_stream_speedup``) — a 2M-row paged
      fact through a declared-``rowwise`` chunk transform into a
      segment-sum fold with a 2-node epilogue: per node the transform
      demotes the set to a host table; fused, the chunk is transformed
      and reduced in one step and the epilogue is one program.

    The device cache is off, so both arms run the cold-serve path."""
    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.plan import executor
    from netsdb_tpu_torch.plan.computations import (Apply, Join, ScanSet,
                                                    WriteSet)
    from netsdb_tpu_torch.plan.fold import single_pass
    from netsdb_tpu_torch.relational import dag as rdag
    from netsdb_tpu_torch.relational.table import ColumnTable

    del page_rows  # the reference's signature; the fact pages by size
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    root = tempfile.mkdtemp(prefix="fusion_bench_")
    out: Dict[str, object] = {"spine_nodes": spine,
                              "fact_rows": fact_rows,
                              "fold_rows": fold_rows,
                              "repeats": repeats}
    cfg = Configuration(root_dir=root, fusion_cost_source="static",
                        device_cache_bytes=0)
    c = Client(cfg, device=dev)

    def host_table(cols):
        return ColumnTable.from_columns(cols, device="cpu")

    try:
        c.create_database("fz")
        c.create_set("fz", "lineitem", type_name="table",
                     storage="paged")
        c.send_table("fz", "lineitem", host_table({
            "l_shipdate": rng.integers(19940101, 19950101, fact_rows,
                                       dtype=np.int32),
            "l_discount": np.full(fact_rows, 0.06, np.float32),
            "l_quantity": np.full(fact_rows, 10.0, np.float32),
            "l_extendedprice": rng.uniform(1000, 2000, fact_rows
                                           ).astype(np.float32)}))
        c.create_set("fz", "dim", type_name="table")
        c.send_table("fz", "dim", host_table(
            {"x": rng.standard_normal(dim_rows).astype(np.float32)}))

        def spine_sink():
            node = ScanSet("fz", "dim")
            for i in range(spine):
                node = Apply(node, lambda t, _i=i: ColumnTable(
                    {"x": t["x"] * (1.0 + 1e-7 * _i) + 1e-6},
                    t.dicts, t.valid), label=f"spine{i}")
            z = Apply(node, lambda t: torch.sum(t["x"]) * 1e-9,
                      label="zsum")
            q06 = rdag.q06_sink("fz")
            j = Join(q06.inputs[0], z, fn=lambda rev, v: ColumnTable(
                {"revenue": rev["revenue"] + v}, rev.dicts, rev.valid),
                label="combine")
            return WriteSet(j, "fz", "spine_out")

        def run_spine_once():
            # ``inner`` serve-style executions per timed sample: the
            # per-execution dispatch overhead is the measurand
            for _ in range(inner):
                c.execute_computations(spine_sink(),
                                       job_name="fusion-spine",
                                       materialize=False)
            _sync(dev)

        def paired(run_once) -> Dict[str, float]:
            # cold builds per arm (unrecorded), then alternating timed
            # pairs — trace counts read off compile_stats deltas
            stats = {}
            for arm, fused in (("fused", True), ("per_node", False)):
                cfg.plan_fusion = fused
                t0 = executor.compile_stats()
                run_once()
                t1 = executor.compile_stats()
                stats[f"{arm}_traces"] = t1["traces"] - t0["traces"]
                stats[f"{arm}_programs"] = t1["misses"] - t0["misses"]
            pairs = []
            for i in range(repeats):
                order = ((True, False) if i % 2 == 0 else (False, True))
                tm = {}
                for fused in order:
                    cfg.plan_fusion = fused
                    t0 = time.perf_counter()
                    run_once()
                    tm[fused] = time.perf_counter() - t0
                pairs.append(tm)
            on = _med([p[True] for p in pairs])
            off = _med([p[False] for p in pairs])
            stats["fused_s"] = round(on, 4)
            stats["per_node_s"] = round(off, 4)
            stats["speedup"] = round(off / on, 2)
            return stats

        out["spine"] = paired(run_spine_once)
        out["plan_fusion_speedup"] = out["spine"]["speedup"]

        # --- 2M-row staged fold stream with rowwise pre + epilogue ------
        nk = N_KEYS
        c.create_set("fz", "fact", type_name="table", storage="paged")
        c.send_table("fz", "fact", host_table({
            "k": rng.integers(0, nk, fold_rows, dtype=np.int32),
            "v": rng.uniform(0.0, 10.0, fold_rows).astype(np.float32)}))

        def fold_sink():
            s = ScanSet("fz", "fact")
            # rowwise derives from the label: "pre:affine" is in the
            # audited ROWWISE_SAFE_LABELS registry
            pre = Apply(s, lambda t: ColumnTable(
                {"k": t["k"], "v": t["v"] * 1.5 + 0.25},
                t.dicts, t.valid), label="pre:affine")

            def init(prev, src):
                return torch.zeros((nk,), dtype=torch.float32,
                                   device=src.device)

            def step(state, chunk):
                m = chunk.mask()
                seg = torch.where(m, chunk["k"], 0).long()
                vals = torch.where(m, chunk["v"], 0.0)
                return state.index_add(0, seg, vals)

            agg = Apply(pre, fold=single_pass(
                init, step, lambda st, src: st), label="segsum")
            e1 = Apply(agg, lambda v: v * 0.5, label="epi:half")
            e2 = Apply(e1, lambda v: v + 1.0, label="epi:shift")
            return WriteSet(e2, "fz", "fold_out")

        def run_fold_once():
            c.execute_computations(fold_sink(), job_name="fusion-fold",
                                   materialize=False)
            _sync(dev)

        out["fold_stream"] = paired(run_fold_once)
        out["fold_stream_speedup"] = out["fold_stream"]["speedup"]
    finally:
        c.store.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


def bench_summa(rows: int = 65_536, k: int = 512, cols: int = 256,
                row_block: int = 4096, participants: int = 4,
                table_rows: int = 200_000, repeats: int = 3,
                device=None) -> Dict[str, object]:
    """Distributed linear algebra paired A/B — the ``--summa`` mode, over
    the visible positions of ``device``'s type (4 virtual positions of one
    card under ``virtual_devices``). Two arms:

    * **SUMMA panels vs replicated operands** — ``M @ rhs`` with M paged.
      The baseline stages every operand to every participant (the
      broadcast-join default); SUMMA stages 1/N per participant and
      broadcasts B panels per step. The headline is the per-host staged
      byte reduction (deterministic); byte-equality between arms is a
      gate (integer-valued f32 operands make it exact).
    * **reshard via collectives vs re-stage from the arena** — a warm
      placed 2-column paged set moves sharded → replicated through
      ``parallel/reshard.reshard_set`` (zero arena reads, proven by the
      page counter) vs dropping the cache and re-staging the whole set
      under the new layout."""
    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.ops.common import full_f32_precision
    from netsdb_tpu_torch.parallel.mesh import visible_devices
    from netsdb_tpu_torch.parallel.placement import Placement
    from netsdb_tpu_torch.parallel.reshard import reshard_set
    from netsdb_tpu_torch.parallel.summa import summa_matmul_streamed
    from netsdb_tpu_torch.relational.outofcore import PagedColumns
    from netsdb_tpu_torch.relational.table import ColumnTable
    from netsdb_tpu_torch.storage.paged import PagedTensorStore
    from netsdb_tpu_torch.storage.store import SetIdentifier

    dev = resolve_device(device)
    devices = list(visible_devices(dev.type))[:participants]
    out: Dict[str, object] = {"participants": len(devices),
                              "rows": rows, "k": k, "cols": cols}
    if len(devices) < 2:
        out["error"] = (f"needs >= 2 devices (have {len(devices)}; "
                        f"enter parallel.mesh.virtual_devices)")
        return out
    n = len(devices)
    root = tempfile.mkdtemp(prefix="summa_bench_")
    pts = c = None
    try:
        rng = np.random.default_rng(0)
        cfg = Configuration(root_dir=root,
                            page_size_bytes=row_block * k * 4)
        pts = PagedTensorStore(cfg, force_python=True)
        m = rng.integers(-8, 8, (rows, k)).astype(np.float32)
        rhs = rng.integers(-8, 8, (k, cols)).astype(np.float32)
        pts.put("m", m, row_block=row_block)
        operand_bytes = m.nbytes + rhs.nbytes
        rhs_t = torch.from_numpy(rhs)
        full_f32_precision()

        def replicated_arm():
            # every participant stages every byte (the broadcast-join
            # placement); one block product per block on the first
            t0 = time.perf_counter()
            rhs_dev = [rhs_t.to(d) for d in devices]
            outs = []
            staged = 0
            with contextlib.closing(pts.stream_blocks("m")) as blocks:
                for _s0, block in blocks:
                    blk = torch.from_numpy(np.array(block))
                    prods = [torch.matmul(blk.to(d), r)
                             for d, r in zip(devices, rhs_dev)]
                    staged += block.nbytes * n  # a replica per host
                    outs.append(prods[0].cpu())
            res = torch.cat(outs, dim=0).numpy()
            return res, time.perf_counter() - t0, \
                staged // n + rhs.nbytes  # per-host staged bytes

        def summa_arm():
            stats: Dict[str, object] = {}
            t0 = time.perf_counter()
            res = summa_matmul_streamed(pts, "m", rhs_t.to(devices[0]),
                                        devices=devices, stats_out=stats)
            res = res.cpu().numpy()
            dt = time.perf_counter() - t0
            per_host = max(stats["staged_bytes_per_participant"].values())
            return res, dt, per_host

        base_res = summa_res = None
        base_t = summa_t = float("inf")
        base_bytes = summa_bytes = 0
        for _ in range(repeats):  # alternate arms; best of
            r, t, by = replicated_arm()
            base_res, base_bytes = r, by
            base_t = min(base_t, t)
            r, t, by = summa_arm()
            summa_res, summa_bytes = r, by
            summa_t = min(summa_t, t)
        byte_equal = base_res.tobytes() == summa_res.tobytes()
        out.update({
            "byte_equal": byte_equal,
            "replicated_s": round(base_t, 4),
            "summa_s": round(summa_t, 4),
            "replicated_per_host_staged_bytes": int(base_bytes),
            "summa_per_host_staged_bytes": int(summa_bytes),
            "per_host_staged_frac": round(summa_bytes / operand_bytes, 4),
            "summa_staging_reduction_x": round(base_bytes / summa_bytes,
                                               2) if summa_bytes else 0,
        })

        # --- reshard via collectives vs re-stage from the arena ---------
        c = Client(Configuration(root_dir=root + "_rs",
                                 page_size_bytes=64 * 1024), device=dev)
        c.create_database("d")
        src = Placement((("data", n),), ("data",))
        dst = Placement((("data", n),), (None,))
        ident = SetIdentifier("d", "t")
        c.create_set("d", "t", type_name="table", storage="paged",
                     placement=src)
        c.send_table("d", "t", ColumnTable.from_columns({
            "k": rng.integers(0, 100, table_rows).astype(np.int32),
            "v": rng.uniform(0, 1, table_rows).astype(np.float32)},
            device="cpu"))
        pc = next(i for i in c.store.get_items(ident)
                  if isinstance(i, PagedColumns))

        def consume(placement):
            with contextlib.closing(
                    pc.stream_tables(placement=placement)) as s:
                for _t in s:
                    pass
            _sync(dev)

        consume(src)  # warm the cache under the source layout
        # alternating cycles: reshard src -> dst via collectives, then the
        # baseline (drop the cache, swap the placement, re-stage from the
        # arena) the other way; best of per arm
        reshard_s = restage_s = float("inf")
        zero_arena = True
        rep = None
        for _i in range(max(int(repeats), 2)):
            pages0 = pc.pages_streamed
            t0 = time.perf_counter()
            rep = reshard_set(c.store, ident, dst)
            consume(dst)  # the warm re-query under the new layout
            reshard_s = min(reshard_s, time.perf_counter() - t0)
            zero_arena = zero_arena and pc.pages_streamed == pages0
            t0 = time.perf_counter()
            c.store.device_cache().invalidate(pc.cache_scope)
            c.store.set_placement(ident, src)
            consume(src)
            restage_s = min(restage_s, time.perf_counter() - t0)
        out.update({
            "table_rows": table_rows,
            "reshard_blocks_moved": rep.blocks_moved,
            "reshard_steps": rep.labels(),
            "reshard_s": round(reshard_s, 4),
            "restage_s": round(restage_s, 4),
            "reshard_zero_arena_reads": zero_arena,
            "reshard_collective_speedup": round(restage_s / reshard_s,
                                                2) if reshard_s else 0,
        })
        return out
    finally:
        if pts is not None:
            pts.close()
        if c is not None:
            c.store.close()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(root + "_rs", ignore_errors=True)


BENCHMARKS: Dict[str, Callable[..., Result]] = {
    "arena_alloc": bench_arena_alloc,
    "int_groupby": bench_int_groupby,
    "string_groupby": bench_string_groupby,
    "segment_sum": bench_segment_sum,
    "shuffle": bench_shuffle,
    "planner": bench_planner,
}

#: the benchmarks of :data:`BENCHMARKS` that run on a device
ON_DEVICE = ("segment_sum", "shuffle")


def run_all(names=None, out=print, device=None) -> Dict[str, Result]:
    """Each named benchmark (default all) once, one printed line each;
    the device benches run on ``device``. The ``arena_alloc`` line names
    the arena backend that ran."""
    results = {}
    for name in (names or BENCHMARKS):
        kw: Dict[str, Any] = {}
        info: Dict[str, Any] = {}
        if name in ON_DEVICE:
            kw["device"] = device
        if name == "arena_alloc":
            kw["info"] = info
        ops, secs, rate = BENCHMARKS[name](**kw)
        results[name] = (ops, secs, rate)
        tail = f" ({info['backend']} arena)" if info else ""
        out(f"{name}: {ops} ops in {secs:.3f}s = {rate:,.0f} ops/s{tail}")
    return results
