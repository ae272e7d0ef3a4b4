"""Served-inference and serving-layer benchmarks — the port's
``netsdb_tpu/workloads/serve_bench.py``.

The reference's serving story: the master loads model weight sets once
and many ``PDBClient`` processes run inference queries against them
concurrently (``src/mainServer/source/MasterMain.cc:64-96``,
``src/queries/headers/QueryClient.h:160-224``). :func:`run_serve_bench`
measures that shape: one resident daemon (owning the device, the weight
sets and the compiled-plan cache), N separate client processes, each
sending its private input set once and then running M inference jobs
whose only per-job wire traffic is the plan. The other ``run_*`` benches
measure the rest of the serving layer — the transfer paths, the device
cache, the scheduler, the shard pool, HA failover, distributed fusion,
rebalancing and decode sessions — each returning the reference's payload
and its gates.

Daemons run on ``device`` (the card unless the caller asks for the CPU):
in process (``ServeController(device=...)``) where the reference runs
them in process, else as ``python -m netsdb_tpu_torch --device D serve
--port 0`` processes whose ``serving on HOST:PORT`` line gives their
address (no port is picked ahead of a spawn). ``python -m
netsdb_tpu_torch.workloads.serve_bench [--worker|--serving|...]`` runs
one bench and prints its JSON; ``chip_smoke.py`` phase 24 runs every
mode on the card. The scale-out workload (:func:`scaleout_table` and its
sinks) is shared with the pool tests and phase 17."""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.plan.computations import Apply, Join, ScanSet, WriteSet
from netsdb_tpu_torch.plan.fold import single_pass, tree_add_states
from netsdb_tpu_torch.relational.table import ColumnTable

BATCH = 16384
FEATURES = 1024
HIDDEN = 4096
LABELS = 1024
BLOCK = (512, 512)

#: bounds the wait for a spawned daemon's address line
SPAWN_TIMEOUT_S = 180.0

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _python() -> str:
    """The interpreter for spawned daemons and client workers: the
    packaged one ``NETSDB_VENV_PYTHON`` names, else this one."""
    from netsdb_tpu_torch import _reexec

    return _reexec.VENV if _reexec.VENV and os.path.exists(
        _reexec.VENV) else sys.executable


def _wait_port(host: str, port: int, timeout: float = 120.0) -> None:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        try:
            with socket.create_connection((host, port), timeout=1):
                return
        except OSError:
            time.sleep(0.2)
    raise TimeoutError(f"daemon on {host}:{port} did not come up")


def _device_arg(device) -> str:
    return str(resolve_device(device))


class _Daemon:
    """One ``python -m netsdb_tpu_torch serve --port 0`` process: its
    address comes from the line it prints once it listens; stdout is
    drained after it, stderr goes to ``<root>/daemon.log``."""

    def __init__(self, root: str, device, extra: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None):
        argv = [_python(), "-m", "netsdb_tpu_torch", "--device",
                _device_arg(device), "serve", "--port", "0",
                "--root", os.path.join(root, "db")] + list(extra or [])
        os.makedirs(root, exist_ok=True)
        self.log_path = os.path.join(root, "daemon.log")
        self._log = open(self.log_path, "w")
        self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                     stderr=self._log, text=True, cwd=_REPO,
                                     env=dict(os.environ, **(env or {})))
        self._first = threading.Event()
        self._line = ""
        threading.Thread(target=self._drain, daemon=True).start()
        self.addr = ""

    def _drain(self) -> None:
        for line in self.proc.stdout:
            if not self._first.is_set():
                self._line = line.strip()
                self._first.set()
        self._first.set()

    def wait_ready(self, timeout: float = SPAWN_TIMEOUT_S) -> str:
        self._first.wait(timeout)
        if not self._line.startswith("serving on "):
            self.stop()
            with open(self.log_path) as f:
                tail = f.read()[-4000:]
            raise RuntimeError(f"daemon did not come up (rc="
                               f"{self.proc.poll()}): {self._line!r}\n{tail}")
        self.addr = self._line.split()[-1]
        return self.addr

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self._log.close()


def _spawn(root: str, device, extra: Optional[List[str]] = None,
           env: Optional[Dict[str, str]] = None) -> _Daemon:
    d = _Daemon(root, device, extra, env)
    d.wait_ready()
    return d


def _host(x) -> np.ndarray:
    """A result read to the host (a tensor, a blocked tensor, an array)."""
    if hasattr(x, "to_dense"):
        x = x.to_dense()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _lineitem_cols(rows: int, rng) -> Dict[str, np.ndarray]:
    """The float q01 ``lineitem`` columns, drawn in the reference's
    order."""
    return {
        "l_shipdate": rng.integers(19920101, 19981231, rows,
                                   dtype=np.int32),
        "l_returnflag": rng.integers(0, 3, rows, dtype=np.int32),
        "l_linestatus": rng.integers(0, 2, rows, dtype=np.int32),
        "l_quantity": rng.integers(1, 51, rows,
                                   dtype=np.int32).astype(np.float32),
        "l_extendedprice": rng.uniform(1000, 100000,
                                       rows).astype(np.float32),
        "l_discount": rng.uniform(0, 0.1, rows).astype(np.float32),
        "l_tax": rng.uniform(0, 0.08, rows).astype(np.float32),
    }


_LI_DICTS = {"l_returnflag": ["A", "N", "R"], "l_linestatus": ["F", "O"]}


def _table(cols: Dict[str, np.ndarray], dicts=None) -> ColumnTable:
    """Host columns as a table of CPU tensors (a send ships them)."""
    return ColumnTable({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in cols.items()}, dict(dicts or {}), None)


def load_model(address: str, db: str = "ffserve", seed: int = 0,
               features: int = FEATURES, hidden: int = HIDDEN,
               labels: int = LABELS) -> None:
    """Load the FF weight sets into the daemon ONCE (ref ff::setup +
    loadMatrix). Thin-client RPC only, no device work here."""
    from netsdb_tpu_torch.serve.client import RemoteClient

    c = RemoteClient(address)
    rng = np.random.default_rng(seed)
    c.create_database(db)
    for s in ("w1", "b1", "wo", "bo"):
        c.create_set(db, s)
    c.send_matrix(db, "w1",
                  rng.standard_normal((hidden, features)).astype(np.float32)
                  * np.sqrt(2.0 / features), BLOCK)
    c.send_matrix(db, "b1",
                  (rng.standard_normal((hidden, 1)) * 0.01).astype(np.float32),
                  (BLOCK[0], 1))
    c.send_matrix(db, "wo",
                  rng.standard_normal((labels, hidden)).astype(np.float32)
                  * np.sqrt(2.0 / hidden), BLOCK)
    c.send_matrix(db, "bo",
                  (rng.standard_normal((labels, 1)) * 0.01).astype(np.float32),
                  (BLOCK[0], 1))
    c.close()


def run_client_worker(address: str, client_id: int, jobs: int,
                      batch: int = BATCH, db: str = "ffserve",
                      features: int = FEATURES) -> Dict[str, Any]:
    """One client process: send a private input set once, then run
    ``jobs`` inference jobs against the resident weights. Returns timing;
    also printed as JSON when run via ``--worker``."""
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.serve.client import RemoteClient

    c = RemoteClient(address)
    inp = f"inputs_c{client_id}"
    out = f"output_c{client_id}"
    rng = np.random.default_rng(client_id)
    c.create_set(db, inp)
    c.create_set(db, out)
    t_load0 = time.perf_counter()
    c.send_matrix(db, inp,
                  rng.standard_normal((batch, features)).astype(np.float32),
                  BLOCK)
    load_s = time.perf_counter() - t_load0

    model = FFModel(db=db, block=BLOCK)
    sink = model.build_inference_dag(input_set=inp, output_set=out)
    # warmup: the first jobs build (and on the card capture) the plan's
    # program, shared across clients through the canonical signature
    c.execute_computations(sink, job_name="ff-serve", fetch_results=False)
    lat: List[float] = []
    t_start = time.time()  # epoch: lets the parent compute the union
    t0 = time.perf_counter()
    for _ in range(jobs):
        t1 = time.perf_counter()
        c.execute_computations(sink, job_name="ff-serve",
                               fetch_results=False)
        lat.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    c.close()
    lat.sort()
    return {
        "client_id": client_id, "jobs": jobs, "batch": batch,
        "wall_s": wall, "input_load_s": load_s,
        "t_start": t_start, "t_end": t_start + wall,
        "job_p50_s": lat[len(lat) // 2],
        "job_p90_s": lat[int(len(lat) * 0.9)],
        "rows_per_sec": jobs * batch / wall,
    }


def run_serve_bench(clients: int = 2, jobs_per_client: int = 8,
                    batch: int = BATCH, port: int = 0,
                    platform: Optional[str] = None,
                    daemon_env: Optional[Dict[str, str]] = None,
                    device=None) -> Dict[str, Any]:
    """Spawn (``port=0``) or reuse a daemon, load the weights once, run N
    concurrent client PROCESSES, aggregate. ``platform`` (the reference's
    jax platform) names the spawned daemon's device and wins over
    ``device``."""
    dev_arg = _device_arg(platform or device)  # raises without a card
    host = "127.0.0.1"
    daemon: Optional[_Daemon] = None
    root = tempfile.mkdtemp(prefix="netsdb_serve_bench_")
    try:
        if port == 0:
            daemon = _spawn(root, dev_arg, env=daemon_env)
            address = daemon.addr
        else:
            address = f"{host}:{port}"
            _wait_port(host, port)
        load_model(address)

        procs = []
        t0 = time.perf_counter()
        for i in range(clients):
            procs.append(subprocess.Popen(
                [_python(), "-m", "netsdb_tpu_torch.workloads.serve_bench",
                 "--worker", "--address", address, "--client-id", str(i),
                 "--jobs", str(jobs_per_client), "--batch", str(batch),
                 "--device", dev_arg],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=_REPO))
        results = []
        for p in procs:
            out_text, err_text = p.communicate(timeout=1800)
            if p.returncode != 0:
                raise RuntimeError(f"client worker failed rc={p.returncode}:"
                                   f"\n{err_text[-4000:]}")
            results.append(json.loads(out_text.strip().splitlines()[-1]))
        wall = time.perf_counter() - t0

        from netsdb_tpu_torch.serve.client import RemoteClient

        c = RemoteClient(address)
        stats = c.collect_stats()
        server_jobs = [j for j in c.list_jobs() if j["name"] == "ff-serve"]
        elapsed = sorted(j["elapsed"] for j in server_jobs
                         if j["elapsed"] is not None)
        c.close()
        total_rows = sum(r["jobs"] * r["batch"] for r in results)
        # measurement window = union of the clients' job loops (spawn,
        # import and the warmup build excluded: steady-state serving)
        window = max(r["t_end"] for r in results) - min(
            r["t_start"] for r in results)
        return {
            "clients": clients, "jobs_per_client": jobs_per_client,
            "batch": batch,
            "aggregate_rows_per_sec": total_rows / window,
            "measurement_window_s": window,
            "wall_s_incl_spawn": wall,
            "per_client": results,
            "server_jobs_done": sum(j["status"] == "done"
                                    for j in server_jobs),
            "server_job_elapsed_p50":
                elapsed[len(elapsed) // 2] if elapsed else None,
            "cache_stats": stats.get("cache"),
        }
    finally:
        if daemon is not None:
            daemon.stop()
        shutil.rmtree(root, ignore_errors=True)


def _in_process(cfg, device, **kw):
    """A started in-process daemon on ``device``."""
    from netsdb_tpu_torch.serve.server import ServeController

    ctl = ServeController(cfg, port=0, device=resolve_device(device), **kw)
    ctl.start()
    return ctl


def run_stream_bench(rows: int = 50_000, row_bytes: int = 2000,
                     tensor_mb: int = 128, device=None) -> Dict[str, Any]:
    """Transfer-path comparison on loopback: single-frame SCAN_SET /
    GET_TENSOR (whole payload held twice on each end) vs the streamed
    forms (bounded continuation frames). Throughput should be comparable
    — the point of streaming is the memory bound, reported as the largest
    single frame each path holds."""
    resolve_device(device)  # without a card only the CPU, when asked
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.serve.client import RemoteClient

    root = tempfile.mkdtemp(prefix="stream_bench_")
    ctl = _in_process(Configuration(root_dir=root), device)
    out: Dict[str, Any] = {}
    try:
        c = RemoteClient(f"127.0.0.1:{ctl.port}")
        c.create_database("b")
        c.create_set("b", "objs", type_name="object")
        pad = "x" * row_bytes
        c.send_data("b", "objs", [{"i": i, "p": pad} for i in range(rows)])
        obj_bytes = rows * (row_bytes + 50)

        t0 = time.perf_counter()
        n1 = len(list(c.get_set_iterator("b", "objs")))
        t_single = time.perf_counter() - t0
        t0 = time.perf_counter()
        n2 = sum(1 for _ in c.scan_stream("b", "objs",
                                          max_frame_bytes=4 << 20))
        t_stream = time.perf_counter() - t0
        if not n1 == n2 == rows:
            raise RuntimeError(f"scan returned {n1} / {n2} of {rows} rows")
        out["scan"] = {
            "payload_mb": round(obj_bytes / 2**20, 1),
            "single_frame_s": round(t_single, 3),
            "streamed_s": round(t_stream, 3),
            "single_peak_frame_mb": round(obj_bytes / 2**20, 1),
            "streamed_peak_frame_mb": 4,
            "streamed_mb_per_s": round(obj_bytes / 2**20 / t_stream, 1),
        }

        side = int((tensor_mb * 2**20 / 4) ** 0.5) // 128 * 128
        dense = np.random.default_rng(0).standard_normal(
            (side, side)).astype(np.float32)
        c.create_set("b", "w")
        c.send_matrix("b", "w", dense, (512, 512))
        t0 = time.perf_counter()
        a1 = _host(c.get_tensor("b", "w"))
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        a2 = _host(c.get_tensor_chunked("b", "w", chunk_bytes=8 << 20))
        t_chunk = time.perf_counter() - t0
        if not np.array_equal(a1, a2):
            raise RuntimeError("the chunked pull differs from the single "
                               "frame")
        out["tensor"] = {
            "payload_mb": round(dense.nbytes / 2**20, 1),
            "single_frame_s": round(t_one, 3),
            "chunked_s": round(t_chunk, 3),
            "chunked_peak_frame_mb": 8,
            "chunked_mb_per_s": round(dense.nbytes / 2**20 / t_chunk, 1),
        }
        c.close()
    finally:
        ctl.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    return out


def run_data_plane_bench(table_mb: int = 64, chunk_mb: int = 8,
                         window: int = 4, hedge_reads: int = 40,
                         device=None) -> Dict[str, Any]:
    """Data-plane numbers on loopback: bulk-table ingest MB/s for the
    single-frame path vs the streamed pipelined path (row-range column
    slices riding out-of-band segments, ``window`` chunks in flight),
    streamed scan MB/s, tensor push/pull MB/s over the zero-copy framing,
    and hedged-read p99 against a tail-latency-injected primary.

    The daemon is a real process (pipelining only overlaps client
    encode/send with server decode/apply when the two sides do not share
    a GIL); the stalling primary runs in process."""
    resolve_device(device)  # without a card only the CPU, when asked
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.serve.chaos import ChaosInjector
    from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy

    out: Dict[str, Any] = {"table_mb": table_mb, "chunk_mb": chunk_mb,
                           "window": window}
    nrows = table_mb * (1 << 20) // 8  # two f32/int32 columns per row
    cols = {"a": np.arange(nrows, dtype=np.int32),
            "b": np.random.default_rng(0).standard_normal(nrows)
            .astype(np.float32)}
    table = _table(cols)
    payload_mb = sum(c.nbytes for c in cols.values()) / 2**20

    root = tempfile.mkdtemp(prefix="dataplane_bench_")
    daemon = _spawn(os.path.join(root, "d"), device)
    try:
        c = RemoteClient(daemon.addr, ingest_window=window,
                         ingest_chunk_bytes=chunk_mb << 20)
        c.create_database("b")

        def ingest(set_name: str, pipeline: bool, repeats: int = 2) -> float:
            """Best-of-N wall time of one full ingest."""
            best = None
            for r in range(repeats):
                name = f"{set_name}{r}"
                c.create_set("b", name, type_name="table")
                t0 = time.perf_counter()
                c.send_table("b", name, table, pipeline=pipeline)
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            return best

        ingest("warm", True, repeats=1)  # allocation warmup, excluded
        t_single = ingest("single", False)
        t_stream = ingest("streamed", True)
        out["ingest"] = {
            "payload_mb": round(payload_mb, 1),
            "single_frame_s": round(t_single, 3),
            "single_frame_mb_per_s": round(payload_mb / t_single, 1),
            "streamed_s": round(t_stream, 3),
            "streamed_mb_per_s": round(payload_mb / t_stream, 1),
            "speedup": round(t_single / t_stream, 2),
        }

        t0 = time.perf_counter()
        back = c.get_table_streamed("b", "streamed0",
                                    max_frame_bytes=chunk_mb << 20)
        t_scan = time.perf_counter() - t0
        if back.num_rows != nrows:
            raise RuntimeError(f"streamed scan: {back.num_rows} of {nrows}")
        out["scan"] = {"streamed_s": round(t_scan, 3),
                       "streamed_mb_per_s": round(payload_mb / t_scan, 1)}

        side = int((table_mb * (1 << 20) / 4) ** 0.5) // 128 * 128
        dense = np.random.default_rng(1).standard_normal(
            (side, side)).astype(np.float32)
        c.create_set("b", "w")
        t0 = time.perf_counter()
        c.send_matrix("b", "w", dense, (512, 512))
        t_push = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = _host(c.get_tensor("b", "w"))
        t_pull = time.perf_counter() - t0
        if got.shape != dense.shape:
            raise RuntimeError(f"pulled {got.shape}, sent {dense.shape}")
        mb = dense.nbytes / 2**20
        out["tensor"] = {
            "payload_mb": round(mb, 1),
            "push_mb_per_s": round(mb / t_push, 1),
            "pull_mb_per_s": round(mb / t_pull, 1),
        }
        c.close()

        # hedged reads: the daemon above as the replica, a primary whose
        # replies stall with seeded probability — p99 with hedging should
        # sit near the replica RTT, not the injected stall
        pchaos = ChaosInjector(seed=7, delay=0.25, delay_s=0.15)
        slow = _in_process(Configuration(root_dir=os.path.join(
            root, "slow")), device, chaos=pchaos)
        try:
            small = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
            for addr in (f"127.0.0.1:{slow.port}", daemon.addr):
                boot = RemoteClient(addr)
                boot.create_database("h")
                boot.create_set("h", "w")
                boot.send_matrix("h", "w", small, (32, 32))
                boot.close()

            def read_p99(client) -> Dict[str, float]:
                lat = []
                for _ in range(hedge_reads):
                    t0 = time.perf_counter()
                    client.get_tensor("h", "w")
                    lat.append(time.perf_counter() - t0)
                lat.sort()
                return {"p50_ms": round(lat[len(lat) // 2] * 1e3, 2),
                        "p99_ms": round(lat[int(0.99 * (len(lat) - 1))]
                                        * 1e3, 2)}

            plain = RemoteClient(f"127.0.0.1:{slow.port}",
                                 retry=RetryPolicy(max_attempts=2))
            unhedged = read_p99(plain)
            plain.close()
            hedged_c = RemoteClient(f"127.0.0.1:{slow.port}",
                                    replicas=[daemon.addr],
                                    hedge_delay_s=0.02,
                                    retry=RetryPolicy(max_attempts=2))
            hedged = read_p99(hedged_c)
            out["hedged_reads"] = {
                "injected_stall_ms": 150, "stall_rate": 0.25,
                "unhedged": unhedged, "hedged": hedged,
                "hedges_issued": hedged_c.hedges_issued,
                "hedges_won": hedged_c.hedges_won,
            }
            hedged_c.close()
        finally:
            slow.shutdown()
    finally:
        daemon.stop()
        shutil.rmtree(root, ignore_errors=True)
    return out


def run_device_cache_bench(rows: int = 1_200_000, page_rows: int = 65_536,
                           pool_mb: int = 8, repeats: int = 4,
                           cache_mb: int = 256,
                           device=None) -> Dict[str, Any]:
    """Cold vs warm EXECUTE latency for a q01-style query over a
    device-cache-resident paged set — the buffer-pool payoff measured at
    the serve surface (``--device-cache``). One in-process daemon owns a
    paged ``lineitem`` whose arena pool is far smaller than the table:

    * **uncached** — cache budget 0: every EXECUTE re-reads the arena,
      re-pads and re-uploads each chunk (the first run also builds;
      reported apart). Best of N steady state.
    * **warm** — cache on: one installing run, then best of N warm runs
      that replay device-resident blocks; the cache's miss counter must
      stay flat across them.

    ``speedup`` = uncached steady / warm."""
    resolve_device(device)  # without a card only the CPU, when asked
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.relational import dag as rdag
    from netsdb_tpu_torch.serve.client import RemoteClient

    root = tempfile.mkdtemp(prefix="devcache_bench_")
    cfg = Configuration(root_dir=root,
                        page_size_bytes=page_rows * 4,
                        page_pool_bytes=pool_mb << 20,
                        device_cache_bytes=cache_mb << 20)
    ctl = _in_process(cfg, device)
    out: Dict[str, Any] = {"rows": rows, "pool_mb": pool_mb,
                           "cache_mb": cache_mb}
    try:
        c = RemoteClient(f"127.0.0.1:{ctl.port}")
        cols = _lineitem_cols(rows, np.random.default_rng(0))
        out["table_mb"] = round(sum(v.nbytes for v in cols.values())
                                / 2**20, 1)
        c.create_database("d")
        c.create_set("d", "lineitem", type_name="table", storage="paged")
        c.send_table("d", "lineitem", _table(cols, _LI_DICTS))
        sink = rdag.q01_sink("d")
        cache = ctl.library.store.device_cache()

        def run_once() -> float:
            t0 = time.perf_counter()
            c.execute_computations(sink, job_name="q01-devcache",
                                   fetch_results=False)
            return time.perf_counter() - t0

        # phase 1: cache off — the pre-cache serve data path
        cache.resize(0)
        out["cold_first_s"] = round(run_once(), 4)  # includes the build
        out["uncached_steady_s"] = round(
            min(run_once() for _ in range(repeats)), 4)

        # phase 2: cache on — one installing run, then warm replays
        cache.resize(cache_mb << 20)
        out["install_run_s"] = round(run_once(), 4)
        m0 = cache.stats()["misses"]
        out["warm_s"] = round(min(run_once() for _ in range(repeats)), 4)
        st = cache.stats()
        out["warm_misses_flat"] = (st["misses"] == m0)
        out["speedup_warm_vs_uncached"] = round(
            out["uncached_steady_s"] / out["warm_s"], 2)
        out["cache_stats"] = st
        c.close()
    finally:
        ctl.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    return out


def run_partial_cache_bench(rows: int = 1_200_000,
                            page_rows: int = 65_536,
                            pool_mb: int = 8, cache_mb: int = 256,
                            append_frac: float = 0.01,
                            cycles: int = 3, device=None) -> Dict[str, Any]:
    """Paired A/B for block-granular partial-run caching
    (``--partial-cache``): the warm re-query after a small append,
    partial dirty-range invalidation vs whole-run invalidation. Both arms
    run the same protocol on a fresh in-process daemon: ingest a paged
    q01 ``lineitem``, warm the device cache (install + one warm run),
    then ``cycles`` rounds of: append ``append_frac`` of the rows, time
    one warm re-query. Reported per arm: best-of-cycles warm-after-append
    seconds; plus the partial arm's structural proof — zero evictions of
    pre-append blocks across the appends and ``partial_hits`` > 0.

    ``devcache_partial_speedup`` = whole_run / partial."""
    resolve_device(device)  # without a card only the CPU, when asked
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.relational import dag as rdag
    from netsdb_tpu_torch.serve.client import RemoteClient

    cols = _lineitem_cols(rows, np.random.default_rng(0))
    n_extra = max(int(rows * append_frac), 1)
    out: Dict[str, Any] = {"rows": rows, "pool_mb": pool_mb,
                           "cache_mb": cache_mb,
                           "append_rows": n_extra, "cycles": cycles}

    def arm(partial: bool) -> Dict[str, Any]:
        root = tempfile.mkdtemp(prefix="partial_bench_")
        cfg = Configuration(root_dir=root,
                            page_size_bytes=page_rows * 4,
                            page_pool_bytes=pool_mb << 20,
                            device_cache_bytes=cache_mb << 20,
                            device_cache_partial=partial)
        ctl = _in_process(cfg, device)
        try:
            c = RemoteClient(f"127.0.0.1:{ctl.port}")
            c.create_database("d")
            c.create_set("d", "lineitem", type_name="table",
                         storage="paged")
            c.send_table("d", "lineitem", _table(cols, _LI_DICTS))
            sink = rdag.q01_sink("d")
            cache = ctl.library.store.device_cache()

            def run_once() -> float:
                t0 = time.perf_counter()
                c.execute_computations(sink, job_name="q01-partial",
                                       fetch_results=False)
                return time.perf_counter() - t0

            run_once()                      # cold (build + install)
            warm_s = run_once()             # fully warm
            blocks0 = cache.stats()["entries"]
            ev0 = cache.stats()["evictions"]
            times = []
            for _ in range(cycles):
                extra = {k: v[:n_extra] for k, v in cols.items()}
                c.send_table("d", "lineitem", _table(extra, _LI_DICTS),
                             append=True)
                times.append(run_once())    # warm-after-append
            st = cache.stats()
            res = {"warm_s": round(warm_s, 4),
                   "warm_after_append_s": round(min(times), 4),
                   "warm_after_append_all": [round(t, 4) for t in times],
                   "blocks_before_appends": blocks0,
                   "cache_stats": st}
            if partial:
                res["pre_append_evictions"] = st["evictions"] - ev0
                res["partial_hits"] = st["partial_hits"]
            c.close()
            return res
        finally:
            ctl.shutdown()
            shutil.rmtree(root, ignore_errors=True)

    out["whole_run"] = arm(False)
    out["partial"] = arm(True)
    p, w = out["partial"], out["whole_run"]
    if p["warm_after_append_s"] > 0:
        out["devcache_partial_speedup"] = round(
            w["warm_after_append_s"] / p["warm_after_append_s"], 2)
    # the acceptance structure: appends evicted nothing and the warm
    # re-queries stitched resident blocks
    out["partial_zero_evictions"] = (p.get("pre_append_evictions") == 0)
    out["partial_hits_positive"] = (p.get("partial_hits", 0) > 0)
    return out


# --- horizontal scale-out (--scale) ----------------------------------

def scaleout_table(rows: int, seed: int = 0) -> ColumnTable:
    """The q01-style workload with INTEGER measures (the reference's draws
    in the same order): partial sums stay exact, so an N-daemon
    scatter-gather result equals the one-daemon run byte for byte. The
    columns are host tensors."""
    rng = np.random.default_rng(seed)
    cols = {
        "l_shipdate": rng.integers(19920101, 19981231, rows, dtype=np.int32),
        "l_returnflag": rng.integers(0, 3, rows, dtype=np.int32),
        "l_linestatus": rng.integers(0, 2, rows, dtype=np.int32),
        "l_quantity": rng.integers(1, 51, rows, dtype=np.int32),
        "l_price": rng.integers(1, 1000, rows, dtype=np.int32),
    }
    return ColumnTable({k: torch.from_numpy(v) for k, v in cols.items()},
                       {"l_returnflag": ["A", "N", "R"],
                        "l_linestatus": ["F", "O"]})


def scaleout_q01_sink(db: str, cutoff: int = 19980902,
                      lineitem_set: str = "lineitem",
                      output_set: str = "scale_q01_out") -> WriteSet:
    """SCAN(lineitem) → APPLY(int group-by fold) → OUTPUT: per
    (returnflag, linestatus) group, int32 count, sum(qty) and sum(price)
    under a shipdate cutoff; a single-pass fold with ``state_merge``
    (tree add) — the scatterable q01 shape with exact accumulators."""
    n_groups = 6  # 3 returnflags x 2 linestatuses

    def init(prev, src):
        z = torch.zeros((n_groups,), dtype=torch.int32, device=src.device)
        return (z, z.clone(), z.clone())

    def step(state, chunk):
        counts, qty, price = state
        ok = chunk.mask() & (chunk["l_shipdate"] <= cutoff)
        gid = torch.where(ok, chunk["l_returnflag"] * 2
                          + chunk["l_linestatus"], 0).long()
        zero = torch.zeros((), dtype=torch.int32, device=ok.device)
        return (counts.index_add(0, gid, ok.to(torch.int32)),
                qty.index_add(0, gid, torch.where(
                    ok, chunk["l_quantity"], zero)),
                price.index_add(0, gid, torch.where(
                    ok, chunk["l_price"], zero)))

    def fin(state, src):
        counts, qty, price = state
        gid = torch.arange(n_groups, dtype=torch.int32, device=counts.device)
        return ColumnTable(
            cols={"l_returnflag": torch.div(gid, 2, rounding_mode="floor"),
                  "l_linestatus": gid % 2, "count": counts,
                  "sum_qty": qty, "sum_price": price},
            dicts={"l_returnflag": src.dicts["l_returnflag"],
                   "l_linestatus": src.dicts["l_linestatus"]},
            valid=counts > 0)

    return WriteSet(Apply(ScanSet(db, lineitem_set),
                          fold=single_pass(init, step, fin,
                                           state_merge=tree_add_states),
                          label=f"scaleq01:{cutoff}"),
                    db, output_set)


def scaleout_join_sink(db: str, key_space: int,
                       lineitem_set: str = "lineitem",
                       orders_set: str = "orders",
                       output_set: str = "scale_join_out") -> WriteSet:
    """Per-order sum of lineitem prices through a LUT probe, with integer
    accumulators; declared probe/build keys and an output merge make it a
    distributed-shuffle join over a pool, every order's lineitems on its
    key's bucket, so the sharded result equals the one-daemon run byte for
    byte."""

    def init(prev, src, orders):
        return torch.zeros((orders.num_rows,), dtype=torch.int32,
                           device=orders.device)

    def step(acc, li, orders):
        dev = orders.device
        lut = torch.full((key_space,), -1, dtype=torch.int32, device=dev)
        lut[orders["o_orderkey"].long()] = torch.arange(
            orders.num_rows, dtype=torch.int32, device=dev)
        oidx = lut[li["l_orderkey"].long()]
        ok = (oidx >= 0) & li.mask()
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return acc.index_add(0, torch.where(ok, oidx, zero).long(),
                             torch.where(ok, li["l_price"], zero))

    def fin(acc, src, orders):
        return ColumnTable(cols={"okey": orders["o_orderkey"], "rev": acc},
                           valid=acc > 0)

    def merge(a, b):
        return ColumnTable(
            cols={"okey": torch.cat([a["okey"], b["okey"]]),
                  "rev": torch.cat([a["rev"], b["rev"]])},
            valid=torch.cat([a.mask(), b.mask()]))

    return WriteSet(
        Join(ScanSet(db, lineitem_set), ScanSet(db, orders_set),
             fold=single_pass(init, step, fin, merge,
                              probe_key="l_orderkey",
                              build_key="o_orderkey",
                              probe_columns=("l_price",)),
             label=f"scalejoin:{key_space}"),
        db, output_set)


def _scale_rows(client, db: str, out_set: str):
    """Decoded, canonically ordered result rows (the byte-equality
    probe)."""
    t = client.get_table(db, out_set)
    ok = (t.valid.detach().cpu().numpy() if t.valid is not None
          else np.ones(t.num_rows, bool))
    names = sorted(t.cols)
    host = {n: t.cols[n].detach().cpu().numpy() for n in names}
    return sorted(tuple(int(host[n][i]) for n in names)
                  for i in range(t.num_rows) if ok[i])


def _table_mb(table: ColumnTable) -> float:
    return sum(v.numel() * v.element_size()
               for v in table.cols.values()) / 2**20


def _stop_all(daemons: List[_Daemon]) -> None:
    for d in daemons:
        d.stop()


def _spawn_pools(root: str, device, pools: List[Tuple[str, int, List[str],
                                                     int]]
                 ) -> Dict[str, List[_Daemon]]:
    """Daemon processes for every ``(tag, n, extra, spares)`` pool at once:
    all workers and spares start together, then every leader naming its
    pool's workers. ``{tag: [leader, workers..., spares...]}`` (spares are
    not in the leader's pool). Arms that run one after the other start
    their daemons together here, so no arm waits for another's start."""
    started: List[_Daemon] = []
    out: Dict[str, List[_Daemon]] = {}
    try:
        members = {}
        for tag, n, extra, spares in pools:
            ws = [_Daemon(os.path.join(root, f"{tag}_w{i}"), device, extra)
                  for i in range(n - 1)]
            sp = [_Daemon(os.path.join(root, f"{tag}_s{i}"), device, extra)
                  for i in range(spares)]
            started += ws + sp
            members[tag] = (ws, sp)
        for d in started:
            d.wait_ready()
        leaders = {}
        for tag, n, extra, _spares in pools:
            ws = members[tag][0]
            lead_extra = list(extra) + (
                ["--workers", ",".join(w.addr for w in ws)] if ws else [])
            leaders[tag] = _Daemon(os.path.join(root, f"{tag}_l"), device,
                                   lead_extra)
            started.append(leaders[tag])
        for tag, lead in leaders.items():
            lead.wait_ready()
            out[tag] = [lead] + members[tag][0] + members[tag][1]
    except BaseException:
        _stop_all(started)
        raise
    return out


def run_scaleout_bench(rows: int = 6_000_000, daemons: int = 4,
                       queries: int = 6, page_rows: int = 65_536,
                       join_orders: int = 2048,
                       join_rows: int = 400_000,
                       device=None) -> Dict[str, Any]:
    """Paired 1 vs N-daemon arm (``--scale``): aggregate ingest MB/s
    (client-routed partitions vs one daemon) and cold scatter-gather q01
    QPS over the same paged workload, plus the byte-equality checks — the
    sharded q01 result and a grace-hash join routed through the
    distributed shuffle must equal the one-daemon run exactly (integer
    accumulators). Daemons are real processes (parallel apply needs
    separate GILs); the device cache is off daemon-side so every query
    re-streams its pages — the cold path capacity scaling is about. All
    daemons share one machine, so the scale is a lower bound on a
    multi-host pool."""
    resolve_device(device)  # without a card only the CPU, when asked
    from netsdb_tpu_torch.serve.client import RemoteClient

    table = scaleout_table(rows)
    payload_mb = _table_mb(table)
    rng = np.random.default_rng(7)
    join_li = _table({
        "l_orderkey": rng.integers(0, join_orders, join_rows,
                                   dtype=np.int32),
        "l_price": rng.integers(1, 1000, join_rows, dtype=np.int32)})
    join_orders_tbl = _table(
        {"o_orderkey": np.arange(join_orders, dtype=np.int32)})
    root = tempfile.mkdtemp(prefix="scale_bench_")
    extra = ["--device-cache-mb", "0", "--page-kb", str(page_rows * 4 // 1024)]

    def run_arm(n: int, procs: List[_Daemon]) -> Dict[str, Any]:
        out: Dict[str, Any] = {"daemons": n}
        try:
            c = RemoteClient(procs[0].addr)
            c.create_database("d")
            kw = {"placement": "range"} if n > 1 else {}
            # ingest warmup: every daemon's first ingest pays lazy imports
            # and arena setup once — both arms exclude it
            c.create_set("d", "warm", type_name="table",
                         storage="paged", **kw)
            c.send_table("d", "warm", scaleout_table(4096, seed=9))
            c.create_set("d", "lineitem", type_name="table",
                         storage="paged", **kw)
            t0 = time.perf_counter()
            c.send_table("d", "lineitem", table)
            ingest_s = time.perf_counter() - t0
            out["ingest_s"] = round(ingest_s, 3)
            out["ingest_mb_per_s"] = round(payload_mb / ingest_s, 1)

            sink = scaleout_q01_sink("d")
            # warmup builds (both arms pay it once, excluded)
            c.execute_computations(sink, job_name="scale-q01-warm",
                                   fetch_results=False)
            t0 = time.perf_counter()
            for _ in range(queries):
                c.execute_computations(sink, job_name="scale-q01",
                                       fetch_results=False)
            q_s = time.perf_counter() - t0
            out["query_s_total"] = round(q_s, 3)
            out["cold_query_qps"] = round(queries / q_s, 3)
            out["q01_rows"] = _scale_rows(c, "d", "scale_q01_out")

            # the distributed-shuffle join leg
            jkw = {"placement": "hash"} if n > 1 else {}
            c.create_set("d", "jli", type_name="table", **jkw)
            c.create_set("d", "jorders", type_name="table", **jkw)
            c.send_table("d", "jli", join_li)
            c.send_table("d", "jorders", join_orders_tbl)
            jsink = scaleout_join_sink("d", join_orders,
                                       lineitem_set="jli",
                                       orders_set="jorders")
            t0 = time.perf_counter()
            c.execute_computations(jsink, job_name="scale-join",
                                   fetch_results=False)
            out["join_s"] = round(time.perf_counter() - t0, 3)
            out["join_rows"] = _scale_rows(c, "d", "scale_join_out")
            c.close()
        finally:
            _stop_all(procs)
        return out

    try:
        pools = _spawn_pools(root, device, [("single", 1, extra, 0),
                                            ("pool", daemons, extra, 0)])
        try:
            single = run_arm(1, pools["single"])
            pool = run_arm(daemons, pools["pool"])
        finally:
            _stop_all(pools["single"] + pools["pool"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out: Dict[str, Any] = {
        "rows": rows, "payload_mb": round(payload_mb, 1),
        "daemons": daemons, "queries": queries,
        "single": {k: v for k, v in single.items()
                   if not k.endswith("_rows")},
        "pool": {k: v for k, v in pool.items()
                 if not k.endswith("_rows")},
        "ingest_scale_x": round(pool["ingest_mb_per_s"]
                                / single["ingest_mb_per_s"], 2),
        "query_scale_x": round(pool["cold_query_qps"]
                               / single["cold_query_qps"], 2),
        "q01_byte_equal": pool["q01_rows"] == single["q01_rows"],
        "join_byte_equal": pool["join_rows"] == single["join_rows"],
    }
    out["scaleout_throughput_x"] = round(
        min(out["ingest_scale_x"], out["query_scale_x"]), 2)
    return out


def _pctl(vals: List[float], p: int) -> float:
    """Nearest-rank (ceil) percentile: at N=8 the p99 is the max."""
    vals = sorted(vals)
    return vals[min(len(vals) - 1, max(-(-p * len(vals) // 100) - 1, 0))]


def run_scheduler_bench(clients: int = 8, rows: int = 600_000,
                        page_rows: int = 65_536, pool_mb: int = 8,
                        cache_mb: int = 256, device=None) -> Dict[str, Any]:
    """Paired A/B for the query scheduler (``--scheduler``): N concurrent
    byte-identical cold EXECUTEs over one paged set, scheduler on vs off.
    Reported per phase: executions run, devcache installs, coalesce hits
    and client latency p50/p99. On, the N identical frames collapse into
    one execution (one install, N−1 coalesce hits); off, N cold streams
    race through one arena.

    Both phases run program-warm and devcache-cold. The reference warms
    its jit cache once in a throwaway daemon; here two daemons of one
    process keep separate program variants and a fold step captures its
    graph from its second request, so each phase's own daemon runs the
    query twice first (same job name), then its device cache is emptied
    and the executions, installs and hits are counted from there."""
    resolve_device(device)  # without a card only the CPU, when asked
    from netsdb_tpu_torch import obs
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.relational import dag as rdag
    from netsdb_tpu_torch.serve.client import RemoteClient

    table = _table(_lineitem_cols(rows, np.random.default_rng(0)),
                   _LI_DICTS)
    sink = rdag.q01_sink("d")
    job = "q01-sched"

    def executions(ctl) -> int:
        with ctl._jobs_lock:
            return sum(1 for j in ctl._jobs.values() if j["name"] == job)

    def phase(sched_on: bool) -> Dict[str, Any]:
        root = tempfile.mkdtemp(prefix="sched_bench_")
        cfg = Configuration(
            root_dir=root, page_size_bytes=page_rows * 4,
            page_pool_bytes=pool_mb << 20,
            device_cache_bytes=cache_mb << 20,
            sched_coalesce=sched_on, sched_affinity=sched_on)
        ctl = _in_process(cfg, device, max_jobs=clients)
        addr = f"127.0.0.1:{ctl.port}"
        try:
            c = RemoteClient(addr)
            c.create_database("d")
            c.create_set("d", "lineitem", type_name="table",
                         storage="paged")
            c.send_table("d", "lineitem", table)
            for _ in range(2):  # build, then capture
                c.execute_computations(sink, job_name=job,
                                       fetch_results=False)
            c.close()
            cache = ctl.library.store.device_cache()
            cache.resize(0)  # devcache-cold, program-warm
            cache.resize(cache_mb << 20)
            runs0 = executions(ctl)
            installs0 = cache.stats()["installs"]
            hits0 = obs.REGISTRY.counter("sched.coalesce_hits").value
            barrier = threading.Barrier(clients)
            lat: List[Optional[float]] = [None] * clients

            def worker(i: int) -> None:
                wc = RemoteClient(addr, client_id=f"tenant-{i}")
                try:
                    barrier.wait()
                    t0 = time.perf_counter()
                    wc.execute_computations(sink, job_name=job,
                                            fetch_results=False)
                    lat[i] = time.perf_counter() - t0
                finally:
                    wc.close()

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            done = sorted(v for v in lat if v is not None)
            return {
                "clients": clients,
                "executions_run": executions(ctl) - runs0,
                "devcache_installs": cache.stats()["installs"] - installs0,
                "coalesce_hits":
                    obs.REGISTRY.counter("sched.coalesce_hits").value
                    - hits0,
                "p50_s": round(_pctl(done, 50), 4) if done else None,
                "p99_s": round(_pctl(done, 99), 4) if done else None,
            }
        finally:
            ctl.shutdown()
            shutil.rmtree(root, ignore_errors=True)

    off = phase(False)
    on = phase(True)
    out: Dict[str, Any] = {"rows": rows, "clients": clients,
                           "scheduler_off": off, "scheduler_on": on}
    if on.get("p99_s") and off.get("p99_s"):
        out["p99_speedup"] = round(off["p99_s"] / on["p99_s"], 2)
        out["p50_speedup"] = round(off["p50_s"] / on["p50_s"], 2)
    return out


def run_serving_bench(daemons: int = 4, batch: int = 8192,
                      features: int = 256, hidden: int = 512,
                      labels: int = 64, frames: int = 6,
                      block=(128, 128), device=None) -> Dict[str, Any]:
    """End-to-end model serving over the sharded pool (``--serving``):
    deploy once (weights replicated, inputs range-partitioned over leader
    + N−1 workers), then batched scoring frames through ``models.serving.
    ModelServing`` — routed batch ingest, the scatter, one compiled
    program per shard, slot-order gather.

    The figure is trusted only when the gates hold on this run: (1) the
    pool output is byte-equal to a solo daemon scoring the same bytes
    (integer-valued f32 weights make it exact); (2) every shard's EXPLAIN
    tree reports ``whole_plan_jit`` with every node fused — one program
    per shard; (3) no daemon holds more than ceil(B/N) input rows."""
    resolve_device(device)  # without a card only the CPU, when asked
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.models.serving import ff_serving
    from netsdb_tpu_torch.serve import placement as PL
    from netsdb_tpu_torch.serve.client import RemoteClient
    from netsdb_tpu_torch.storage.store import SetIdentifier

    rng = np.random.default_rng(0)

    def ints(shape):
        return rng.integers(-3, 3, size=shape).astype(np.float32)

    weights = (ints((hidden, features)), ints((hidden,)),
               ints((labels, hidden)), ints((labels,)))
    batches = [ints((batch, features)) for _ in range(frames)]
    root = tempfile.mkdtemp(prefix="serving_bench_")

    def make_ctl(tag, workers=None):
        return _in_process(Configuration(root_dir=os.path.join(root, tag)),
                           device, workers=workers)

    def solo_arm() -> Dict[str, Any]:
        ctl = make_ctl("solo")
        try:
            c = RemoteClient(f"127.0.0.1:{ctl.port}")
            m = FFModel(db="ffsolo", block=block)
            m.setup(c)
            m.load_weights(c, *weights)
            m.load_inputs(c, batches[0])
            res = c.execute_computations(m.build_inference_dag(),
                                         job_name="solo-warm")
            oracle = _host(next(iter(res.values())))
            t0 = time.perf_counter()
            for b in batches:
                m.load_inputs(c, b)
                c.execute_computations(m.build_inference_dag(),
                                       job_name="solo",
                                       fetch_results=False)
            dt = time.perf_counter() - t0
            c.close()
            return {"oracle": oracle,
                    "rows_per_sec": round(frames * batch / dt, 1)}
        finally:
            ctl.shutdown()

    out: Dict[str, Any] = {}
    workers: list = []
    leader = None
    try:
        solo = solo_arm()
        out.update({
            "daemons": daemons, "batch": batch, "frames": frames,
            "shape": [features, hidden, labels],
            "solo_rows_per_sec": solo["rows_per_sec"],
        })
        workers = [make_ctl(f"w{i}") for i in range(daemons - 1)]
        leader = make_ctl("leader",
                          workers=[f"127.0.0.1:{w.port}" for w in workers])
        model = FFModel(db="ffserving", block=block)

        def load(c):
            model.setup(c)
            model.load_weights(c, *weights)

        srv = ff_serving(model, f"127.0.0.1:{leader.port}",
                         block=model.block)
        addrs = srv.deploy(load)
        out["slots"] = len(addrs)

        # the cold frame carries the per-layer EXPLAIN decomposition and
        # the structural gates
        cold, forest = srv.score(batches[0], explain=True)
        out["byte_equal"] = bool(
            _host(cold).tobytes() == solo["oracle"].tobytes())
        one_program = sorted(forest) == sorted(addrs)
        shard_trees = {}
        for daemon, tree in forest.items():
            nodes = [n for n in tree["nodes"]
                     if n.get("kind") != "WholePlanJit"]
            one_program &= tree["mode"] == "whole_plan_jit" \
                and bool(nodes) and all(n.get("fused") for n in nodes)
            shard_trees[daemon] = {
                "mode": tree["mode"],
                "layers": [f"{n['kind']}:{n.get('label', '')}"
                           for n in nodes]}
        out["one_program_per_shard"] = bool(one_program)
        out["explain_shard"] = shard_trees[addrs[0]]

        # <=1/N structural proof: no daemon holds more input rows than
        # its contiguous range slice
        bound = max(hi - lo
                    for lo, hi in PL.range_slices(batch, len(addrs)))
        max_rows, total_rows = 0, 0
        for ctl in [leader] + workers:
            for it in ctl.library.store.get_items(
                    SetIdentifier("ffserving", "inputs")):
                n_rows = int(_host(it).shape[0]) \
                    if hasattr(it, "to_dense") else 0
                max_rows = max(max_rows, n_rows)
                total_rows += n_rows
        out["rows_bound_ok"] = bool(
            max_rows <= bound and total_rows == batch)
        out["per_shard_max_row_frac"] = round(max_rows / batch, 3)

        # warm frames: every shard rides its compiled program; each frame
        # is different bytes, so no coalescing can shortcut it
        t0 = time.perf_counter()
        for b in batches:
            srv.score(b)
        dt = time.perf_counter() - t0
        srv.close()
        total = frames * batch
        out["pool_rows_per_sec"] = round(total / dt, 1)
        out["rows_per_sec_per_chip"] = round(total / dt / daemons, 1)
        out["gates_ok"] = bool(out["byte_equal"]
                               and out["one_program_per_shard"]
                               and out["rows_bound_ok"])
    finally:
        for d in ([leader] if leader is not None else []) + workers:
            d.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    return out


def run_failover_bench(batches: int = 24, rows_each: int = 2000,
                       kill_after: int = 12, election_s: float = 0.35,
                       device=None) -> Dict[str, Any]:
    """Failover under traffic (``--failover``): a client streams append
    batches against an armed leader + follower pair (every write mirrored);
    mid-stream the leader is killed. Each logical request's latency
    includes its typed-retry failover rotation, so the post-kill maximum
    is the client-observed blip bound. Trusted only when the promotion
    happened and the totals are exact — zero lost, zero doubled writes.
    The follower starts first (a follower named before it listens makes
    the leader's first writes wait out the dial window)."""
    resolve_device(device)  # without a card only the CPU, when asked
    from netsdb_tpu_torch import obs
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.serve import ha as ha_mod
    from netsdb_tpu_torch.serve.client import RemoteClient, RetryPolicy
    from netsdb_tpu_torch.serve.errors import RetryableRemoteError
    from netsdb_tpu_torch.storage.store import SetIdentifier

    kw = dict(heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5,
              heartbeat_misses=2, mirror_ack_timeout_s=5.0,
              resync_grace_s=2.0)
    root = tempfile.mkdtemp(prefix="failover_bench_")
    follower = _in_process(Configuration(root_dir=os.path.join(root, "f")),
                           device, **kw)
    leader = _in_process(Configuration(root_dir=os.path.join(root, "l")),
                         device, followers=[follower.advertise_addr], **kw)
    out: Dict[str, Any] = {"batches": batches, "rows_each": rows_each,
                           "election_s": election_s}
    try:
        peers = [leader.advertise_addr, follower.advertise_addr]
        for d in (leader, follower):
            d.arm_ha(peers, election_timeout_s=election_s)
        c = RemoteClient(leader.advertise_addr,
                         failover=[follower.advertise_addr],
                         retry=RetryPolicy(max_attempts=80,
                                           base_delay_s=0.05,
                                           max_delay_s=0.25))
        c.create_database("d")
        c.create_set("d", "t", type_name="table")
        lat: List[float] = []
        promos0 = obs.REGISTRY.counter("ha.promotions").value
        done = 0
        for i in range(batches):
            if i == kill_after:
                leader.shutdown()  # mid-traffic kill
            t0 = time.perf_counter()
            deadline = time.monotonic() + 60.0
            while True:
                try:
                    c.send_table("d", "t", scaleout_table(rows_each, seed=i),
                                 append=True)
                    done += 1
                    break
                except RetryableRemoteError:
                    if time.monotonic() > deadline:
                        break
                    time.sleep(0.05)
            lat.append(time.perf_counter() - t0)

        steady = lat[:kill_after]
        after = lat[kill_after:]
        out["steady_p50_s"] = round(_pctl(steady, 50), 4)
        out["steady_p99_s"] = round(_pctl(steady, 99), 4)
        out["blip_p99_s"] = round(_pctl(after, 99), 4)
        out["blip_max_s"] = round(max(after), 4)
        out["blip_x"] = round(out["blip_p99_s"]
                              / max(out["steady_p99_s"], 1e-9), 2)
        out["promoted"] = bool(
            follower._ha.role == ha_mod.LEADER
            and obs.REGISTRY.counter("ha.promotions").value
            == promos0 + 1)
        total = sum(
            int(getattr(it, "num_rows", 0) or 0)
            for it in follower.library.store.get_items(
                SetIdentifier("d", "t")))
        out["exact_totals"] = bool(done == batches
                                   and total == batches * rows_each)
        c.close()
    finally:
        for d in (leader, follower):
            d.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    return out


# --- distributed fusion A/B (--fusion-distributed) --------------------

def run_fusion_distributed_bench(rows: int = 400_000, daemons: int = 4,
                                 queries: int = 6,
                                 device=None) -> Dict[str, Any]:
    """Paired mapper A/B over the distributed compilation path
    (``--fusion-distributed``): the N-daemon scatter q01 plus a 3-sink
    dashboard fan, run under three arms — ``optimal`` (the region path:
    one compiled partial-fold program per shard, one coordinator
    merge+finalize program, the fan shipped as one multi-sink subplan per
    shard), ``greedy`` (``fusion_mapper="greedy"``) and ``off``
    (``plan_fusion=False``). Each arm gets its own in-process pool,
    ingest and job names, so every arm builds its own programs.

    ``plan_fusion_distributed_speedup`` is the off arm's p50 round latency
    over the optimal arm's across the warm timed rounds, trusted only
    when the gates hold on this run: (1) the optimal arm's cold q01
    minted exactly one ``fold::`` key and one ``region::…::merge`` key,
    ``shard.subplans`` advancing by ``daemons``; (2) the fan ran as one
    scatter query with one multi-sink subplan per daemon; (3) q01 rows
    and every fan sink are byte-equal across the three arms."""
    resolve_device(device)  # without a card only the CPU, when asked
    from netsdb_tpu_torch import obs
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.plan import executor
    from netsdb_tpu_torch.serve.client import RemoteClient

    cuts = (19950101, 19970101, 19980902)
    root = tempfile.mkdtemp(prefix="fzd_bench_")

    def counter(name: str) -> int:
        return obs.REGISTRY.counter(name).value

    def pool(tag: str, **cfg_extra):
        cfg = dict({"page_size_bytes": 64 * 1024}, **cfg_extra)
        ctls = []
        try:
            for i in range(daemons - 1):
                ctls.append(_in_process(Configuration(
                    root_dir=os.path.join(root, f"{tag}_w{i}"), **cfg),
                    device))
            leader = _in_process(Configuration(
                root_dir=os.path.join(root, f"{tag}_l"), **cfg), device,
                workers=[f"127.0.0.1:{w.port}" for w in ctls])
        except BaseException:
            for d in ctls:
                d.shutdown()
            raise
        return [leader] + ctls

    table = scaleout_table(rows)

    def run_arm(tag: str, **cfg_extra) -> Dict[str, Any]:
        ctls = pool(tag, **cfg_extra)
        try:
            c = RemoteClient(f"127.0.0.1:{ctls[0].port}")
            c.create_database("d")
            c.create_set("d", "lineitem", type_name="table",
                         storage="paged", placement="range")
            c.send_table("d", "lineitem", table)

            def fan_sinks(prefix: str):
                return [scaleout_q01_sink(
                    "d", cutoff=ct, output_set=f"{prefix}_{i}")
                    for i, ct in enumerate(cuts)]

            # cold round: builds every program the warm rounds ride
            keys0 = set(executor.compiled_cache_keys())
            sp0 = counter("shard.subplans")
            sq0 = counter("shard.scatter_queries")
            c.execute_computations(scaleout_q01_sink("d"),
                                   job_name=f"fzd-{tag}-q01",
                                   fetch_results=False)
            q01_new = set(executor.compiled_cache_keys()) - keys0
            q01_subplans = counter("shard.subplans") - sp0
            sp1 = counter("shard.subplans")
            sq1 = counter("shard.scatter_queries")
            c.execute_computations(*fan_sinks("fan"),
                                   job_name=f"fzd-{tag}-fan",
                                   fetch_results=False)
            arm = {
                "q01_fold_keys": sum(
                    1 for k in q01_new if k.startswith("fold::")),
                "q01_merge_keys": sum(
                    1 for k in q01_new
                    if k.startswith(f"region::fzd-{tag}-q01::scatter::")
                    and f"::merge::k{daemons}::" in k),
                "q01_other_keys": sum(
                    1 for k in q01_new
                    if not k.startswith(("fold::", "region::"))),
                "q01_subplans": q01_subplans,
                "fan_scatter_queries":
                    counter("shard.scatter_queries") - sq1,
                "fan_subplans": counter("shard.subplans") - sp1,
                "q01_scatter_queries": sq1 - sq0,
            }

            # warm timed rounds: every program cached, so the paired delta
            # isolates the dispatch path. Two untimed warm rounds first
            # (a fold step captures its graph from its second request)
            def round_once() -> float:
                t0 = time.perf_counter()
                c.execute_computations(scaleout_q01_sink("d"),
                                       job_name=f"fzd-{tag}-q01",
                                       fetch_results=False)
                c.execute_computations(*fan_sinks("fan"),
                                       job_name=f"fzd-{tag}-fan",
                                       fetch_results=False)
                return time.perf_counter() - t0

            for _ in range(2):
                round_once()
            lat = sorted(round_once() for _ in range(queries))
            arm["wall_s"] = round(sum(lat), 4)
            arm["round_p50_s"] = round(lat[len(lat) // 2], 4)
            arm["round_min_s"] = round(lat[0], 4)
            arm["rounds_per_sec"] = round(queries / max(
                arm["wall_s"], 1e-9), 2)
            arm["q01_rows"] = _scale_rows(c, "d", "scale_q01_out")
            arm["fan_rows"] = [_scale_rows(c, "d", f"fan_{i}")
                               for i in range(len(cuts))]
            c.close()
            return arm
        finally:
            for d in ctls:
                d.shutdown()

    try:
        opt = run_arm("opt")
        greedy = run_arm("greedy", fusion_mapper="greedy")
        off = run_arm("off", plan_fusion=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    rows_equal = bool(
        opt["q01_rows"] == greedy["q01_rows"] == off["q01_rows"]
        and opt["fan_rows"] == greedy["fan_rows"] == off["fan_rows"])
    one_program = bool(
        opt["q01_fold_keys"] == 1 and opt["q01_merge_keys"] == 1
        and opt["q01_other_keys"] == 0
        and opt["q01_subplans"] == daemons
        and opt["q01_scatter_queries"] == 1)
    fan_one_subplan = bool(opt["fan_scatter_queries"] == 1
                           and opt["fan_subplans"] == daemons)
    rollback_clean = bool(
        greedy["q01_merge_keys"] == 0 and off["q01_merge_keys"] == 0)

    def strip(arm):
        return {k: v for k, v in arm.items()
                if k not in ("q01_rows", "fan_rows")}

    out: Dict[str, Any] = {
        "rows": rows, "daemons": daemons, "queries": queries,
        "optimal": strip(opt), "greedy": strip(greedy),
        "off": strip(off),
        "byte_equal": rows_equal,
        "one_program_per_shard_plus_merge": one_program,
        "fan_one_subplan_per_shard": fan_one_subplan,
        "rollback_no_region_keys": rollback_clean,
        "gates_ok": bool(rows_equal and one_program
                         and fan_one_subplan and rollback_clean),
    }
    if opt["round_p50_s"] > 0:
        # p50 of per-round latency, not total wall: one straggler round
        # would otherwise decide the paired A/B
        out["plan_fusion_distributed_speedup"] = round(
            off["round_p50_s"] / opt["round_p50_s"], 3)
        out["speedup_vs_greedy"] = round(
            greedy["round_p50_s"] / opt["round_p50_s"], 3)
    return out


def run_rebalance_bench(rows: int = 400_000, daemons: int = 4,
                        clients: int = 4, measure_s: float = 6.0,
                        settle_s: float = 4.0,
                        device=None) -> Dict[str, Any]:
    """Self-rebalancing paired A/B (``--rebalance``): a ``daemons``-strong
    pool serves an 80/20 hot/cold routed-read mix from ``clients``
    concurrent threads; mid-run a fresh daemon registers (``RESHARD
    op=add_worker``). The **on** arm lets the rebalancer run its forced
    campaign (slot ownership moves onto the new member under live
    traffic); the **frozen** arm leaves it slot-less. The headline is the
    recovered throughput ratio (``serve_rebalance_recovery_x``): the
    recovery window opens ``settle_s`` after the campaign returns. It is
    gated on zero failed client requests in either arm and a row- and
    checksum-exact scan-back in both. Daemons are real processes."""
    resolve_device(device)  # without a card only the CPU, when asked
    from netsdb_tpu_torch.serve.client import RemoteClient

    hot = scaleout_table(rows, seed=1)
    cold = scaleout_table(max(rows // 10, 64), seed=2)

    def checksum(t) -> int:
        return int(t["l_price"].to(torch.int64).sum())

    want = {"hot": (hot.num_rows, checksum(hot)),
            "cold": (cold.num_rows, checksum(cold))}
    root = tempfile.mkdtemp(prefix="rebal_bench_")

    def extra(on: bool) -> List[str]:
        return ["--device-cache-mb", "0"] + (["--rebalance"] if on else [])

    def run_arm(on: bool, procs: List[_Daemon]) -> Dict[str, Any]:
        # procs: the leader, its workers, then the daemon that joins
        leader_addr = procs[0].addr
        out: Dict[str, Any] = {"rebalance": on}
        try:
            c = RemoteClient(leader_addr)
            c.create_database("d")
            c.create_set("d", "hot", type_name="table", placement="range")
            c.create_set("d", "cold", type_name="table", placement="range")
            c.send_table("d", "hot", hot)
            c.send_table("d", "cold", cold)
            c.get_table_streamed("d", "hot")  # warm the scan path

            stop = threading.Event()
            counts = [0] * clients
            failures: List[str] = []
            retries = [0] * clients

            def load(i: int) -> None:
                lc = RemoteClient(leader_addr)
                n = 0
                try:
                    while not stop.is_set():
                        name = "hot" if n % 5 else "cold"
                        try:
                            t = lc.get_table_streamed("d", name)
                            if t.num_rows != want[name][0]:
                                failures.append(f"{name}: {t.num_rows} rows")
                        except Exception as e:  # noqa: BLE001 — the gate:
                            # nothing typed-retryable may escape the client
                            failures.append(f"{name}: {e!r}")
                        n += 1
                        counts[i] = n
                finally:
                    retries[i] = lc.total_retries
                    lc.close()

            threads = [threading.Thread(target=load, args=(i,), daemon=True)
                       for i in range(clients)]
            for t in threads:
                t.start()
            time.sleep(measure_s)
            baseline = sum(counts)
            out["baseline_qps"] = round(baseline / measure_s, 2)

            # the new daemon joins mid-run (its process started with the
            # pool's); on the on arm the forced campaign moves slots under
            # this very traffic
            t0 = time.perf_counter()
            reply = c.add_worker(procs[-1].addr)
            out["campaign_s"] = round(time.perf_counter() - t0, 3)
            out["moves"] = [
                {k: m[k] for k in ("db", "set", "slot", "src", "dst", "ok")
                 if k in m}
                for m in (reply.get("moves") or [])]
            # settle: let the moved slot's cold first scans drain (both
            # arms wait, keeping the within-run warming symmetric)
            time.sleep(settle_s)
            at_join = sum(counts)
            time.sleep(measure_s)
            recovered = sum(counts) - at_join
            stop.set()
            for t in threads:
                t.join(timeout=30)
            out["recovery_qps"] = round(recovered / measure_s, 2)
            out["failed_requests"] = len(failures)
            out["failures"] = failures[:8]
            out["retries_absorbed"] = sum(retries)

            # exactness gates: the campaign must not lose or double a row
            totals = {}
            for name in ("hot", "cold"):
                t = c.get_table_streamed("d", name)
                totals[name] = (t.num_rows, checksum(t))
            out["totals"] = {k: list(v) for k, v in totals.items()}
            out["totals_exact"] = totals == want
            view = c.placement_view()
            out["placement_epoch"] = (view.get("status") or {}).get("epoch")
            out["member_slots"] = {m["addr"]: m["slots"]
                                   for m in view.get("members") or []}
            c.close()
        finally:
            _stop_all(procs)
        return out

    try:
        pools = _spawn_pools(root, device,
                             [("frozen", daemons, extra(False), 1),
                              ("on", daemons, extra(True), 1)])
        try:
            frozen = run_arm(False, pools["frozen"])
            live = run_arm(True, pools["on"])
        finally:
            _stop_all(pools["frozen"] + pools["on"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out: Dict[str, Any] = {
        "rows": rows, "daemons": daemons, "clients": clients,
        "measure_s": measure_s, "settle_s": settle_s,
        "frozen": frozen, "on": live,
        "moved_slots": sum(1 for m in live.get("moves") or []
                           if m.get("ok")),
        "zero_failed_requests": frozen["failed_requests"] == 0
        and live["failed_requests"] == 0,
        "totals_exact": frozen["totals_exact"] and live["totals_exact"],
        "byte_equal": frozen["totals"] == live["totals"],
    }
    out["serve_rebalance_recovery_x"] = round(
        live["recovery_qps"] / max(frozen["recovery_qps"], 1e-9), 2)
    return out


def run_sessions_bench(sessions: int = 8, steps: int = 32,
                       hidden: int = 64, workers: int = 2,
                       kind: str = "lstm", device=None) -> Dict[str, Any]:
    """Stateful interactive serving (``--sessions``): ``sessions``
    concurrent decode loops over one model on a sharded pool (a leader
    routing sticky to ``workers`` session-owning shards), each driving
    ``steps`` GENERATE rounds from its own client thread. The headline,
    aggregate warm decode throughput (``serve_sessions_steps_per_sec``),
    records only when the gates hold:

    * **one step program** for the whole timed phase: the bucket ladder
      maps every coalesced batch size to one (kind, hidden, bucket)
      program, so ``decode_stats()["traces"]`` (captures on the card) has
      a delta of 0 after warmup;
    * **zero arena reads** on the warm path: session state stays
      device-resident between steps;
    * **byte-equality**: every session's output stream equals a solo
      unbatched replay of the same inputs.

    Daemons are in process (the gates read the process-global decode
    stats)."""
    resolve_device(device)  # without a card only the CPU, when asked
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.models import decode as decode_mod
    from netsdb_tpu_torch.models.decode import deploy_decode_model
    from netsdb_tpu_torch.serve.client import RemoteClient

    root = tempfile.mkdtemp(prefix="sessions_bench_")
    daemons: list = []
    out: Dict[str, Any] = {
        "sessions": sessions, "steps": steps, "hidden": hidden,
        "workers": workers, "kind": kind,
    }
    try:
        pool = []
        for i in range(workers):
            w = _in_process(Configuration(root_dir=os.path.join(
                root, f"w{i}")), device)
            daemons.append(w)
            pool.append(w)
        leader = _in_process(
            Configuration(root_dir=os.path.join(root, "leader")), device,
            workers=[w.advertise_addr for w in pool])
        daemons.append(leader)

        deploy = RemoteClient(leader.advertise_addr)
        deploy_decode_model(deploy, "m", kind=kind, hidden=hidden, seed=7)

        def x_row(i: int, s: int) -> np.ndarray:
            rng = np.random.default_rng(7000 + 1000 * i + s)
            return rng.standard_normal(hidden).astype(np.float32)

        clients = [RemoteClient(leader.advertise_addr)
                   for _ in range(sessions)]
        handles = [clients[i].open_session("m", kind=kind)
                   for i in range(sessions)]

        outputs: Dict[int, List[np.ndarray]] = {
            i: [] for i in range(sessions)}
        errors: List[str] = []
        barrier = threading.Barrier(sessions)

        def drive(i: int) -> None:
            try:
                barrier.wait()
                for s in range(steps):
                    outputs[i].append(np.asarray(
                        handles[i].generate(x_row(i, s), deadline_s=120.0)))
            except Exception as e:  # noqa: BLE001 — gate below
                errors.append(f"session {i}: {e!r}")

        # warmup outside the timed window: the first steps build (capture)
        # the padded program and install per-session state
        for i in range(sessions):
            outputs[i].append(np.asarray(
                handles[i].generate(x_row(i, -1), deadline_s=120.0)))
            outputs[i].clear()

        def arena_reads() -> int:
            return sum(d.sessions.arena.stats()["reads"] for d in daemons)

        traces0 = decode_mod.decode_stats()["traces"]
        reads0 = arena_reads()
        threads = [threading.Thread(target=drive, args=(i,))
                   for i in range(sessions)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0

        stats = decode_mod.decode_stats()
        out["errors"] = errors
        out["wall_s"] = round(wall, 3)
        out["decode"] = dict(stats)
        out["traces_delta"] = stats["traces"] - traces0
        out["arena_reads_delta"] = arena_reads() - reads0
        out["batch_occupancy_avg"] = round(
            stats["steps"] / stats["batches"], 2) \
            if stats.get("batches") else None

        # byte-equality: every session vs a solo unbatched replay on a
        # fresh runtime over the same library (same weights)
        byte_equal = not errors
        rt = decode_mod.DecodeRuntime(leader.library)
        rt.register_model("m", kind)
        for i in range(sessions):
            st = rt.init_state("m")
            for s in range(-1, steps):
                new, ys = rt.step_batch("m", [st], [x_row(i, s)])
                st = new[0]
                if s >= 0 and not np.array_equal(np.asarray(ys[0]),
                                                 outputs[i][s]):
                    byte_equal = False
        out["byte_equal"] = byte_equal
        out["one_program"] = out["traces_delta"] == 0
        out["zero_warm_arena_reads"] = out["arena_reads_delta"] == 0
        if not errors and wall > 0:
            out["serve_sessions_steps_per_sec"] = round(
                sessions * steps / wall, 1)
        for h in handles:
            h.close()
        for c in clients:
            c.close()
        deploy.close()
    finally:
        for d in daemons:
            d.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    return out


def main(argv=None) -> int:
    """``python -m netsdb_tpu_torch.workloads.serve_bench``: one bench,
    its payload printed as one JSON line. ``--device`` (default cuda; the
    reference's ``--platform`` is its alias) is where the daemons and the
    client workers run; without a card only ``--device cpu`` runs."""
    import argparse

    ap = argparse.ArgumentParser(prog="serve_bench")
    ap.add_argument("--device", default="cuda",
                    help="the device every daemon runs on (default cuda)")
    ap.add_argument("--platform", default=None,
                    help="the reference's name for --device (e.g. cpu)")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--address", default="127.0.0.1:8108")
    ap.add_argument("--client-id", type=int, default=0)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--batch", type=int, default=BATCH)
    # None = per-mode default (2 for the FF bench, 8 for --scheduler); an
    # explicit value — however small — is always respected
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--stream", action="store_true",
                    help="transfer-path comparison: single-frame vs "
                         "streamed scan / chunked tensor")
    ap.add_argument("--data-plane", action="store_true",
                    help="data-plane numbers: single-frame vs streamed "
                         "pipelined ingest MB/s, scan MB/s, zero-copy "
                         "tensor push/pull, hedged-read p99")
    ap.add_argument("--device-cache", action="store_true",
                    help="cold vs warm EXECUTE latency over a "
                         "device-cache-resident paged set, plus hit/miss "
                         "counters")
    ap.add_argument("--partial-cache", action="store_true",
                    help="paired A/B: warm re-query after a 1%% append, "
                         "partial dirty-range invalidation vs whole-run "
                         "invalidation")
    ap.add_argument("--scheduler", action="store_true",
                    help="paired A/B: N concurrent identical cold "
                         "EXECUTEs with the query scheduler on vs off — "
                         "executions run, devcache installs, coalesce "
                         "hits, client p50/p99")
    ap.add_argument("--scale", action="store_true",
                    help="horizontal scale-out: paired 1 vs N-daemon arm "
                         "— aggregate routed-ingest MB/s, cold "
                         "scatter-gather q01 QPS, byte-equality incl. a "
                         "distributed-shuffle join")
    ap.add_argument("--serving", action="store_true",
                    help="end-to-end model serving over the sharded pool: "
                         "deploy + batched scoring frames via "
                         "ModelServing, with byte-equality / one-program-"
                         "per-shard / <=1-N structural gates")
    ap.add_argument("--failover", action="store_true",
                    help="failover under traffic: client-observed p99 "
                         "blip across a leader kill on an armed HA pair, "
                         "exact-totals gated")
    ap.add_argument("--fusion-distributed", action="store_true",
                    help="distributed fusion paired A/B: N-daemon scatter "
                         "q01 + 3-sink fan under the optimal mapper vs "
                         "greedy vs plan_fusion=off, with one-program-per-"
                         "shard + byte-equality gates")
    ap.add_argument("--sessions", action="store_true",
                    help="stateful serving: N concurrent decode sessions "
                         "over a sharded pool — aggregate steps/s gated on "
                         "one step program, zero warm arena reads, "
                         "byte-equality vs solo replay")
    ap.add_argument("--rebalance", action="store_true",
                    help="self-rebalancing paired A/B: 80/20 skewed mix "
                         "over a 4-daemon pool, a 5th daemon registers "
                         "mid-run — rebalance on vs frozen, recovery "
                         "throughput + exactness gates")
    ap.add_argument("--daemons", type=int, default=4,
                    help="pool size for --scale (leader + N-1 shards)")
    ap.add_argument("--rows", type=int, default=6_000_000,
                    help="lineitem rows for --scale")
    ap.add_argument("--table-mb", type=int, default=64)
    args = ap.parse_args(argv)
    device = str(resolve_device(args.platform or args.device))
    if args.worker:
        out = run_client_worker(args.address, args.client_id, args.jobs,
                                args.batch)
    elif args.serving:
        out = run_serving_bench(daemons=args.daemons, device=device)
    elif args.failover:
        out = run_failover_bench(device=device)
    elif args.fusion_distributed:
        out = run_fusion_distributed_bench(daemons=args.daemons,
                                           device=device)
    elif args.sessions:
        out = run_sessions_bench(device=device)
    elif args.rebalance:
        out = run_rebalance_bench(daemons=args.daemons, device=device)
    elif args.scale:
        out = run_scaleout_bench(rows=args.rows, daemons=args.daemons,
                                 device=device)
    elif args.scheduler:
        out = run_scheduler_bench(
            clients=args.clients if args.clients is not None else 8,
            device=device)
    elif args.partial_cache:
        out = run_partial_cache_bench(device=device)
    elif args.device_cache:
        out = run_device_cache_bench(device=device)
    elif args.data_plane:
        out = run_data_plane_bench(table_mb=args.table_mb, device=device)
    elif args.stream:
        out = run_stream_bench(device=device)
    else:
        out = run_serve_bench(clients=args.clients
                              if args.clients is not None else 2,
                              jobs_per_client=args.jobs, batch=args.batch,
                              port=args.port, device=device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
