#!/usr/bin/env python3
"""Where a paged TPC-H request's device memory peaks, on one card.

Run from the repository root:  python3 paged_peaks.py [SF]

Builds ``chip_smoke.py``'s paged client at SF (default ``TPCH_SF``, 10):
lineitem, orders and partsupp in 64 MiB pages under a 1 GiB arena, the
other tables resident. For each of the ten suite queries, with the
compiled-program cache cleared first, four requests with the device
cache resized to 0 (so each reads its pages, as phase 12's cold request
does): ``first``, ``second`` and ``third`` through the program cache
(the first builds the query's programs; a fold's step captures from its
second request on), then ``node_by_node`` (the executor's eager
evaluator). Each prints one JSON line: the peak device memory above what
was allocated before the request (phase 12's measure), the ms, the
graphs captured and the bytes they reserved. The first two requests run
under ``torch.cuda.memory._record_memory_history``: their lines also
give the trace's own peak and what was live at it, summed by the
innermost three frames in ``netsdb_tpu_torch``. The card's name and
power limit come last. Exits non-zero without a card.
"""

from __future__ import annotations

import collections
import json
import sys
import tempfile


def live_at_peak(snapshot) -> tuple:
    """(peak bytes, [(site, bytes)] of the eight largest) over the trace's
    allocations and frees."""
    live, total, best, at_best = {}, 0, -1, {}
    for e in snapshot["device_traces"][0]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            total += e["size"]
        elif e["action"] == "free_requested":
            gone = live.pop(e["addr"], None)
            if gone is not None:
                total -= gone["size"]
        if total > best:
            best, at_best = total, dict(live)
    sites: "collections.Counter[str]" = collections.Counter()
    for e in at_best.values():
        frames = [f for f in e.get("frames", [])
                  if "netsdb_tpu_torch" in f.get("filename", "")]
        sites[";".join(
            f"{f['filename'].split('netsdb_tpu_torch/')[-1]}:{f['line']}"
            f":{f['name']}" for f in frames[:3]) or "?"] += e["size"]
    return best, sites.most_common(8)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("paged_peaks: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from netsdb_tpu_torch.plan import executor, programs
    from netsdb_tpu_torch.relational import dag
    from netsdb_tpu_torch.relational.bench import generate_host

    sf = float(sys.argv[1]) if len(sys.argv) > 1 else cs.TPCH_SF
    host = generate_host(sf, cs.SEED)
    root = tempfile.mkdtemp(prefix="netsdb_paged_peaks_")
    client, _ = cs._paged_card(host, root)
    cache = client.store.device_cache()
    try:
        for q in sorted(dag._QUERY_TABLES):
            sink = dag.suite_sink_for(client, "tpch", q)
            executor.clear_compiled_cache()
            for kind in ("first", "second", "third", "node_by_node"):
                cache.resize(0)
                c0 = programs.program_stats()
                traced = kind in ("first", "second")
                if traced:
                    torch.cuda.memory._record_memory_history(
                        max_entries=400000, stacks="python")
                run = ((lambda: cs.node_by_node(client, sink))
                       if kind == "node_by_node"
                       else (lambda: dag.run_query(client, sink)))
                _, rec = cs._rel_request(client, run)
                c1 = programs.program_stats()
                line = {"query": q, "request": kind,
                        "peak_above_mib": rec["peak_above_mib"],
                        "ms": rec["ms"], "captures": rec["captures"],
                        "capture_mib": (c1["capture_bytes"]
                                        - c0["capture_bytes"]) / 2**20}
                if traced:
                    snap = torch.cuda.memory._snapshot()
                    torch.cuda.memory._record_memory_history(enabled=None)
                    best, sites = live_at_peak(snap)
                    line["trace_peak_mib"] = best / 2**20
                    line["live_at_peak_mib"] = [(s, n / 2**20)
                                                for s, n in sites]
                print(json.dumps(line), flush=True)
            cache.resize(cs.PAGED_REL_CACHE_BYTES)
    finally:
        cs._close_paged({"client": client, "root": root})
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
