"""The grace-hash pairs overlap (the port's counterpart of
``tests/test_devcache.py::test_grace_pairs_overlap_and_sequential_does_not``).

``plan/executor._run_fold_grace`` stages pair i+1's build partition on a
staging thread while pair i probes. The staging event log
(``plan/staging.trace_events``/``events``) records, in order, each
stream's "place" (an item placed), "end", "close" (the consumer saw the
end or closed it) and "cache_hit" milestones, so the test reads the
overlap as an ORDER: pair 1's build "place" comes before pair 0's probe
"close". At ``stage_depth`` 0 the pairs run one after another and the
order flips; a change that serialised the pairs fails here.

On the CPU, with the reference tests' arena (1 KiB pages, a 16 KiB
pool), the reference's Q03 split into its build and probe sinks."""

import pytest

from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.plan import staging
from netsdb_tpu_torch.relational import dag as rdag
from netsdb_tpu_torch.relational.queries import tables_from_rows
from netsdb_tpu_torch.storage.store import SetIdentifier
from netsdb_tpu_torch.workloads import tpch


def _grace_client(tmp_path, scale=6):
    tables = tables_from_rows(tpch.generate(scale=scale, seed=3),
                              device="cpu")
    cfg = Configuration(root_dir=str(tmp_path / "grace"),
                        page_size_bytes=1024, page_pool_bytes=16384)
    c = Client(cfg, device="cpu")
    c.create_database("d")
    for name, t in tables.items():
        c.create_set("d", name, type_name="table",
                     storage="paged" if name == "lineitem" else "memory")
        c.send_table("d", name, t)
    cust = c.analyze_set("d", "customer")
    orders = c.analyze_set("d", "orders")
    c.create_set("d", "q03_build", type_name="table", storage="paged")
    c.execute_computations(rdag.q03_build_sink(
        "d", n_customers=cust["stats"]["c_custkey"].key_space,
        segment_code=cust["dicts"]["c_mktsegment"].index("BUILDING")))
    bpc = c.store.get_items(SetIdentifier("d", "q03_build"))[0]
    assert bpc.num_pages() > 1  # real partition pairs
    return c, orders["stats"]["o_orderkey"].key_space


def _grace_events(c, n_orders):
    staging.trace_events(True)
    try:
        out = rdag.run_query(c, rdag.q03_probe_sink("d", n_orders=n_orders))
        return staging.events(), out
    finally:
        staging.trace_events(False)


def _overlap_indices(evs):
    """(index of pair 1's build placement, index of pair 0's probe-stream
    close) in the event log; None when absent."""
    build1 = next((i for i, (k, n, s) in enumerate(evs)
                   if k == "place" and n.startswith("grace-build:")
                   and s == 1), None)
    probe0_done = next((i for i, (k, n, _s) in enumerate(evs)
                        if k == "close" and n.startswith("tables:")
                        and "#gr" in n), None)
    return build1, probe0_done


@pytest.fixture(scope="module")
def grace(tmp_path_factory):
    c, n_orders = _grace_client(tmp_path_factory.mktemp("grace"))
    # warm first: the assertion is about the steady state's overlap
    rdag.run_query(c, rdag.q03_probe_sink("d", n_orders=n_orders))
    return c, n_orders


@pytest.mark.parametrize("depth", [None, 0])
def test_grace_pairs_overlap_and_sequential_does_not(grace, depth):
    c, n_orders = grace
    cfg = c.store.page_store().config
    before = cfg.stage_depth
    if depth is not None:
        cfg.stage_depth = depth
    try:
        evs, _ = _grace_events(c, n_orders)
    finally:
        cfg.stage_depth = before
    build1, probe0_done = _overlap_indices(evs)
    assert build1 is not None and probe0_done is not None, evs[:20]
    if depth is None:
        # overlap: pair 1's build was placed before pair 0's probe ended
        assert before > 0 and build1 < probe0_done, (build1, probe0_done)
    else:
        # stage depth 0 runs the pairs one after another
        assert build1 > probe0_done, (build1, probe0_done)
    assert staging.active_count() == 0  # no staging thread outlives it


def test_grace_result_does_not_depend_on_the_overlap(grace):
    c, n_orders = grace
    cfg = c.store.page_store().config
    _, overlapped = _grace_events(c, n_orders)
    before, cfg.stage_depth = cfg.stage_depth, 0
    try:
        _, sequential = _grace_events(c, n_orders)
    finally:
        cfg.stage_depth = before
    rows = overlapped.to_rows()
    assert rows and rows == sequential.to_rows()


def test_the_event_log_records_nothing_while_off(grace):
    c, n_orders = grace
    staging.trace_events(True)
    staging.trace_events(False)  # clears, and stays empty while off
    rdag.run_query(c, rdag.q03_probe_sink("d", n_orders=n_orders))
    assert staging.events() == []
