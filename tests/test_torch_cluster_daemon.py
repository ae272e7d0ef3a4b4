"""The SPMD follower daemon, on the CPU: two joined processes, each with
a daemon over its own 4 of the 8 global positions (``serve/server.py``).
Process 1's daemon is the master's follower; a client talks only to the
master. The counterparts of the reference's
``tests/test_multihost_smoke.py:341`` (ingest, read back through
LOCAL_SHARDS, Q01, a non-replicated filter output read back, two
concurrent clients) and ``:520`` (a paged and placed lineitem, spills in
both daemons).

The harness is ``tests/test_torch_cluster_bringup.run_pair``. Q01 is held
against the numpy oracle, against the reference's one-process run on
``tests/conftest.py``'s 8 CPU devices (counts exactly, sums within
``SUM_RTOL``) and against the port's one-process run, bit for bit; the
rows read back against the rows sent, exactly.
"""

import numpy as np
import pytest

from netsdb_tpu_torch.workloads import tpch
from tests.test_torch_cluster_bringup import free_port, run_pair
from tests.test_torch_cluster_jobs import (Q01_COLS, SUM_RTOL, jax_q01,
                                           port_q01, q01_groups, q01_oracle)

_DAEMONS = """
    import socket, threading, time
    from netsdb_tpu_torch.config import Configuration
    from netsdb_tpu_torch.serve.server import ServeController

    paged = extra[0] == "paged"
    scale, seed = int(extra[1]), int(extra[2])
    p0, p1 = int(extra[3]), int(extra[4])
    cfg = Configuration(root_dir=os.path.join(OUT_DIR, f"d{pid}"),
                        **(dict(page_size_bytes=4096, page_pool_bytes=16384)
                           if paged else {}))

    def q01_out(ctl):
        res = ctl.library.get_table("tpch", "q01_out")
        for k in ("count", "l_linestatus", "l_returnflag", "sum_base_price",
                  "sum_charge", "sum_disc", "sum_disc_price", "sum_qty"):
            save(k, res.cols[k])

    if pid == 1:
        # the follower: runs every frame the master mirrors, over its own
        # positions of the one mesh, until the master shuts it down
        ctl = ServeController(cfg, port=p1, device="cpu")
        ctl.start()
        ctl.serve_forever()
        q01_out(ctl)
        if paged:
            st = ctl.library.store.page_store().stats()
            assert st["spills"] > 0 and st["loads"] > 0, st
        D.shutdown_cluster()
        print("DAEMON 1 OK")
        sys.exit(0)

    for _ in range(300):
        try:
            socket.create_connection(("127.0.0.1", p1), timeout=1).close()
            break
        except OSError:
            time.sleep(0.1)
    ctl = ServeController(cfg, port=p0, device="cpu",
                          followers=[f"127.0.0.1:{p1}"])
    ctl.start()
    from netsdb_tpu_torch.parallel.placement import Placement
    from netsdb_tpu_torch.plan.computations import (Aggregate, Apply,
                                                    ScanSet, WriteSet)
    from netsdb_tpu_torch.relational import dag
    from netsdb_tpu_torch.serve.client import RemoteClient
    from netsdb_tpu_torch.workloads import tpch

    rows = tpch.generate(scale=scale, seed=seed)["lineitem"]
    c = RemoteClient(f"127.0.0.1:{p0}")
    c.create_database("tpch")
    c.create_set("tpch", "lineitem", type_name="table",
                 storage="paged" if paged else "memory",
                 placement=Placement((("data", 8),), ("data",)))
    c.send_table("tpch", "lineitem", rows)
    if not paged:
        held = next(iter(ctl.library.get_table("tpch", "lineitem")
                         .cols.values()))
        assert held.mesh.spans_processes  # this daemon holds 4 of 8
        # read back through LOCAL_SHARDS: the master's blocks and its
        # follower's make the rows that were sent
        back = c.get_table("tpch", "lineitem")
        save("keys", np.sort(back["l_orderkey"].numpy()[
            back.mask().numpy()]))
    c.execute_computations(dag.q01_sink("tpch"), job_name="mh-q01",
                           fetch_results=False)
    q01_out(ctl)
    if paged:
        st = ctl.library.store.page_store().stats()
        assert st["spills"] > 0 and st["loads"] > 0, st
    else:
        # a non-replicated output: the rowwise filter keeps its blocks
        # where its input's are, and reads back whole
        sink = WriteSet(Apply(ScanSet("tpch", "lineitem"),
                              lambda t: t.filter(t["l_quantity"] > 25),
                              label="mh-filter", rowwise=True),
                        "tpch", "li_high")
        c.execute_computations(sink, job_name="mh-filter",
                               fetch_results=False)
        out_col = next(iter(ctl.library.get_table("tpch", "li_high")
                            .cols.values()))
        assert out_col.mesh.spans_processes
        high = c.get_table("tpch", "li_high")
        save("high", np.sort(high["l_orderkey"].numpy()[
            high.mask().numpy()]))
        # two concurrent clients, each its own aggregate
        results, errors = {}, []

        def run_client(tag):
            try:
                cc = RemoteClient(f"127.0.0.1:{p0}")
                cc.create_database(f"mh{tag}")
                cc.create_set(f"mh{tag}", "objs", type_name="object")
                cc.send_data(f"mh{tag}", "objs",
                             [{"v": i + tag} for i in range(50)])
                agg = WriteSet(Aggregate(
                    ScanSet(f"mh{tag}", "objs"), key=lambda r: 0,
                    value=lambda r: r["v"], combine=lambda a, b: a + b,
                    label=f"sum{tag}"), f"mh{tag}", "out")
                cc.execute_computations(agg, job_name=f"mh-conc-{tag}",
                                        fetch_results=False)
                results[tag] = dict(cc.get_set_iterator(f"mh{tag}",
                                                        "out"))[0]
                cc.close()
            except Exception as e:  # reported after the join
                errors.append(f"client {tag}: {e!r}")

        threads = [threading.Thread(target=run_client, args=(t,))
                   for t in (100, 200)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors and not any(t.is_alive() for t in threads), errors
        save("concurrent", [results[100], results[200]])
    RemoteClient(f"127.0.0.1:{p1}").shutdown_server()
    c.close()
    ctl.shutdown()
    D.shutdown_cluster()
    print("DAEMON 0 OK")
"""


@pytest.mark.parametrize("paged", [False, True], ids=["resident", "paged"])
def test_master_and_spmd_follower_daemons(tmp_path, paged):
    """``:341`` (resident, SF 1, seed 6) and ``:520`` (paged and placed in
    each daemon's 16 KiB arena, SF 4, seed 9)."""
    scale, seed = (4, 9) if paged else (1, 6)
    got = run_pair(tmp_path, _DAEMONS, "DAEMON",
                   extra_args=lambda: ("paged" if paged else "resident",
                                       scale, seed, free_port(),
                                       free_port()))
    rows = tpch.generate(scale=scale, seed=seed)["lineitem"]
    one, dicts = port_q01(tmp_path / "one", rows, paged)
    want, _ = jax_q01(tmp_path / "jax", rows)
    counts, _charge = q01_oracle(rows)
    for pid in (0, 1):
        cols = {k: got[f"{k}_{pid}"] for k in Q01_COLS}
        for k in Q01_COLS:
            np.testing.assert_array_equal(cols[k], one[k])
            if k in ("count", "l_returnflag", "l_linestatus"):
                np.testing.assert_array_equal(cols[k], want[k])
            else:
                np.testing.assert_allclose(cols[k], want[k], rtol=SUM_RTOL)
        assert {g: n for g, (n, _) in q01_groups(cols, dicts).items()} \
            == dict(counts)
    if not paged:
        np.testing.assert_array_equal(
            got["keys_0"], np.sort([r["l_orderkey"] for r in rows]))
        np.testing.assert_array_equal(
            got["high_0"], np.sort([r["l_orderkey"] for r in rows
                                    if r["l_quantity"] > 25]))
        assert got["concurrent_0"].tolist() == [
            sum(i + t for i in range(50)) for t in (100, 200)]
