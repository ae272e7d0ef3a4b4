"""Processes joined into one cluster (``parallel/distributed.py``): the
bring-up, the ring across processes, the backend rule and a peer lost
mid-collective, on the CPU.

Each case runs two port processes over gloo, each bringing its own CPU
positions (``virtual_devices(n, "cpu")`` before ``initialize_cluster``),
with the harness of the reference's ``tests/test_multihost_smoke.py:65-112``
(fresh ports on each attempt, a per-process timeout, every process
killed on a hang, one retry). Each process writes what it computed; this
process holds it against the reference on ``tests/conftest.py``'s 8
virtual CPU devices (sums within the stated tolerance) and against the
port's own one-process run over the same positions, bit for bit.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from netsdb_tpu.parallel import distributed as jdist
from netsdb_tpu.parallel import ring as jring
from netsdb_tpu.parallel.mesh import make_mesh as jmake_mesh
from netsdb_tpu_torch.parallel import distributed as dist
from netsdb_tpu_torch.parallel import ring
from netsdb_tpu_torch.parallel.mesh import (ShardedTensor, make_mesh,
                                            position_sum, virtual_devices)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESS_TIMEOUT_S = 110  # each process; the pair is killed past it
RING_TOL = 1e-5          # the port's ring against the reference's

#: every worker joins as process ``argv[1]`` of 2 through ``argv[2]``,
#: with ``argv[4]`` CPU positions of its own, and writes into ``argv[3]``
PRELUDE = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    from netsdb_tpu_torch.parallel import distributed as D
    from netsdb_tpu_torch.parallel.mesh import virtual_devices

    pid, addr, OUT_DIR = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    positions = int(sys.argv[4])
    extra = sys.argv[5:]
    held = virtual_devices(positions, "cpu")  # held: its exit restores
    held.__enter__()
    assert D.initialize_cluster(addr, 2, pid, device="cpu", timeout_s=60)

    def save(name, value):
        np.save(os.path.join(OUT_DIR, f"{{name}}_{{pid}}.npy"),
                np.asarray(value))
""")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_pair(tmp_path, body: str, marker: str, positions: int = 4,
             extra_args=(), expect_rc=(0, 0)) -> dict:
    """Run ``PRELUDE + body`` as processes 0 and 1 of one cluster; each
    must print ``<marker> <pid> OK`` (a process expected to exit non-zero
    need not). Returns the arrays the workers saved, by file stem. Fresh
    ports each attempt; every process is killed on a hang; one retry
    (a free port claimed by another process between the probe and the
    bind)."""
    script_src = PRELUDE.format(repo=REPO) + textwrap.dedent(body)
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    last = ""
    for attempt in range(2):
        out = tmp_path / f"{marker}_{attempt}"
        out.mkdir()
        script = tmp_path / f"worker_{marker}_{attempt}.py"
        script.write_text(script_src)
        addr = f"127.0.0.1:{free_port()}"
        extra = extra_args() if callable(extra_args) else extra_args
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(pid), addr, str(out),
             str(positions), *map(str, extra)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in (0, 1)]
        outs, hung = [], False
        for p in procs:
            try:
                outs.append(p.communicate(timeout=PROCESS_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                hung = True
                break
        if hung:
            for p in procs:
                p.kill()
                p.wait()
            last = f"{marker}: the pair hung past {PROCESS_TIMEOUT_S} s"
            continue
        rcs = tuple(p.returncode for p in procs)
        ok = all(f"{marker} {pid} OK" in text
                 for pid, text in enumerate(outs) if expect_rc[pid] == 0)
        if rcs == tuple(expect_rc) and ok:
            return {f.stem: np.load(f) for f in out.glob("*.npy")}
        last = f"rcs {rcs}\n" + "\n---\n".join(outs)
    pytest.fail(f"two-process {marker} failed twice:\n{last}")


# --- bring-up -------------------------------------------------------------

_BRINGUP = """
    info = D.cluster_info()
    assert info["process_count"] == 2 and info["process_index"] == pid
    assert info["global_device_count"] == 8 and info["backend"] == "gloo"
    assert len(info["local_devices"]) == 4 and info["device_kind"] == "cpu"
    from netsdb_tpu_torch.parallel.mesh import (RemoteShardsError,
                                                ShardedTensor, position_sum)
    mesh = D.hybrid_mesh((2, 2))
    assert mesh.shape == {"hosts": 2, "data": 2, "model": 2}
    assert [int(o) for o in mesh.owners.flat] == [0] * 4 + [1] * 4
    # one global value sharded over every axis; the sum over all 8
    # positions sees every process's blocks (the cross-host psum)
    x = torch.arange(8.0).reshape(2, 2, 2)
    xs = ShardedTensor.from_dense(x, mesh, ("hosts", "data", "model"))
    assert sum(t is not None for t in xs.shards.flat) == 4
    parts = [None if t is None else t.sum() for t in xs.shards.flat]
    save("psum", position_sum(parts, owners=list(mesh.owners.flat)))
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    ys = ShardedTensor.from_dense(y, mesh, (("hosts", "data", "model"),))
    parts = [None if t is None else t.sum(0) for t in ys.shards.flat]
    save("psum_f32", position_sum(parts, owners=list(mesh.owners.flat)))
    try:
        ys.to_dense()
        raise SystemExit("to_dense read blocks another process holds")
    except RemoteShardsError as e:
        assert "gather_global" in str(e)
    save("gathered", ys.gather_global())
    D.shutdown_cluster()
    print("BRINGUP", pid, "OK")
"""


def test_two_process_bringup_sums_every_process_positions(tmp_path):
    got = run_pair(tmp_path, _BRINGUP, "BRINGUP")
    # the reference on conftest's 8 devices: one psum over every axis
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(
        2, 2, 2), ("hosts", "data", "model"))
    x = jnp.arange(8.0).reshape(2, 2, 2)
    xs = jax.device_put(x, NamedSharding(jmesh, P("hosts", "data", "model")))
    want = float(jax.jit(jnp.sum)(xs))
    assert want == 28.0
    rng = np.random.default_rng(7)
    y = rng.standard_normal((8, 16)).astype(np.float32)
    # the port in one process over the same 8 positions
    with virtual_devices(8, "cpu"):
        mesh = make_mesh((2, 2, 2), ("hosts", "data", "model"))
        ys = ShardedTensor.from_dense(torch.from_numpy(y), mesh,
                                      (("hosts", "data", "model"),))
        one = position_sum([t.sum(0) for t in ys.shards.flat]).numpy()
    for pid in (0, 1):
        assert float(got[f"psum_{pid}"]) == want
        np.testing.assert_array_equal(got[f"psum_f32_{pid}"], one)
        np.testing.assert_allclose(got[f"psum_f32_{pid}"], y.sum(0),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[f"gathered_{pid}"], y)


# --- the ring across processes -----------------------------------------

_RING = """
    from netsdb_tpu_torch.parallel import ring
    from netsdb_tpu_torch.parallel import _transport
    from netsdb_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, 64, 8)).astype(
        np.float32)) for _ in range(3))
    mesh = make_mesh((4,), ("data",))
    assert [int(o) for o in mesh.owners.flat] == [0, 0, 1, 1]
    for impl in ("naive", "flash"):
        out = ring.ring_attention(q, k, v, mesh, axis="data", impl=impl)
        assert sum(t is not None for t in out.shards.flat) == 2
        save(f"ring_{impl}", out.gather_global())
    save("ulysses", ring.ulysses_attention(q, k, v, mesh,
                                           axis="data").gather_global())
    assert _transport.stats()["messages"] > 0
    D.shutdown_cluster()
    print("RING", pid, "OK")
"""


def test_ring_attention_across_two_processes_equals_one_process(tmp_path):
    got = run_pair(tmp_path, _RING, "RING", positions=2)
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, 4, 64, 8)).astype(np.float32)
               for _ in range(3))
    with virtual_devices(4, "cpu"):
        mesh = make_mesh((4,), ("data",))
        args = [torch.from_numpy(a) for a in (q, k, v)]
        one = {impl: ring.ring_attention(*args, mesh, axis="data",
                                         impl=impl).to_dense().numpy()
               for impl in ("naive", "flash")}
        one_u = ring.ulysses_attention(*args, mesh,
                                       axis="data").to_dense().numpy()
    jmesh = jmake_mesh((4,), ("sp",), jax.devices()[:4])
    spec = NamedSharding(jmesh, P(None, None, "sp", None))
    want = np.asarray(jring.ring_attention(
        *(jax.device_put(jnp.asarray(a), spec) for a in (q, k, v)), jmesh,
        axis="sp", causal=True, impl="naive"))
    for pid in (0, 1):
        for impl in ("naive", "flash"):
            np.testing.assert_array_equal(got[f"ring_{impl}_{pid}"],
                                          one[impl])
            np.testing.assert_allclose(got[f"ring_{impl}_{pid}"], want,
                                       rtol=RING_TOL, atol=RING_TOL)
        np.testing.assert_array_equal(got[f"ulysses_{pid}"], one_u)


# --- a fold over a placed relation, its state merged or threaded --------

_FOLD = """
    from netsdb_tpu_torch.parallel.mesh import make_mesh
    from netsdb_tpu_torch.parallel.placement import lay_out_table
    from netsdb_tpu_torch.plan.fold import single_pass, tree_add_states
    from netsdb_tpu_torch.relational.sharded import run_fold_placed
    from netsdb_tpu_torch.relational.table import ColumnTable

    rng = np.random.default_rng(5)
    table = ColumnTable({"g": torch.from_numpy(rng.integers(
        0, 4, 1000).astype(np.int32)), "v": torch.from_numpy(
        rng.standard_normal(1000).astype(np.float32))}, {})
    placed = lay_out_table(table, make_mesh((8,), ("data",)), ("data",))

    def step(state, chunk):
        m = chunk.mask()
        return state.index_add(0, chunk["g"].long(), chunk["v"] * m)

    init = lambda prev, src: torch.zeros(4)
    for name, merge in (("merged", tree_add_states), ("threaded", None)):
        fold = single_pass(init, step, lambda st, src: st,
                           state_merge=merge)
        save(name, run_fold_placed(fold, placed))
    D.shutdown_cluster()
    print("FOLD", pid, "OK")
"""


def test_placed_folds_merge_or_thread_their_state_across_processes(
        tmp_path):
    """A fold declaring ``state_merge`` runs every position from init and
    merges the 8 states in position order (each process gets the other's
    4); any other threads one state through the positions in order,
    across the process boundary. Both equal one process bit for bit."""
    from netsdb_tpu_torch.parallel.placement import lay_out_table
    from netsdb_tpu_torch.plan.fold import single_pass, tree_add_states
    from netsdb_tpu_torch.relational.sharded import run_fold_placed
    from netsdb_tpu_torch.relational.table import ColumnTable

    got = run_pair(tmp_path, _FOLD, "FOLD")
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 1000).astype(np.int32)
    v = rng.standard_normal(1000).astype(np.float32)
    with virtual_devices(8, "cpu"):
        placed = lay_out_table(ColumnTable(
            {"g": torch.from_numpy(g), "v": torch.from_numpy(v)}, {}),
            make_mesh((8,), ("data",)), ("data",))
        one = {}
        for name, merge in (("merged", tree_add_states), ("threaded", None)):
            fold = single_pass(
                lambda prev, src: torch.zeros(4),
                lambda st, c: st.index_add(0, c["g"].long(),
                                           c["v"] * c.mask()),
                lambda st, src: st, state_merge=merge)
            one[name] = run_fold_placed(fold, placed).numpy()
    want = np.bincount(g, weights=v.astype(np.float64), minlength=4)
    for pid in (0, 1):
        for name in ("merged", "threaded"):
            np.testing.assert_array_equal(got[f"{name}_{pid}"], one[name])
            np.testing.assert_allclose(got[f"{name}_{pid}"], want,
                                       rtol=1e-5, atol=1e-5)


# --- the backend rule -----------------------------------------------------

def _report(host, kind, cards=()):
    return {"host": host, "type": kind, "positions": 2, "cards": list(cards)}


@pytest.mark.parametrize("case", ["cpu", "shared_card", "own_cards",
                                  "other_hosts", "nccl_refused",
                                  "gloo_asked"])
def test_backend_rule(case):
    """nccl only when the processes of each host own distinct cards; gloo
    for CPU positions and for processes sharing a card; an explicit nccl
    that cannot hold raises and never falls back."""
    cpu = [_report("h", "cpu"), _report("h", "cpu")]
    shared = [_report("h", "cuda", ["GPU-a"]), _report("h", "cuda",
                                                       ["GPU-a"])]
    own = [_report("h", "cuda", ["GPU-a"]), _report("h", "cuda", ["GPU-b"])]
    if case == "cpu":
        assert dist.choose_backend(cpu) == "gloo"
    elif case == "shared_card":
        assert dist.choose_backend(shared) == "gloo"
    elif case == "own_cards":
        assert dist.choose_backend(own) == "nccl"
    elif case == "other_hosts":
        # the same card id on two hosts is two cards
        assert dist.choose_backend([_report("h1", "cuda", ["GPU-a"]),
                                    _report("h2", "cuda", ["GPU-a"])]) \
            == "nccl"
    elif case == "nccl_refused":
        with pytest.raises(ValueError, match="share a card"):
            dist.choose_backend(shared, "nccl")
        with pytest.raises(ValueError, match="not on cards"):
            dist.choose_backend(cpu, "nccl")
    else:
        assert dist.choose_backend(own, "gloo") == "gloo"


# --- a peer lost mid-collective ------------------------------------------

_KILLED = """
    import time
    from netsdb_tpu_torch.parallel.mesh import (ShardedTensor, make_mesh,
                                                position_sum)
    from netsdb_tpu_torch.parallel._transport import PeerLost
    mesh = make_mesh((4,), ("data",))
    xs = ShardedTensor.from_dense(torch.arange(4.0), mesh, ("data",))
    parts = [None if t is None else t.sum() for t in xs.shards.flat]
    owners = list(mesh.owners.flat)
    assert float(position_sum(parts, owners=owners)) == 6.0
    if pid == 1:
        os._exit(3)  # dies before the next collective
    t0 = time.monotonic()
    try:
        position_sum(parts, owners=owners)
        raise SystemExit("a collective with a dead peer returned")
    except PeerLost:
        waited = time.monotonic() - t0
    assert waited < 60, waited  # within the group's timeout
    save("waited", waited)
    print("KILLED", pid, "OK")
"""


def test_a_killed_peer_raises_typed_within_the_group_timeout(tmp_path):
    got = run_pair(tmp_path, _KILLED, "KILLED", positions=2,
                   expect_rc=(0, 3))
    assert float(got["waited_0"]) < 60.0


# --- one process ------------------------------------------------------------

def test_one_process_positions_stay_local_outside_a_cluster():
    """Without a cluster every position is this process's: the sum of
    parts needs no owners, and a mesh spans no process."""
    with virtual_devices(4, "cpu"):
        mesh = make_mesh((4,), ("data",))
        assert not mesh.spans_processes
        assert mesh.local_positions() == list(mesh.positions())
        parts = [torch.tensor(float(i)) for i in range(4)]
        assert float(position_sum(parts)) == 6.0
        assert dist.cluster_info()["backend"] is None
    assert dist.joined() is None
    assert jdist.cluster_info()["process_count"] == 1
