"""The headline LA tasks of the port (``workloads/la_tasks.py``) on the
CPU at a small, ragged X (as ``tests/test_la_tasks.py``): each task's
result against numpy in float64 at the reference test's rtol = atol =
2e-4, and against the reference's ``compile_pdml`` on the same inputs
within 1e-5; ``make_inputs`` keeps the zero margin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from netsdb_tpu.core.blocked import BlockMeta as JaxMeta
from netsdb_tpu.core.blocked import BlockedTensor as JaxBlocked
from netsdb_tpu.workloads import la_tasks as jax_tasks
from netsdb_tpu_torch.workloads import la_tasks

ROWS, COLS, BLOCK = 50, 12, 8  # ragged on purpose
LAM = 1.0


def env_of(task, seed=0):
    env = la_tasks.make_inputs(task, ROWS, COLS, BLOCK, lam=LAM, seed=seed,
                               device="cpu")
    return env, {k: v.to_dense().double().numpy() for k, v in env.items()}


@pytest.mark.parametrize("task", la_tasks.TASKS)
def test_task_matches_numpy(task):
    env, npenv = env_of(task)
    out = la_tasks.compile_pdml(la_tasks.PROGRAMS[task])(env)
    X = npenv["X"]
    name, want = {
        "gram": lambda: ("G", X.T @ X),
        "matmul": lambda: ("C", X @ npenv["W"]),
        "linreg": lambda: ("w", np.linalg.solve(X.T @ X + LAM * np.eye(COLS),
                                                X.T @ npenv["y"])),
    }[task]()
    got = out[name].to_dense().numpy()
    assert got.shape == want.shape and out[name].device.type == "cpu"
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("task", la_tasks.TASKS)
def test_task_matches_reference_compile_pdml(task):
    env, _ = env_of(task, seed=3)
    jenv = {k: JaxBlocked(jnp.asarray(v.data.numpy()),
                          JaxMeta(v.shape, v.meta.block_shape))
            for k, v in env.items()}
    ref = jax_tasks.compile_pdml(jax_tasks.PROGRAMS[task])(jenv)
    ours = la_tasks.compile_pdml(la_tasks.PROGRAMS[task])(env)
    assert set(ours) == set(ref)
    for name, r in ref.items():
        assert ours[name].shape == tuple(r.shape)
        assert ours[name].meta.block_shape == tuple(r.meta.block_shape)
        np.testing.assert_allclose(ours[name].data.numpy(), np.asarray(r.data),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("task", la_tasks.TASKS)
def test_make_inputs_keeps_the_zero_margin(task):
    env, _ = env_of(task)
    assert set(env) == {"gram": {"X"}, "linreg": {"X", "y", "LAMI"},
                        "matmul": {"X", "W"}}[task]
    for t in env.values():
        assert t.device.type == "cpu" and t.dtype == torch.float32
        assert torch.count_nonzero(t.data * (1 - t.mask())) == 0
    again, _ = env_of(task)  # seeded
    assert torch.equal(env["X"].data, again["X"].data)


def test_programs_and_reference_seconds_match_the_reference():
    assert la_tasks.PROGRAMS == jax_tasks.PROGRAMS
    assert la_tasks.TASKS == jax_tasks.TASKS
    assert la_tasks.REFERENCE_SECONDS == jax_tasks.REFERENCE_SECONDS
    with pytest.raises(ValueError, match="unknown task"):
        la_tasks.make_inputs("svd", ROWS, COLS, BLOCK, device="cpu")


def test_run_task_reports_its_device_and_the_reference_seconds():
    res = la_tasks.run_task("gram", rows=64, cols=16, block=8, iters=2,
                            device="cpu")
    assert res["device"] == "cpu" and res["timer"] == "host clock"
    assert res["reference_cluster_seconds"] == {"plain": 41.27,
                                                "best": 22.78}
    assert len(res["ms"]) == 2 and res["ms_p50"] > 0 and res["first_ms"] > 0
    assert set(la_tasks.run_all(rows=16, cols=8, block=4, iters=1,
                                device="cpu")) == set(la_tasks.TASKS)
