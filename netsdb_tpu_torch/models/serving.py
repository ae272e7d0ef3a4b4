"""Model serving over the shard pool — the port's
``netsdb_tpu/models/serving.py``.

The reference serves inference by storing the model as blocked matrix
sets and scoring batches through the engine (``SimpleFF.cc`` with
``QueryClient.h:160-224``: many query clients, one loaded model). This
module is that pattern over the pool (``serve/shard.py``):

* **model-as-blocked-sets ingest** — :meth:`ModelServing.deploy` creates
  the batch-partitioned input set (``placement="range"``) on the leader
  and loads the weight sets onto every member: weights replicated,
  activations split by batch;
* **the layer-chain plan** — the model's inference DAG over the served
  sets, stamped with the ``scatter_gather`` declaration of the
  ``tensor_chain`` scatter kind (``plan/scatter.py``): each shard runs the
  whole chain over its rows as ONE program (the whole-plan CUDA graph for
  resident weights, the region mapper's programs for paged ones);
* **scoring frames** — :meth:`ModelServing.score` routes one batch to the
  shards (contiguous row slices, in parallel) and runs the chain
  pool-wide; the coordinator concatenates the outputs in slot order,
  byte-equal to one daemon (each output element comes from one shard's
  rows).

``explain=True`` returns the per-shard EXPLAIN forest, every node marked
with the daemon that ran it.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from netsdb_tpu_torch import obs


class ModelServing:
    """Serve one layer-chain model (``build_inference_dag`` and a
    ``db``/``block`` surface) over a leader and its workers.

    ``batch_axis`` is the output axis the batch runs along (1 for FF's
    ``(labels x batch)``); ``gather_mode="items"`` chains per-shard item
    lists instead (conv2d). ``sink_builder`` replaces
    ``model.build_inference_dag(input_set=..., output_set=...)``."""

    def __init__(self, model, leader_addr: str, input_set: str = "inputs",
                 output_set: str = "output", batch_axis: int = 1,
                 gather_mode: str = "concat",
                 block: Optional[Tuple[int, int]] = None,
                 sink_builder: Optional[Callable[[], Any]] = None,
                 timeout: Optional[float] = None):
        self.model = model
        self.leader_addr = leader_addr
        self.input_set = input_set
        self.output_set = output_set
        self.batch_axis = int(batch_axis)
        self.gather_mode = gather_mode
        self.block = tuple(block) if block is not None \
            else tuple(getattr(model, "block", ()) or ()) or None
        self.sink_builder = sink_builder
        self.timeout = timeout
        self.addrs: List[str] = []
        self._leader = None

    # --- lifecycle ----------------------------------------------------
    def _client(self):
        if self._leader is None:
            from netsdb_tpu_torch.serve.client import RemoteClient

            self._leader = RemoteClient(self.leader_addr,
                                        timeout=self.timeout)
        return self._leader

    def close(self) -> None:
        if self._leader is not None:
            self._leader.close()
            self._leader = None

    def deploy(self, load_model: Callable[[Any], None]) -> List[str]:
        """Create the batch-partitioned input set on the leader (one slot
        per member), then run ``load_model(client)`` against every member,
        so each daemon holds the whole weight sets the chain's weight
        scans read. Set creation is idempotent: a re-deploy refreshes the
        weights in place. Returns the slot addresses in slot order."""
        from netsdb_tpu_torch.serve.client import RemoteClient

        c = self._client()
        db = self.model.db
        c.create_database(db)
        c.create_set(db, self.input_set, type_name="tensor",
                     placement="range")
        entry = c._placement_entry(db, self.input_set, refresh=True)
        addrs = [sl["addr"] for sl in entry["slots"]]
        for addr in addrs:
            wc = RemoteClient(addr, timeout=self.timeout)
            try:
                load_model(wc)
            finally:
                wc.close()
        self.addrs = addrs
        obs.REGISTRY.counter("models.deploys").inc()
        return addrs

    def _sink(self):
        if self.sink_builder is not None:
            sink = self.sink_builder()
        else:
            sink = self.model.build_inference_dag(
                input_set=self.input_set, output_set=self.output_set)
        # the tensor_chain opt-in: the chain decomposes along `axis`
        sink.scatter_gather = {"axis": self.batch_axis, "block": self.block,
                               "mode": self.gather_mode}
        return sink

    # --- scoring ------------------------------------------------------
    def score(self, batch, explain: bool = False):
        """One scoring frame: routed batch ingest and the pool-wide chain.
        Returns the assembled output (blocked when ``block`` is declared);
        with ``explain=True``, ``(output, shard_operators)``."""
        from netsdb_tpu_torch.serve.protocol import CODEC_PICKLE, MsgType

        c = self._client()
        db = self.model.db
        batch = np.asarray(batch, np.float32)
        t0 = time.perf_counter()
        c.send_matrix(db, self.input_set, batch, self.block)
        reply = c._request(
            MsgType.EXECUTE_COMPUTATIONS,
            {"sinks": [self._sink()], "job_name": f"{db}-serve",
             "materialize": True, "explain": bool(explain)},
            codec=CODEC_PICKLE)
        value = next(iter(c._collect_results(reply["results"],
                                             True).values()))
        obs.REGISTRY.counter("models.batches_scored").inc()
        obs.REGISTRY.counter("models.rows_scored").inc(int(batch.shape[0]))
        obs.add("models.score_s", time.perf_counter() - t0)
        if explain:
            return value, reply.get("shard_operators")
        return value

    def score_batches(self, batches):
        """Score batches in arrival order over the deployed pool."""
        for batch in batches:
            yield self.score(batch)


def ff_serving(model, leader_addr: str, **kw) -> ModelServing:
    """FF: the batch runs along axis 1 of the ``(labels x batch)`` output,
    re-blocked with the model's block shape."""
    kw.setdefault("batch_axis", 1)
    return ModelServing(model, leader_addr, **kw)
