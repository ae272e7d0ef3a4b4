"""The transformer layer through the port: ``TransformerLayerModel``'s
weight sets and its forward DAG over stored, unplaced activation sets,
so the single-device forward runs with B1 as its attention core."""

from __future__ import annotations

import torch

from netsdb_tpu_torch.models.transformer import TransformerLayerModel

DB = "perfbench_xformer"


class LayerSystem:
    def __init__(self, client, config: dict, data: dict):
        self.client = client
        model = TransformerLayerModel(db=DB, num_heads=config["n_head"])
        model.setup(client)
        # the model's own set layout (``load_random_weights``): each
        # weight blocked (min(512, rows), min(512, cols))
        for name, w in data["weights"].items():
            client.send_matrix(DB, name, w, (min(512, w.shape[0]),
                                             min(512, w.shape[1])))
        self.sinks = []
        for i, x in enumerate(data["inputs"]):
            client.create_set(DB, f"x_{i}")
            client.send_data(DB, f"x_{i}", [x])
            self.sinks.append(model.build_forward_dag(
                client, input_set=f"x_{i}", output_set=f"y_{i}",
                causal=config["causal"]))

    def request(self, i: int):
        results = self.client.execute_computations(
            self.sinks[i], job_name=f"{DB}-{i}")
        return next(iter(results.values()))

    @staticmethod
    def dense(out) -> torch.Tensor:
        return out


def open(client, config: dict, data: dict) -> LayerSystem:  # noqa: A001
    return LayerSystem(client, config, data)
