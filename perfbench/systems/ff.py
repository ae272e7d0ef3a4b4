"""The FF classifier through the port: ``FFModel``'s sets and its
inference DAG (FFTransposeMult → FFReluBiasSum → FFInputLayerJoin →
FFOutputLayer) over stored input sets."""

from __future__ import annotations

import torch

from netsdb_tpu_torch.models.ff import FFModel

DB = "perfbench_ff"


class FFSystem:
    def __init__(self, client, config: dict, data: dict):
        block = tuple(config["block"])
        self.client = client
        model = FFModel(db=DB, block=block)
        model.setup(client)
        w = data["weights"]
        # the model's own set layout (``FFModel.load_weights``), from
        # tensors already on the card
        client.send_matrix(DB, "w1", w["w1"], block)
        client.send_matrix(DB, "b1", w["b1"].reshape(-1, 1), (block[0], 1))
        client.send_matrix(DB, "wo", w["wo"], block)
        client.send_matrix(DB, "bo", w["bo"].reshape(-1, 1), (block[0], 1))
        self.sinks = []
        for i, x in enumerate(data["inputs"]):
            client.create_set(DB, f"inputs_{i}")
            client.create_set(DB, f"output_{i}")
            client.send_matrix(DB, f"inputs_{i}", x, block)
            self.sinks.append(model.build_inference_dag(
                input_set=f"inputs_{i}", output_set=f"output_{i}"))

    def request(self, i: int):
        results = self.client.execute_computations(
            self.sinks[i], job_name=f"{DB}-{i}")
        return next(iter(results.values()))

    @staticmethod
    def dense(out) -> torch.Tensor:
        return out.to_dense()


def open(client, config: dict, data: dict) -> FFSystem:  # noqa: A001
    return FFSystem(client, config, data)
