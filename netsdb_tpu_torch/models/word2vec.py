"""Word2vec embedding serving in the database — counterpart of
``netsdb_tpu/models/word2vec.py`` (the reference word2vec workload,
``src/word2vec/source/Word2Vec.cc:19-80``): the relational one-hot ⋈
table matmul DAG, the gather path and the segment-combined sparse
variant (``EmbeddingLookupSparse.h``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.models._common import create_sets
from netsdb_tpu_torch.ops import embedding as emb_ops
from netsdb_tpu_torch.plan.computations import Join, ScanSet, WriteSet


class Word2VecModel:
    SETS = ("weights", "inputs", "output")

    def __init__(self, db: str = "w2v", block: Tuple[int, int] = (512, 512),
                 compute_dtype: Optional[str] = None):
        self.db = db
        self.block = block
        self.compute_dtype = compute_dtype

    def setup(self, client, placements=None) -> None:
        """Create the database and its sets; ``placements`` maps a set
        name to its Placement (the inference DAG runs over the placed
        sets through the same ``execute_computations``)."""
        create_sets(client, self.db, self.SETS, placements)

    def load_embeddings(self, client, table) -> None:
        """``table``: (vocab x dim)."""
        client.send_matrix(self.db, "weights", table, self.block)

    def load_onehot_inputs(self, client, ids, vocab: int) -> None:
        """One-hot rows of ``ids``, built on the client's device."""
        onehot = emb_ops.one_hot_matrix(ids, vocab, device=client.device)
        client.send_matrix(self.db, "inputs", onehot, self.block)

    def build_inference_dag(self) -> WriteSet:
        """Relational form: onehot ⋈ weights matmul (Word2Vec.cc shape)."""
        cd = self.compute_dtype
        w = ScanSet(self.db, "weights")
        x = ScanSet(self.db, "inputs")
        out = Join(x, w, fn=lambda o, t: emb_ops.embedding_matmul(t, o, cd),
                   label="FFTransposeMult")
        return WriteSet(out, self.db, "output")

    def inference(self, client) -> BlockedTensor:
        res = client.execute_computations(self.build_inference_dag(),
                                          job_name=f"{self.db}-inference")
        return next(iter(res.values()))

    def lookup(self, client, ids) -> torch.Tensor:
        """Gather path — no one-hot materialisation."""
        return emb_ops.embedding_lookup(
            client.get_tensor(self.db, "weights"), ids)

    def lookup_sparse(self, client, ids, segment_ids, num_segments: int,
                      combiner: str = "mean") -> torch.Tensor:
        return emb_ops.embedding_lookup_sparse(
            client.get_tensor(self.db, "weights"), ids, segment_ids,
            num_segments, combiner)
