"""Text classification: word2vec front end + semantic-classifier layer —
counterpart of ``netsdb_tpu/models/text_classifier.py`` (reference
``model-inference/text-classification``, test program
``src/word2vec/source/TestSemanticClassifier.cc``). Layer 1 is the
word2vec embedding matmul; layer 2 is ``SemanticClassifier``, a whole
FC layer (weights, bias, softmax over the classes) in one UDF
(``src/word2vec/headers/SemanticClassifier.h``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.models._common import as_f32, create_sets
from netsdb_tpu_torch.ops import embedding as emb_ops
from netsdb_tpu_torch.ops import nn as nn_ops
from netsdb_tpu_torch.ops.matmul import matmul_t
from netsdb_tpu_torch.plan.computations import Join, ScanSet, WriteSet


class TextClassifierModel:
    SETS = ("embeddings", "inputs", "fc_w", "fc_b", "output")

    def __init__(self, db: str = "textcls", block: Tuple[int, int] = (512, 512),
                 compute_dtype: Optional[str] = None):
        self.db = db
        self.block = block
        self.compute_dtype = compute_dtype

    def setup(self, client) -> None:
        create_sets(client, self.db, self.SETS)

    def load_weights(self, client, embeddings, fc_w, fc_b) -> None:
        """``embeddings``: (vocab x dim); ``fc_w``: (classes x dim);
        ``fc_b``: (classes,)."""
        client.send_matrix(self.db, "embeddings", embeddings, self.block)
        client.send_matrix(self.db, "fc_w", fc_w, self.block)
        client.send_matrix(self.db, "fc_b", as_f32(fc_b).reshape(-1, 1),
                           (self.block[0], 1))

    def load_onehot_inputs(self, client, ids, vocab: int) -> None:
        """One-hot rows of ``ids``, built on the client's device."""
        onehot = emb_ops.one_hot_matrix(ids, vocab, device=client.device)
        client.send_matrix(self.db, "inputs", onehot, self.block)

    def semantic_classifier(self, feats: BlockedTensor, w: BlockedTensor,
                            b: BlockedTensor) -> BlockedTensor:
        """The whole-FC-layer UDF: softmax(W·featsᵀ + b) over classes.
        ``feats``: (batch x dim) → output (classes x batch)."""
        z = matmul_t(w, feats, self.compute_dtype)
        return nn_ops.ff_output_layer(z, b, axis=0)

    def build_inference_dag(self) -> WriteSet:
        cd = self.compute_dtype
        emb = ScanSet(self.db, "embeddings")
        x = ScanSet(self.db, "inputs")
        w = ScanSet(self.db, "fc_w")
        b = ScanSet(self.db, "fc_b")
        feats = Join(x, emb, fn=lambda o, t: emb_ops.embedding_matmul(t, o, cd),
                     label="Word2Vec")
        z = Join(w, feats, fn=lambda ww, ff: matmul_t(ww, ff, cd),
                 label="SemanticClassifierMatmul")
        probs = Join(z, b, fn=lambda zz, bb: nn_ops.ff_output_layer(zz, bb,
                                                                   axis=0),
                     label="SemanticClassifierSoftmax")
        return WriteSet(probs, self.db, "output")

    def inference(self, client) -> BlockedTensor:
        res = client.execute_computations(self.build_inference_dag(),
                                          job_name=f"{self.db}-inference")
        return next(iter(res.values()))

    def classify_bag_of_words(self, client, token_ids, segment_ids,
                              num_docs: int) -> torch.Tensor:
        """Sparse path: per-document mean embedding → FC layer → argmax
        (the reference's EmbeddingLookupSparse front end)."""
        feats = emb_ops.embedding_lookup_sparse(
            client.get_tensor(self.db, "embeddings"), token_ids,
            segment_ids, num_docs, "mean")  # (docs x dim)
        fb = BlockedTensor.from_dense(feats, self.block)
        probs = self.semantic_classifier(
            fb, client.get_tensor(self.db, "fc_w"),
            client.get_tensor(self.db, "fc_b"))
        return probs.to_dense().argmax(dim=0)
