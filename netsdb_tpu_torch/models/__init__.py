"""Model workloads — the reference's in-database ML applications
(``src/FF``, ``src/LogReg``, ``src/word2vec``, ``src/conv2d_proj``,
``src/conv2d_memory_fusion``, ``src/LSTM``) and the transformer layer;
counterpart of ``netsdb_tpu/models/__init__.py``. The mixture-of-experts
layer (``models.moe``) runs on one device or expert-parallel over a mesh;
decode and the served pool are ROADMAP.md A5 and A7."""

from netsdb_tpu_torch.models.conv2d import Conv2DModel
from netsdb_tpu_torch.models.ff import FFModel
from netsdb_tpu_torch.models.logreg import LogRegModel
from netsdb_tpu_torch.models.lstm_model import LSTMModel
from netsdb_tpu_torch.models.text_classifier import TextClassifierModel
from netsdb_tpu_torch.models.transformer import TransformerLayerModel
from netsdb_tpu_torch.models.word2vec import Word2VecModel

__all__ = ["Conv2DModel", "FFModel", "LogRegModel", "LSTMModel",
           "TextClassifierModel", "TransformerLayerModel", "Word2VecModel"]
