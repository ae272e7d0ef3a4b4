"""Workloads over the port's sets: the reference's analytics UDF families
(KMeans, GMM, LDA, PageRank, TopK; counterpart of
``netsdb_tpu/workloads/__init__.py``), the staged conv pipeline
(``workloads.conv_fusion``) and the headline LA tasks."""

from netsdb_tpu_torch.workloads.gmm import gmm_em
from netsdb_tpu_torch.workloads.kmeans import kmeans, kmeans_on_set
from netsdb_tpu_torch.workloads.la_tasks import (PROGRAMS, REFERENCE_SECONDS,
                                                 TASKS, compile_pdml,
                                                 make_inputs, run_all,
                                                 run_task)
from netsdb_tpu_torch.workloads.lda import lda_em
from netsdb_tpu_torch.workloads.pagerank import pagerank, pagerank_on_set
from netsdb_tpu_torch.workloads.topk import top_k, top_k_on_set

__all__ = ["PROGRAMS", "REFERENCE_SECONDS", "TASKS", "compile_pdml",
           "gmm_em", "kmeans", "kmeans_on_set", "lda_em", "make_inputs",
           "pagerank", "pagerank_on_set", "run_all", "run_task", "top_k",
           "top_k_on_set"]
