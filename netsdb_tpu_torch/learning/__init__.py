"""Self-learning placement — the port's ``netsdb_tpu/learning``: the
execution-history store, the rule and DRL placement advisors, the TPC-H
trace generation and training, and the live A/B harness."""

from netsdb_tpu_torch.learning.advisor import PlacementAdvisor
from netsdb_tpu_torch.learning.history import (HistoryDB, record_job,
                                               set_history_db)

__all__ = ["HistoryDB", "record_job", "set_history_db", "PlacementAdvisor"]
