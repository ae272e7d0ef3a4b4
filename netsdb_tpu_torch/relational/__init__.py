"""Columnar relational engine — counterpart of ``netsdb_tpu/relational/``
(its single-device "performance path").

Relations are column tables on one device (``table``); filters are
masks, group-bys segment reductions, equi-joins LUT or sort probes
(``kernels``), chosen from ingest-time statistics (``stats``,
``planner``, ``tuning``). The ten TPC-H queries of the reference run as
direct cores (``queries``) or as Computation DAGs over stored sets
through ``Client.execute_computations`` (``dag``, ``folds``);
``bench`` generates dbgen-shaped columns and times the queries.
"""

from netsdb_tpu_torch.relational.table import ColumnTable, date_to_int

__all__ = ["ColumnTable", "date_to_int"]
