"""Workloads over the port's sets: the headline LA tasks."""

from netsdb_tpu_torch.workloads.la_tasks import (PROGRAMS, REFERENCE_SECONDS,
                                                 TASKS, compile_pdml,
                                                 make_inputs, run_all,
                                                 run_task)

__all__ = ["PROGRAMS", "REFERENCE_SECONDS", "TASKS", "compile_pdml",
           "make_inputs", "run_all", "run_task"]
