"""The linear-algebra DSL (PDML): parser and interpreter."""

from netsdb_tpu_torch.dsl.interp import (LAInterpreter, load_block_file,
                                        run_pdml)
from netsdb_tpu_torch.dsl.parser import parse_program

__all__ = ["LAInterpreter", "load_block_file", "parse_program", "run_pdml"]
