"""PDML interpreter — counterpart of ``netsdb_tpu/dsl/interp.py``:
evaluates parsed statements over the port's op layer.

The reference walks its AST instantiating ``libLASilly*`` Computation
.so objects and calling executeComputations per statement
(``src/linearAlgebraDSL/source/LAEvaluateFunctions.cc``, test program
``TestLA21_Instance.cc``); results land in sets named by an
``LAPDBInstance``. Here each statement evaluates to a
``BlockedTensor`` (scalars stay 1x1) bound in an environment, with the
same operator semantics (``netsdb_tpu_torch.ops.linalg``); given a
client, every statement's result is also materialised as a set of the
client's database ``db``.

Values live on the interpreter's device: the client's, else ``device``
(CUDA unless the caller asks for another; an error where there is no
card). ``load`` reads the reference's block-per-line text format
(``TestDataGenerator/GramTestDataGenerator.py``: each line =
"blockRow blockCol v... (row-major block)") plus ``.npy`` arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from netsdb_tpu_torch.config import resolve_device
from netsdb_tpu_torch.core.blocked import BlockedTensor
from netsdb_tpu_torch.dsl.parser import Node, Statement, parse_program
from netsdb_tpu_torch.ops import linalg as la
from netsdb_tpu_torch.storage.store import SetIdentifier


def load_block_file(path: str, block_rows: int, block_cols: int,
                    block_row_num: int, block_col_num: int) -> np.ndarray:
    """Reference .data format: one block per line."""
    if path.endswith(".npy"):
        arr = np.load(path)
        expect = (block_rows * block_row_num, block_cols * block_col_num)
        if arr.shape != expect:
            raise ValueError(f"{path}: shape {arr.shape} != declared {expect}")
        return arr.astype(np.float32)
    out = np.zeros((block_rows * block_row_num, block_cols * block_col_num),
                   dtype=np.float32)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            bi, bj = int(parts[0]), int(parts[1])
            vals = np.asarray(parts[2:], dtype=np.float32)
            if vals.size != block_rows * block_cols:
                raise ValueError(
                    f"{path}: block ({bi},{bj}) has {vals.size} values, "
                    f"expected {block_rows * block_cols}")
            out[bi * block_rows:(bi + 1) * block_rows,
                bj * block_cols:(bj + 1) * block_cols] = (
                vals.reshape(block_rows, block_cols))
    return out


class LAInterpreter:
    """Environment of name → BlockedTensor (the LAPDBInstance role)."""

    def __init__(self, client=None, db: str = "la", device=None):
        self.env: Dict[str, BlockedTensor] = {}
        self.client = client
        self.db = db
        self.device = (client.device if client is not None
                       else resolve_device(device))
        if client is not None:
            client.create_database(db)

    def run(self, text: str) -> Dict[str, BlockedTensor]:
        for stmt in parse_program(text):
            self.execute(stmt)
        return self.env

    def execute(self, stmt: Statement) -> BlockedTensor:
        value = self.eval(stmt.expr)
        self.env[stmt.target] = value
        if self.client is not None:
            # materialize per-statement results as sets (reference flow)
            if not self.client.set_exists(self.db, stmt.target):
                self.client.create_set(self.db, stmt.target)
            self.client.store.put_tensor(SetIdentifier(self.db, stmt.target),
                                         value)
        return value

    def eval(self, node: Node) -> BlockedTensor:
        if node.kind == "ident":
            if node.value not in self.env:
                raise NameError(f"undefined matrix {node.value!r}")
            return self.env[node.value]
        if node.kind == "init":
            return self._eval_init(node)
        if node.kind == "unop":
            x = self.eval(node.children[0])
            if node.value == "transpose":
                return la.transpose(x)
            return la.inverse(x)
        if node.kind == "binop":
            a = self.eval(node.children[0])
            b = self.eval(node.children[1])
            if node.value in ("add", "subtract", "scale_multiply"):
                # elementwise ops tolerate mixed block granularity (e.g. a
                # matmul result + a loaded matrix): align to a's blocking
                if a.meta.block_shape != b.meta.block_shape:
                    b = b.reblock(a.meta.block_shape)
            if node.value == "add":
                return la.add(a, b)
            if node.value == "subtract":
                return la.subtract(a, b)
            if node.value == "scale_multiply":
                return la.scale_multiply(a, b)
            if node.value == "multiply":
                return la.matmul(a, b)
            if node.value == "transpose_multiply":
                return la.t_matmul(a, b)
            raise ValueError(node.value)
        if node.kind == "reduce":
            x = self.eval(node.children[0])
            if node.value in ("max", "min"):
                fn = la.max_element if node.value == "max" else la.min_element
                return BlockedTensor.from_dense(fn(x).reshape(1, 1), (1, 1),
                                                dtype=x.dtype)
            return {
                "rowMax": la.row_max, "rowMin": la.row_min,
                "rowSum": la.row_sum, "colMax": la.col_max,
                "colMin": la.col_min, "colSum": la.col_sum,
            }[node.value](x)
        if node.kind == "duplicate":
            x = self.eval(node.children[0])
            size, num = node.args
            if node.value == "duplicateRow":
                return la.duplicate_row(x, size * num, size)
            return la.duplicate_col(x, size * num, size)
        raise ValueError(f"unknown node {node.kind}")

    def _eval_init(self, node: Node) -> BlockedTensor:
        dev = self.device
        if node.value == "identity":
            size, num = node.args
            return la.identity(size * num, size, device=dev)
        br_size, bc_size, br_num, bc_num = node.args[:4]
        rows, cols = br_size * br_num, bc_size * bc_num
        if node.value == "zeros":
            return la.zeros(rows, cols, br_size, bc_size, device=dev)
        if node.value == "ones":
            return la.ones(rows, cols, br_size, bc_size, device=dev)
        if node.value == "load":
            dense = load_block_file(node.args[4], br_size, bc_size,
                                    br_num, bc_num)
            return BlockedTensor.from_dense(dense, (br_size, bc_size),
                                            device=dev)
        raise ValueError(node.value)


def run_pdml(text: str, client=None, db: str = "la",
             device=None) -> Dict[str, BlockedTensor]:
    """Parse + evaluate a PDML program (reference testLA21_Instance flow)."""
    return LAInterpreter(client, db, device).run(text)
