"""PDML parser — the port's own copy of ``netsdb_tpu/dsl/parser.py``
(host-only code, copied so the port imports nothing of the JAX package).

The reference's linear-algebra DSL grammar, hand-rolled: it
re-implements the flex/bison grammar (reference
``src/linearAlgebraDSL/source/LALexer.l``, ``LAParser.y``) as a
recursive-descent parser with the same precedence structure:

    statement  := IDENT '=' expression
    expression := additive
    additive   := mult (('+'|'-') mult)*            # left-assoc
    mult       := postfix (('%*%'|'*'|"'*") postfix)*  # matmul / scale / Aᵀ·B
    postfix    := primary ['^T' | '^-1']
    primary    := IDENT | initializer | builtin '(' ... ')' | '(' expression ')'
    initializer:= load(brS,bcS,brN,bcN,"path") | zeros/ones(brS,bcS,brN,bcN)
                | identity(blockSize, blockNum)
    builtin    := max min rowMax rowMin rowSum colMax colMin colSum
                | duplicateRow(expr, brS, brN) | duplicateCol(expr, bcS, bcN)

Dimension arguments follow the reference convention (block sizes and
block counts, see ``DSLSamples/sample00_Parser.pdml`` and the
TestDataGenerator scripts).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple, Union

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<matmul>%\*%)
  | (?P<tmul>'\*)
  | (?P<transpose>\^T)
  | (?P<inverse>\^-1)
  | (?P<num>\d+\.\d*|\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<string>"[^"]*")
  | (?P<op>[=+\-*(),])
    """,
    re.VERBOSE,
)

_BUILTIN_REDUCE = {"max", "min", "rowMax", "rowMin", "rowSum",
                   "colMax", "colMin", "colSum"}
_INITIALIZERS = {"load", "zeros", "ones", "identity"}


@dataclasses.dataclass
class Node:
    kind: str  # ident|init|unop|binop|reduce|duplicate
    value: Union[str, float, None] = None
    children: Tuple["Node", ...] = ()
    args: Tuple = ()

    def __repr__(self):
        return f"Node({self.kind},{self.value},{self.children},{self.args})"


@dataclasses.dataclass
class Statement:
    target: str
    expr: Node


def tokenize(text: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SyntaxError(f"bad character {text[pos]!r} at offset {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append((kind, m.group()))
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, text: str) -> None:
        kind, val = self.next()
        if val != text:
            raise SyntaxError(f"expected {text!r}, got {val!r}")

    def parse_program(self) -> List[Statement]:
        stmts = []
        while self.peek()[0] != "eof":
            stmts.append(self.parse_statement())
        return stmts

    def parse_statement(self) -> Statement:
        kind, name = self.next()
        if kind != "ident":
            raise SyntaxError(f"expected identifier, got {name!r}")
        self.expect("=")
        return Statement(name, self.parse_expression())

    def parse_expression(self) -> Node:
        node = self.parse_mult()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            rhs = self.parse_mult()
            node = Node("binop", "add" if op == "+" else "subtract",
                        (node, rhs))
        return node

    def parse_mult(self) -> Node:
        node = self.parse_postfix()
        while True:
            kind, val = self.peek()
            if kind == "matmul":
                self.next()
                node = Node("binop", "multiply", (node, self.parse_postfix()))
            elif kind == "tmul":
                self.next()
                node = Node("binop", "transpose_multiply",
                            (node, self.parse_postfix()))
            elif val == "*":
                self.next()
                node = Node("binop", "scale_multiply",
                            (node, self.parse_postfix()))
            else:
                return node

    def parse_postfix(self) -> Node:
        node = self.parse_primary()
        kind, _ = self.peek()
        if kind == "transpose":
            self.next()
            return Node("unop", "transpose", (node,))
        if kind == "inverse":
            self.next()
            return Node("unop", "inverse", (node,))
        return node

    def _int_args(self, n: int) -> Tuple[int, ...]:
        vals = []
        for k in range(n):
            kind, v = self.next()
            if kind != "num":
                raise SyntaxError(f"expected integer, got {v!r}")
            vals.append(int(float(v)))
            if k < n - 1:
                self.expect(",")
        return tuple(vals)

    def parse_primary(self) -> Node:
        kind, val = self.peek()
        if val == "(":
            self.next()
            node = self.parse_expression()
            self.expect(")")
            return node
        if kind != "ident":
            raise SyntaxError(f"unexpected token {val!r}")
        self.next()
        if val in _INITIALIZERS:
            self.expect("(")
            if val == "identity":
                args = self._int_args(2)
                self.expect(")")
                return Node("init", "identity", args=args)
            if val == "load":
                args = self._int_args(4)
                self.expect(",")
                skind, sval = self.next()
                if skind != "string":
                    raise SyntaxError(f"load path must be a string, got {sval!r}")
                self.expect(")")
                return Node("init", "load", args=args + (sval[1:-1],))
            args = self._int_args(4)
            self.expect(")")
            return Node("init", val, args=args)
        if val in _BUILTIN_REDUCE:
            self.expect("(")
            inner = self.parse_expression()
            self.expect(")")
            return Node("reduce", val, (inner,))
        if val in ("duplicateRow", "duplicateCol"):
            self.expect("(")
            inner = self.parse_expression()
            self.expect(",")
            args = self._int_args(2)
            self.expect(")")
            return Node("duplicate", val, (inner,), args)
        return Node("ident", val)


def parse_program(text: str) -> List[Statement]:
    return _Parser(tokenize(text)).parse_program()
