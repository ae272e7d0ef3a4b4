"""The LA DSL of the port (``dsl/``) against the JAX package's, on the
CPU: the parser's AST against the reference parser's on every program of
``tests/test_dsl.py`` and on the reference PDML corpus that
``tests/test_dsl_corpus.py`` inlines; ``run_pdml`` against the
reference's ``run_pdml`` on the same ``load`` files (and against that
file's numpy oracle); statements materialised as sets of a client; and
the Client's set methods the interpreter uses against the reference
``Client``."""

import zlib

import numpy as np
import pytest

from netsdb_tpu.client import Client as JaxClient
from netsdb_tpu.config import Configuration as JaxConfiguration
from netsdb_tpu.dsl import parse_program as jax_parse
from netsdb_tpu.dsl import run_pdml as jax_run
from netsdb_tpu_torch import Client
from netsdb_tpu_torch.config import Configuration
from netsdb_tpu_torch.dsl import (LAInterpreter, load_block_file,
                                  parse_program, run_pdml)
from test_dsl_corpus import CORPUS, _np_run, _write_block_file

# the programs of tests/test_dsl.py
DSL_PROGRAMS = {
    "sample00_surface": """
A = zeros(4,4,2,2)
B = ones(4,4,2,2)
D = identity(4,2)
E = A + B
F = A - B
G = A * B
H = A '* B
I = A %*% B
J = A^T
L = max(B)
M = min(B)
N = rowMax(B)
O = rowMin(B)
P = rowSum(B)
Q = colMax(B)
R = colMin(B)
S = colSum(B)
T = duplicateRow(P^T, 2, 2)
U = duplicateCol(P, 2, 2)
""",
    "precedence": "D = ones(2,2,1,1)\nM = ones(2,2,1,1)\nR = D %*% M * D\n",
    "inverse_transpose": "A = identity(3,2)\nB = A^-1\nC = (A + A)^T\n",
    "materialize": "A = ones(2,2,2,2)\nB = A + A\n",
    "load": 'X1 = load(4,2,3,2,"gram.data")\nResult = X1 \'* X1\n',
    "comments_and_parens": "# a comment\nA = ones(2,2,2,2)  # trailing\n"
                           "B = ((A) + (A '* A)^T)\n",
}


def norm(node):
    """An AST node as plain tuples, comparable across the two parsers."""
    return (node.kind, node.value, tuple(norm(c) for c in node.children),
            tuple(node.args))


def ast_of(parse, text):
    return [(s.target, norm(s.expr)) for s in parse(text)]


@pytest.mark.parametrize("name", sorted(DSL_PROGRAMS) + sorted(CORPUS))
def test_parser_matches_reference(name):
    text = DSL_PROGRAMS[name] if name in DSL_PROGRAMS else CORPUS[name][0]
    assert ast_of(parse_program, text) == ast_of(jax_parse, text)


@pytest.mark.parametrize("bad", ["A = ", "= B", 'A = load(1,2,"x.data")',
                                 "A = ones(2,2)", "A = B $ C"])
def test_parse_errors_match_reference(bad):
    with pytest.raises(SyntaxError):
        jax_parse(bad)
    with pytest.raises(SyntaxError):
        parse_program(bad)


def corpus_files(name, tmp_path):
    """The corpus program with its ``load`` placeholders written as
    reference-format block files, as tests/test_dsl_corpus.py does."""
    program, loads = CORPUS[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()) % 2**31)
    files, paths = {}, {}
    for ph, (rows, cols, br, bc) in loads.items():
        dense = rng.standard_normal((rows, cols)).astype(np.float32)
        if name == "sample02_L2" and ph == "X":
            dense += np.eye(rows, cols, dtype=np.float32) * 3
        p = str(tmp_path / f"{ph}.data")
        _write_block_file(p, dense, br, bc)
        files[p], paths[ph] = dense, p
    return program.format(**paths), files


def close_env(ours, ref, tol):
    assert set(ours) == set(ref)
    for var, r in ref.items():
        o = ours[var]
        assert o.shape == tuple(r.shape), var
        assert o.meta.block_shape == tuple(r.meta.block_shape), var
        assert o.device.type == "cpu"
        np.testing.assert_allclose(o.data.numpy(), np.asarray(r.data),
                                   err_msg=var, **tol)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_corpus_matches_reference_and_oracle(name, tmp_path):
    program, files = corpus_files(name, tmp_path)
    ours = run_pdml(program, device="cpu")
    close_env(ours, jax_run(program), dict(rtol=1e-4, atol=1e-5))
    for var, expect in _np_run(program, files).items():
        np.testing.assert_allclose(ours[var].to_dense().double().numpy(),
                                   expect, rtol=2e-4, atol=1e-5, err_msg=var)


@pytest.mark.parametrize("name", ["sample00_surface", "precedence",
                                  "inverse_transpose", "comments_and_parens"])
def test_dsl_programs_match_reference(name):
    text = DSL_PROGRAMS[name]
    close_env(run_pdml(text, device="cpu"), jax_run(text),
              dict(rtol=1e-5, atol=1e-5))


def test_load_block_file_matches_reference(tmp_path):
    from netsdb_tpu.dsl.interp import load_block_file as jax_load

    dense = np.random.default_rng(0).standard_normal((12, 4)).astype(
        np.float32)
    path = str(tmp_path / "gram.data")
    _write_block_file(path, dense, 4, 2)
    np.testing.assert_array_equal(load_block_file(path, 4, 2, 3, 2),
                                  jax_load(path, 4, 2, 3, 2))
    npy = str(tmp_path / "m.npy")
    np.save(npy, dense)
    np.testing.assert_array_equal(load_block_file(npy, 4, 2, 3, 2), dense)
    with pytest.raises(ValueError, match="declared"):
        load_block_file(npy, 4, 2, 2, 2)
    prog = f'X1 = load(4,2,3,2,"{path}")\nResult = X1 \'* X1\n'
    close_env(run_pdml(prog, device="cpu"), jax_run(prog),
              dict(rtol=1e-5, atol=1e-5))


@pytest.fixture()
def clients(tmp_path):
    return (JaxClient(JaxConfiguration(root_dir=str(tmp_path / "jax"))),
            Client(Configuration(root_dir=str(tmp_path / "port")),
                   device="cpu"))


def test_interpreter_materialises_sets(clients):
    """Each statement's result becomes a set of the client's database, as
    the reference's statements do, and a second program overwrites it."""
    jc, pc = clients
    for text in (DSL_PROGRAMS["materialize"],
                 "A = identity(2,2)\nB = A + A * A\n"):
        jax_run(text, client=jc, db="la")
        env = run_pdml(text, client=pc, db="la")
        for var in ("A", "B"):
            assert pc.set_exists("la", var) and jc.set_exists("la", var)
            got = pc.get_tensor("la", var)
            np.testing.assert_array_equal(
                got.data.numpy(), np.asarray(jc.get_tensor("la", var).data))
        assert pc.get_tensor("la", "B") is env["B"]
    assert LAInterpreter(client=pc).device == pc.device
    with pytest.raises(NameError, match="undefined"):
        run_pdml("A = B + B\n", device="cpu")


def test_set_methods_match_reference(clients):
    """``set_exists``, ``get_set_iterator`` and ``remove_set`` on the same
    sequence of calls through both clients."""
    seen = []
    for c in clients:
        c.create_database("d")
        c.create_set("d", "objs", type_name="object")
        c.send_data("d", "objs", [{"k": 1}, {"k": 2}, "three"])
        c.create_set("d", "m")
        c.send_matrix("d", "m", np.arange(6, dtype=np.float32).reshape(2, 3),
                      (2, 2))
        items = list(c.get_set_iterator("d", "objs"))
        (mat,) = list(c.get_set_iterator("d", "m"))
        exists = [c.set_exists("d", s) for s in ("objs", "m", "nope")]
        c.remove_set("d", "objs")
        c.remove_set("d", "nope")  # removing an unknown set is a no-op
        after = [c.set_exists("d", s) for s in ("objs", "m")]
        with pytest.raises(KeyError):
            list(c.get_set_iterator("d", "objs"))
        c.create_set("d", "objs", type_name="object")  # created afresh
        seen.append((items, np.asarray(mat.to_dense()).tolist(), exists,
                     after, list(c.get_set_iterator("d", "objs"))))
    assert seen[0] == seen[1]


def test_paged_set_iterator_raises(tmp_path):
    c = Client(Configuration(root_dir=str(tmp_path / "port"),
                             page_size_bytes=4096, page_pool_bytes=16384),
               device="cpu")
    c.create_database("d")
    c.create_set("d", "p", storage="paged")
    c.send_matrix("d", "p", np.ones((64, 32), np.float32), (16, 32))
    with pytest.raises(ValueError, match="paged matrix"):
        c.get_set_iterator("d", "p")
    in_use = c.store.page_store().stats()["bytes_in_use"]
    c.remove_set("d", "p")
    assert not c.set_exists("d", "p")
    assert c.store.page_store().stats()["bytes_in_use"] < in_use


@pytest.mark.parametrize("kwargs,exc,item", [
    (dict(eviction="fifo"), ValueError, "eviction"),
    (dict(type_name="table", storage="paged", eviction="mru",
          placement={"axes": [["dp", 0]], "spec": ["dp"]}),
     NotImplementedError, "ROADMAP.md A4")])
def test_create_set_options_the_port_cannot_honour_raise(clients, kwargs,
                                                         exc, item):
    """Set eviction is ported (``mru`` and ``random`` too:
    ``tests/test_torch_eviction.py``); a policy the reference does not
    have, and a paged and placed relation (A4), still raise."""
    _, pc = clients
    pc.create_database("d")
    if exc is NotImplementedError:
        # a paged and placed relation was A4 and is ported
        pc.create_set("d", "p", **kwargs)
        assert pc.set_exists("d", "p")
    else:
        with pytest.raises(exc, match=item):
            pc.create_set("d", "s", **kwargs)
    assert not pc.set_exists("d", "s")
    pc.create_set("d", "s", eviction="lru")  # the reference's default
    assert pc.set_exists("d", "s")
