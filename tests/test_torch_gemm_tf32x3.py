"""The three-pass TF32 float32 product (``cuda_kernels.gemm_tf32x3``) and
the route that sends products to it (``ops.common.tf32x3_route``).

On the CPU: the tf32 splits (the split operand's three parts sum to it
exactly), the plain version against float64 in the three layouts the
cells use and on a one-hot lookup (exact), the router's decision table
(shapes on the ``meta`` device, the card's check forced true so the
other checks decide), the route counters and the ``kernels`` registry
section. The tests marked ``chip`` need the card and skip without one;
on the card:

    python3 -m pytest tests/test_torch_gemm_tf32x3.py -m chip
"""

import pytest
import torch

from netsdb_tpu_torch import obs
from netsdb_tpu_torch.ops import common, cuda_kernels as ck
from netsdb_tpu_torch.ops.common import hi_einsum, mxu_dot, tf32x3_route
from netsdb_tpu_torch.plan import programs

#: |plain - f64| against the sum of the terms' magnitudes, |a| @ |b|: a
#: float32 product is off by a few units of 2^-24 of it; one tf32 pass
#: (hi alone) by about 2^-11
PLAIN_REL_TOL = 2.0 ** -19


def counts():
    snap = obs.REGISTRY.snapshot()["counters"]
    return (snap.get("matmul.tf32x3", 0), snap.get("matmul.cublas_f32", 0))


@pytest.fixture
def sm90(monkeypatch):
    """The card's check forced true: CPU (or meta) tensors then meet the
    router as a card's would, and the kernel's wrapper runs its plain
    version on them."""
    monkeypatch.setattr(common, "on_sm90", lambda device=None: True)


@pytest.fixture
def small_crossover(monkeypatch, sm90):
    monkeypatch.setattr(common, "TF32X3_MIN_MACS", 1)


# ---------------------------------------------------------------- split

def test_split_tf32_rebuilds_x():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4096, generator=g) * torch.exp2(
        torch.randint(-60, 60, (4096,), generator=g).float())
    x = torch.cat([x, torch.tensor([0.0, -0.0, 1.0, -3.0, 1.00048828125])])
    hi, lo = ck.split_tf32(x)
    # hi is tf32: 13 low mantissa bits clear, and within half a tf32 unit
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    assert torch.equal(hi + lo, x)
    # lo as the tensor core reads it (tf32) still rebuilds x to 2^-22
    rebuilt = hi.double() + ck.tf32_truncate(lo).double()
    err = (rebuilt - x.double()).abs()
    assert (err <= x.double().abs() * 2.0 ** -22).all()


#: values whose rounding to tf32 carries into the next binade (the top 11
#: significant bits all ones, rounded up), and their negatives
CARRIED = [1.9999998807907104, 1.99951171875 + 2.0 ** -12, 3.9997558593750,
           2.0 ** 100 * 1.9999998807907104, 2.0 ** -100 * 1.99970703125]


def test_split_q_exact_sums_to_x():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(8192, generator=g) * torch.exp2(
        torch.randint(-60, 60, (8192,), generator=g).float())
    x = torch.cat([x, torch.tensor(CARRIED), -torch.tensor(CARRIED),
                   torch.tensor([0.0, -0.0, 1.0, 1.00048828125])])
    parts = ck.split_q_exact(x)
    for part in parts:  # each is tf32: the tensor core reads it whole
        assert torch.equal(ck.tf32_truncate(part), part)
    hi, mid, lo2 = parts
    # hi keeps x's binade, so every part lies within x's 24 bits
    exp = 0x7F800000
    assert torch.equal(hi.view(torch.int32) & exp, x.view(torch.int32) & exp)
    assert torch.equal(hi.double() + mid.double() + lo2.double(),
                       x.double())
    # summed smallest first in float32, as the kernel's chain adds them
    assert torch.equal((lo2 + mid) + hi, x)
    # the carried values are where rounding alone would leave the binade
    carried = torch.tensor(CARRIED)
    assert ((ck.split_tf32(carried)[0].view(torch.int32) & exp)
            != (carried.view(torch.int32) & exp)).all()


def test_split_rounds_to_nearest_ties_away():
    # 1 + 2^-11 is halfway between two tf32 values: away from zero
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12])
    hi, _ = ck.split_tf32(x)
    assert hi.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]


# -------------------------------------------------------- plain version

def _operands(layout, g):
    def rn(*s):
        return torch.randn(*s, generator=g)

    if layout == "matmul_t":  # W1 · Xᵀ: X's rows as the columns
        return rn(96, 64), rn(200, 64).t()
    if layout == "matmul":    # Wo · H: H with its batch contiguous
        return rn(40, 96), torch.relu(rn(96, 200))
    return rn(2, 100, 64).reshape(-1, 64), rn(64, 192)  # bse,ef->bsf


@pytest.mark.parametrize("layout", ["matmul_t", "matmul", "einsum"])
def test_plain_matches_float64(layout):
    a, b = _operands(layout, torch.Generator().manual_seed(11))
    exact = a.double() @ b.double()
    size = a.double().abs() @ b.double().abs()
    got = ck.gemm_tf32x3_plain(a, b)
    assert got.dtype == torch.float32
    assert ((got.double() - exact).abs() <= PLAIN_REL_TOL * size).all()
    # the tolerance tells the three passes from one
    one_pass = ck.split_tf32(a)[0] @ ck.split_tf32(b)[0]
    assert not ((one_pass.double() - exact).abs()
                <= PLAIN_REL_TOL * size).all()


def one_hot_lookup(rows, vocab, dim, g, device="cpu"):
    """(one-hot (rows, vocab), table (vocab, dim), ids): a table with the
    values whose rounding carries (:data:`CARRIED`) in its first rows, and
    ids that pick those rows first."""
    table = torch.randn(vocab, dim, generator=g, device=device)
    table[:2, :5] = torch.tensor(CARRIED, device=device)
    table[2:4, :5] = -torch.tensor(CARRIED, device=device)
    ids = torch.randint(0, vocab, (rows,), generator=g, device=device)
    ids[:4] = torch.arange(4, device=device)
    onehot = torch.nn.functional.one_hot(ids, vocab).float()
    return onehot, table, ids


def test_plain_picks_one_hot_rows_exactly():
    """A one-hot row against a table (the word2vec DAG's product) returns
    the table's row bit for bit, as an f32 product does: the one-hot is
    the larger operand, P, exact in tf32, and the table is Q, split into
    three parts that sum to it."""
    onehot, table, ids = one_hot_lookup(300, 64, 48,
                                        torch.Generator().manual_seed(9))
    assert ck.gemm_layout(onehot, table).q is table
    assert torch.equal(ck.gemm_tf32x3_plain(onehot, table), table[ids])


def test_wrapper_runs_the_plain_version_on_the_cpu():
    a, b = _operands("matmul", torch.Generator().manual_seed(2))
    before = ck.gemm_tf32x3.launches
    assert torch.equal(ck.gemm_tf32x3(a, b), ck.gemm_tf32x3_plain(a, b))
    assert ck.gemm_tf32x3.launches == before  # launches count the card's
    with pytest.raises(ValueError):
        ck.gemm_tf32x3(a, b.t())
    with pytest.raises(TypeError):
        ck.gemm_tf32x3(a.double(), b.double())


@pytest.mark.parametrize("layout,rmajor,transposed", [
    ("matmul_t", False, True), ("matmul", True, True),
    ("einsum", False, False)])
def test_layout_of_the_cells_products(layout, rmajor, transposed):
    a, b = _operands(layout, torch.Generator().manual_seed(1))
    lay = ck.gemm_layout(a, b)
    assert (lay.p_rmajor, lay.transposed) == (rmajor, transposed)
    # Q, the smaller operand, is the one the pre-pass splits
    assert lay.q.numel() == min(a.numel(), b.numel())


def test_layout_refuses_what_tma_cannot_read():
    a = torch.randn(64, 30)[:, :29]     # pitch of 120 bytes, no unit-16
    assert ck.gemm_layout(a, torch.randn(29, 8)) is None
    b = torch.randn(8, 200)[:, ::2]     # no unit stride
    assert ck.gemm_layout(torch.randn(4, 8), b) is None


# ------------------------------------------------------------ the router

def meta(*shape, t=False, dtype=torch.float32):
    """A tensor of ``shape`` on the meta device (no memory); ``t``: stored
    transposed (its last two dimensions swapped in memory)."""
    if t:
        return torch.empty(*shape[:-2], shape[-1], shape[-2], device="meta",
                           dtype=dtype).transpose(-1, -2)
    return torch.empty(*shape, device="meta", dtype=dtype)


# (case, a, b, compute_dtype, grad, expected reason or None)
ROUTES = [
    ("ff matmul_t: W1 X^T", lambda: meta(4096, 1024),
     lambda: meta(1024, 16384, t=True), None, False, None),
    ("ff matmul: Wo H", lambda: meta(1024, 4096),
     lambda: meta(4096, 16384), None, False, None),
    ("layer bse,ef->bsf", lambda: meta(1, 16384, 1024),
     lambda: meta(1024, 3072), None, False, None),
    ("layer bsf,fe->bse", lambda: meta(1, 16384, 4096),
     lambda: meta(4096, 1024), None, False, None),
    ("at the crossover", lambda: meta(2048, 1024), lambda: meta(1024, 1024),
     None, False, None),
    ("float64 (t_matmul's path)",
     lambda: meta(4096, 1024, dtype=torch.float64),
     lambda: meta(1024, 4096, dtype=torch.float64), None, False,
     "not float32"),
    ("bf16 compute_dtype", lambda: meta(4096, 1024),
     lambda: meta(1024, 4096), "bfloat16", False,
     "reduced-precision compute"),
    ("requires grad under grad mode", lambda: meta(4096, 1024),
     lambda: meta(1024, 4096).requires_grad_(), None, True,
     "an operand requires grad"),
    ("4-D batched (attention's einsum)", lambda: meta(1, 16, 16384, 64),
     lambda: meta(1, 16, 64, 16384), None, False, "not one 2-D product"),
    ("batched right operand (conv's im2col)", lambda: meta(64, 576),
     lambda: meta(8, 576, 4096), None, False, "not one 2-D product"),
    ("below the crossover", lambda: meta(1024, 1024),
     lambda: meta(1024, 1024), None, False, "below the crossover"),
    ("no unit stride", lambda: meta(4096, 2048)[:, ::2],
     lambda: meta(1024, 4096), None, False,
     "strides the kernel does not read"),
]


@pytest.mark.parametrize("case,a,b,cd,grad,expected", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_route_decision(sm90, case, a, b, cd, grad, expected):
    with torch.set_grad_enabled(grad):
        assert tf32x3_route(a(), b(), cd) == expected


def test_route_without_grad_mode_takes_a_grad_operand(sm90):
    with torch.no_grad():
        assert tf32x3_route(meta(4096, 1024),
                            meta(1024, 4096).requires_grad_()) is None


def test_an_einsum_of_another_form_stays(sm90):
    a, b = meta(16384, 1024), meta(1024, 4096)
    assert tf32x3_route(a, b, matrix=False) == "not one 2-D product"


def test_route_off_the_card():
    # no monkeypatch: CPU tensors never reach the kernel, and count nothing
    before = counts()
    a, b = torch.randn(4, 8), torch.randn(8, 2)
    assert tf32x3_route(a, b) == "not on an sm_90 card"
    assert torch.equal(mxu_dot(a, b), a @ b)
    assert counts() == before


@pytest.mark.parametrize("eq,expected", [
    ("bse,ef->bsf", True), ("bsf,fe->bse", True), ("td,de->te", True),
    ("bhqd,bhkd->bhqk", False), ("tec,td->ecd", False),
    ("ecd,edh->ech", False), ("se,fe->sf", False), ("ee,ef->ef", False)])
def test_weight_product_equations(eq, expected):
    assert common._is_weight_product(eq) is expected


# -------------------------------------------- the route, end to end

def test_mxu_dot_routes_and_counts(small_crossover):
    g = torch.Generator().manual_seed(5)
    w, x = torch.randn(48, 32, generator=g), torch.randn(80, 32, generator=g)
    t0, c0 = counts()
    got = mxu_dot(w, x.t())
    assert torch.equal(got, ck.gemm_tf32x3_plain(w, x.t()))
    assert counts() == (t0 + 1, c0)
    w.requires_grad_()
    with torch.enable_grad():
        out = mxu_dot(w, x.t())
    assert out.requires_grad and counts() == (t0 + 1, c0 + 1)
    mxu_dot(w.detach().double(), x.t().double())  # no f32 product
    mxu_dot(w.detach(), x.t(), compute_dtype="bfloat16")
    assert counts() == (t0 + 1, c0 + 1)


def test_hi_einsum_routes_and_counts(small_crossover):
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 24, 32, generator=g)
    w = torch.randn(32, 40, generator=g)
    t0, c0 = counts()
    got = hi_einsum("bse,ef->bsf", x, w)
    assert got.shape == (2, 24, 40)
    assert torch.equal(got.reshape(-1, 40),
                       ck.gemm_tf32x3_plain(x.reshape(-1, 32), w))
    q = torch.randn(1, 2, 24, 8, generator=g)
    hi_einsum("bhqd,bhkd->bhqk", q, q)  # stays on cuBLAS, counted there
    assert counts() == (t0 + 1, c0 + 1)


def test_a_copy_is_never_made_to_fold_rows(small_crossover):
    x = torch.randn(24, 2, 32).transpose(0, 1)   # (2, 24, 32), rows apart
    assert common._as_rows(x) is None
    assert tf32x3_route(x, torch.randn(32, 8)) == "not one 2-D product"
    assert common._as_rows(torch.randn(1, 24, 1, 32)).shape == (24, 32)


def test_ff_and_layer_send_every_product_to_the_kernel(small_crossover):
    """FF's two products and the layer's four take the route (the plain
    version on the CPU) and hold the cuBLAS forward's answer."""
    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.models.ff import FFModel
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel

    c = Client(device="cpu")
    ff = FFModel(db="ffroute", block=(16, 16))
    ff.setup(c)
    ff.load_random_weights(c, features=32, hidden=64, labels=8)
    g = torch.Generator().manual_seed(4)
    ff.load_inputs(c, torch.randn(40, 32, generator=g).numpy())
    t0, c0 = counts()
    out = ff.inference(c).to_dense()
    assert counts() == (t0 + 2, c0)
    p = ff.params_from_store(c)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "on_sm90", lambda device=None: False)
        ref = ff.forward(p, c.get_tensor("ffroute", "inputs")).to_dense()
    assert torch.allclose(out, ref, rtol=1e-5, atol=1e-6)

    layer = TransformerLayerModel(db="layerroute", num_heads=2)
    layer.setup(c)
    layer.load_random_weights(c, embed=16, seed=1)
    x = torch.randn(1, 24, 16, generator=g)
    layer.load_inputs(c, x.numpy())
    t0, _ = counts()
    y = next(iter(c.execute_computations(
        layer.build_forward_dag(c), job_name="layerroute").values()))
    assert counts()[0] == t0 + 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "on_sm90", lambda device=None: False)
        ref = layer.forward(layer.params_from_store(c), x)
    assert torch.allclose(y, ref, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- registry

def test_kernels_section_and_graph_counting():
    assert "gemm_tf32x3" in obs.REGISTRY.snapshot()["kernels"]
    assert ck.kernel_launches()["gemm_tf32x3"] == ck.gemm_tf32x3.launches
    assert ck.gemm_tf32x3 in programs._kernel_wrappers()


# ---------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is available here")
    if not common.on_sm90(torch.device("cuda")):
        pytest.skip("the kernel is built for sm_90a (Hopper)")
    return torch.device("cuda")


#: the cells' six products: (name, a, b) as the models hand them over
CELL_PRODUCTS = [
    ("ff matmul_t", lambda r: (r(4096, 1024) * 2 ** -4.5,
                               r(16384, 1024).t())),
    ("ff matmul", lambda r: (r(1024, 4096) * 2 ** -5.5,
                             torch.relu(r(4096, 16384)))),
    ("layer qkv", lambda r: (r(16384, 1024), r(1024, 3072) * 2 ** -5)),
    ("layer out", lambda r: (r(16384, 1024), r(1024, 1024) * 2 ** -5)),
    ("layer up", lambda r: (r(16384, 1024), r(1024, 4096) * 2 ** -5)),
    ("layer down", lambda r: (r(16384, 4096), r(4096, 1024) * 2 ** -5)),
]


@pytest.mark.chip
@pytest.mark.parametrize("name,make", CELL_PRODUCTS,
                         ids=[p[0] for p in CELL_PRODUCTS])
def test_kernel_matches_plain_and_f64_on_the_card(card, name, make):
    g = torch.Generator(device=card).manual_seed(17)
    a, b = make(lambda *s: torch.randn(*s, generator=g, device=card))
    exact = a.double() @ b.double()
    before = ck.gemm_tf32x3.launches
    got = ck.gemm_tf32x3(a, b)
    plain = ck.gemm_tf32x3_plain(a, b)
    torch.cuda.synchronize()
    assert ck.gemm_tf32x3.launches == before + 1
    err = (got.double() - exact).abs().max().item()
    plain_err = (plain.double() - exact).abs().max().item()
    # the kernel adds in 32-deep chains, the plain version as cuBLAS does:
    # within four times the plain version's error, as the fold is held
    assert err <= 4 * plain_err
    assert (got - plain).abs().max().item() <= 4 * plain_err


@pytest.mark.chip
@pytest.mark.parametrize("rmajor", [False, True], ids=["K-major", "R-major"])
def test_kernel_picks_one_hot_rows_exactly_on_the_card(card, rmajor):
    """The word2vec one-hot DAG's product on the kernel: each row of the
    result is the picked table row, bit for bit, with the one-hot read
    K-major or R-major."""
    g = torch.Generator(device=card).manual_seed(23)
    onehot, table, ids = one_hot_lookup(4096, 16384, 512, g, card)
    if rmajor:
        onehot = onehot.t().contiguous().t()
    assert ck.gemm_layout(onehot, table).p_rmajor is rmajor
    before = ck.gemm_tf32x3.launches
    got = ck.gemm_tf32x3(onehot, table)
    torch.cuda.synchronize()
    assert ck.gemm_tf32x3.launches == before + 1
    assert torch.equal(got, table[ids])


def _input_sets(traffic):
    """How many stored input sets a cell's traffic cycles through."""
    import json
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "perfbench"
            / "traffic" / f"{traffic}.json")
    return json.loads(path.read_text())["input_sets"]


def _ff_client(card, sets):
    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.models.ff import FFModel

    c = Client(device=card)
    m = FFModel(db="ffcard", block=(512, 512))
    m.setup(c)
    m.load_random_weights(c, features=1024, hidden=4096, labels=1024)
    sinks = []
    for i in range(sets):
        c.create_set("ffcard", f"in_{i}")
        c.create_set("ffcard", f"out_{i}")
        c.send_matrix("ffcard", f"in_{i}", torch.randn(16384, 1024,
                                                        device=card),
                      (512, 512))
        sinks.append(m.build_inference_dag(input_set=f"in_{i}",
                                           output_set=f"out_{i}"))
    return c, sinks


def _layer_client(card, sets):
    from netsdb_tpu_torch.client import Client
    from netsdb_tpu_torch.models.transformer import TransformerLayerModel

    c = Client(device=card)
    m = TransformerLayerModel(db="layercard", num_heads=16)
    m.setup(c)
    m.load_random_weights(c, embed=1024)
    sinks = []
    for i in range(sets):
        c.create_set("layercard", f"x_{i}")
        c.send_data("layercard", f"x_{i}",
                    [torch.randn(1, 16384, 1024, device=card)])
        sinks.append(m.build_forward_dag(c, input_set=f"x_{i}",
                                         output_set=f"y_{i}"))
    return c, sinks


@pytest.mark.chip
@pytest.mark.parametrize("model,per_request", [("ff", 2), ("layer", 4)])
def test_every_product_of_a_request_runs_the_kernel(card, model,
                                                    per_request):
    """Through the program cache (eager, capture, then graph replays) a
    request launches the kernel once a product, and leaves no float32
    product on cuBLAS. A capture's private pool, the kernel's scratch
    included, stays within its share of ``GRAPH_POOL_BUDGET_BYTES`` when
    the cell holds its sets: past it, the cell's cyclic order would
    capture on every request."""
    c, sinks = (_ff_client if model == "ff" else _layer_client)(card, 2)
    programs.reset_program_stats()
    t0, c0 = counts()
    before = ck.gemm_tf32x3.launches
    requests = 6
    for i in range(requests):
        c.execute_computations(sinks[i % 2], job_name=f"{model}card-{i % 2}")
    torch.cuda.synchronize()
    stats = programs.program_stats()
    assert stats["replays"] >= 2
    assert ck.gemm_tf32x3.launches - before == per_request * requests
    assert stats["captures"] >= 1
    assert stats["captured_launches"].get("gemm_tf32x3") == \
        per_request * stats["captures"]
    tf32x3, cublas = counts()
    assert cublas == c0 and tf32x3 > t0
    sets = _input_sets("closed.rows16k" if model == "ff"
                       else "closed.seq16k")
    share = programs.GRAPH_POOL_BUDGET_BYTES / sets
    assert stats["capture_bytes"] / stats["captures"] <= share
