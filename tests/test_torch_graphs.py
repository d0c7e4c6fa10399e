"""Port vs reference: graph containers, generators, reorderings and the
plan fingerprint are host arrays and must be exactly equal."""
import numpy as np
import pytest

from repro_torch.core import graph_fingerprint
from repro_torch.graphs import formats, generators, reorder

from test_torch_reference import load_reference

ref_gen = load_reference("graphs.generators")
ref_formats = load_reference("graphs.formats")
ref_reorder = load_reference("graphs.reorder")
ref_plan = load_reference("core.plan")

GENERATED = [
    ("rmat", (8, 8), dict(seed=1)),
    ("rmat", (9, 4), dict(seed=7, a=0.45, b=0.25, c=0.15)),
    ("rmat", (7, 16), dict(seed=2, dedup=True)),
    ("uniform_random", (300, 2000), dict(seed=5)),
    ("power_law", (400, 6), dict(seed=11)),
    ("power_law", (200, 3), dict(seed=0, exponent=2.6)),
    ("grid_2d", (9, 13), {}),
]


def _both(name, args, kw):
    return (getattr(generators, name)(*args, **kw),
            getattr(ref_gen, name)(*args, **kw))


def assert_same_graph(g, r):
    assert g.num_nodes == r.num_nodes
    np.testing.assert_array_equal(g.src, r.src)
    np.testing.assert_array_equal(g.dst, r.dst)
    assert g.src.dtype == r.src.dtype == np.int32


@pytest.mark.parametrize("name,args,kw", GENERATED)
def test_generators_same_edges(name, args, kw):
    g, r = _both(name, args, kw)
    assert_same_graph(g, r)
    for view in ("csr", "csc"):
        for a, b in zip(getattr(g, view), getattr(r, view)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g.out_degree, r.out_degree)
    np.testing.assert_array_equal(g.in_degree, r.in_degree)


@pytest.mark.parametrize("name,args,kw", GENERATED)
def test_fingerprint_bit_for_bit(name, args, kw):
    g, r = _both(name, args, kw)
    assert graph_fingerprint(g) == ref_plan.graph_fingerprint(r)


def test_fingerprint_order_independent_and_wraps():
    # large ids make the uint64 sum wrap; a shuffled edge list of the
    # same multiset hashes the same in both packages
    n = 2 ** 31 - 1
    rng = np.random.default_rng(3)
    src = rng.integers(n - 1000, n, 5000).astype(np.int32)
    dst = rng.integers(0, n, 5000).astype(np.int32)
    perm = rng.permutation(5000)
    g1 = formats.Graph(n, src, dst)
    g2 = formats.Graph(n, src[perm], dst[perm])
    r1 = ref_formats.Graph(n, src, dst)
    assert graph_fingerprint(g1) == graph_fingerprint(g2)
    assert graph_fingerprint(g1) == ref_plan.graph_fingerprint(r1)


@pytest.mark.parametrize("seed", [0, 4])
def test_relabel_matches(seed):
    g, r = _both("rmat", (8, 6), dict(seed=seed))
    perm = np.random.default_rng(seed).permutation(g.num_nodes)
    assert_same_graph(g.relabel(perm), r.relabel(perm))
    assert_same_graph(g.reverse(), r.reverse())


@pytest.mark.parametrize("ordering", ["degree", "bfs", "hybrid"])
@pytest.mark.parametrize("name,args,kw", [GENERATED[0], GENERATED[4],
                                          GENERATED[6]])
def test_reorder_permutations_equal(ordering, name, args, kw):
    g, r = _both(name, args, kw)
    perm = reorder.reorder_permutation(g, ordering)
    np.testing.assert_array_equal(
        perm, ref_reorder.reorder_permutation(r, ordering))
    np.testing.assert_array_equal(reorder.inverse_permutation(perm),
                                  ref_reorder.inverse_permutation(perm))
    assert reorder.available_orderings() == ref_reorder.available_orderings()


def test_from_edge_list_and_validation_errors():
    e = np.array([[0, 1], [2, 0]], dtype=np.int64)
    assert_same_graph(formats.from_edge_list(3, e),
                      ref_formats.from_edge_list(3, e))
    with pytest.raises(ValueError, match="integer-typed"):
        formats.from_edge_list(3, e.astype(np.float32))
    with pytest.raises(ValueError, match="int32"):
        formats.Graph(3, e[:, 0], e[:, 1])
    with pytest.raises(ValueError, match="outside"):
        formats.validate_graph(formats.from_edge_list(2, e))
    with pytest.raises(ValueError, match="unknown ordering"):
        reorder.reorder_permutation(formats.from_edge_list(3, e), "gorder")


def test_device_coo_is_int32_on_request():
    g = generators.rmat(6, 4, seed=0)
    src, dst = g.device_coo("cpu")
    assert src.dtype == dst.dtype and str(src.dtype) == "torch.int32"
    np.testing.assert_array_equal(src.numpy(), g.src)
    np.testing.assert_array_equal(dst.numpy(), g.dst)


@pytest.mark.parametrize("case", ["packed", "one value", "empty",
                                  "negative", "no room for positions",
                                  "wide"])
def test_lexsort_helpers_equal_numpy_lexsort(case):
    """``lexsort_order`` and ``lexsorted`` (the plan builders' sorts)
    give ``np.lexsort``'s order and values: with duplicate rows, on
    columns of one value, on no rows, and through the fallback for a
    negative value, for more than 63 bits of keys, and for rows that fit
    in 63 bits while their positions do not."""
    rng = np.random.default_rng(7)
    m = {"empty": 0}.get(case, 5000)
    cols = [rng.integers(0, 40, m).astype(np.int64),
            rng.integers(0, 300, m).astype(np.int32),
            rng.integers(0, 9, m).astype(np.int32)]
    if case == "one value":
        cols[0][:] = 0
    if case == "negative":
        cols[1][3] = -5
    if case == "no room for positions":
        cols[0] = rng.integers(0, 2 ** 45, m).astype(np.int64)
    if case == "wide":
        cols[0] = rng.integers(0, 2 ** 60, m).astype(np.int64)
    want = np.lexsort(cols[::-1])
    np.testing.assert_array_equal(formats.lexsort_order(*cols), want)
    for got, col in zip(formats.lexsorted(*cols), cols):
        assert got.dtype == col.dtype
        np.testing.assert_array_equal(got, col[want])
