"""Port vs reference: the main path's leftovers (plan and graph files,
the plan cache's memory hooks, the paper's byte models, the partition
heuristic, the kron config, ``EngineConfig``'s serving fields) and the
front door's float64 input (ROADMAP Queue C1), on the CPU.

A plan or graph saved by either package loads in the other with equal
arrays; everything else equals the reference's value for the same
inputs."""
import dataclasses

import numpy as np
import pytest

import repro_torch
from repro_torch import EngineConfig
from repro_torch.configs import pagerank_kron
from repro_torch.core import comm_model, partition_for_vmem
from repro_torch.core import plan as plan_mod
from repro_torch.device import as_device_tensor
from repro_torch.graphs import generators, io as graph_io

from test_torch_reference import load_reference

ref_gen = load_reference("graphs.generators")
ref_plan = load_reference("core.plan")
ref_io = load_reference("graphs.io")
ref_api = load_reference("api")

METHODS = ["pdpr", "bvgas", "pcpm", "pcpm_pallas"]
PART = 32

ARRAYS = {
    None: ("csc_src", "csc_dst", "bv_src", "bv_dst", "reorder_perm"),
    "png": ("update_src", "update_offsets", "edge_update_idx", "edge_dst",
            "edge_offsets"),
    "schedule": ("edge_update_idx_padded", "piece_start", "piece_end",
                 "piece_dst"),
    "blocked": ("update_src", "edge_update_local", "edge_dst_local"),
}


@pytest.fixture(scope="module")
def graphs():
    return generators.rmat(7, 8, seed=9), ref_gen.rmat(7, 8, seed=9)


def assert_same_plan(a, b):
    """Every array and scalar of two plans (of either package) equal."""
    assert (a.num_nodes, a.num_edges) == (b.num_nodes, b.num_edges)
    assert (a.method, a.part_size, a.config.gather_block,
            a.config.reorder) == (b.method, b.part_size,
                                  b.config.gather_block, b.config.reorder)
    assert (a.graph_fp, a.parent_fp) == (b.graph_fp, b.parent_fp)
    for part, names in ARRAYS.items():
        # a port plan holds no blocked form: ``blocked_of`` derives it
        pa, pb = ((a, b) if part is None
                  else (plan_mod.blocked_of(a), plan_mod.blocked_of(b))
                  if part == "blocked"
                  else (getattr(a, part), getattr(b, part)))
        assert (pa is None) == (pb is None), part
        if pa is None:
            continue
        for name in names:
            xa, xb = getattr(pa, name), getattr(pb, name)
            assert (xa is None) == (xb is None), name
            if xa is not None:
                assert np.array_equal(xa, xb), f"{part}.{name}"
                assert np.asarray(xa).dtype == np.asarray(xb).dtype, name
    if a.schedule is not None:
        assert (a.schedule.block, a.schedule.num_edges) == (
            b.schedule.block, b.schedule.num_edges)
    ba, bb = plan_mod.blocked_of(a), plan_mod.blocked_of(b)
    if ba is not None:
        assert (ba.part_size, ba.update_pad_frac, ba.edge_pad_frac) == (
            bb.part_size, bb.update_pad_frac, bb.edge_pad_frac)


@pytest.mark.parametrize("reorder", ["none", "degree"])
@pytest.mark.parametrize("method", METHODS)
def test_plans_cross_load_both_ways(graphs, method, reorder, tmp_path):
    g, r = graphs
    mine = plan_mod.build_plan(g, plan_mod.PlanConfig(
        method=method, part_size=PART, reorder=reorder))
    theirs = ref_plan.build_plan(r, ref_plan.PlanConfig(
        method=method, part_size=PART, reorder=reorder))
    assert_same_plan(mine, theirs)
    # reference -> port
    theirs.save(str(tmp_path / "ref.npz"))
    loaded = plan_mod.GraphPlan.load(str(tmp_path / "ref.npz"))
    assert_same_plan(loaded, theirs)
    # port -> reference
    mine.save(str(tmp_path / "port.npz"))
    ref_loaded = ref_plan.GraphPlan.load(str(tmp_path / "port.npz"))
    assert_same_plan(ref_loaded, mine)
    assert ref_loaded.config == theirs.config
    # and the on-disk sizes agree, as read off the zip members
    assert graph_io.nbytes(str(tmp_path / "port.npz")) == ref_io.nbytes(
        str(tmp_path / "ref.npz"))


@pytest.mark.parametrize("method", ["pcpm", "pcpm_pallas"])
def test_reference_plan_file_serves_in_the_port(graphs, method, tmp_path):
    """One preprocessing artifact, both packages: the reference's plan
    file installed in the port gives the reference's ranks."""
    g = generators.rmat(7, 6, seed=17)        # fresh to this test
    r = ref_gen.rmat(7, 6, seed=17)
    path = str(tmp_path / "plan.npz")
    ref_plan.build_plan(r, ref_plan.PlanConfig(method=method,
                                               part_size=PART)).save(path)
    builds = plan_mod.plan_cache_stats().plan_builds
    plan = plan_mod.install_plan(g, graph_io.load_plan(path))
    sess = repro_torch.open(g, method=method, part_size=PART, device="cpu")
    assert sess.plan is plan
    assert plan_mod.plan_cache_stats().plan_builds == builds
    ref = ref_api.open(r, method=method, part_size=PART).pagerank()
    assert np.abs(sess.pagerank().ranks.numpy()
                  - np.asarray(ref.ranks)).max() <= 1e-6


def test_graphs_cross_load_both_ways(graphs, tmp_path):
    g, r = graphs
    graph_io.save(str(tmp_path / "port.npz"), g)
    ref_io.save(str(tmp_path / "ref.npz"), r)
    for mine, theirs in ((graph_io.load(str(tmp_path / "ref.npz")), r),
                         (ref_io.load(str(tmp_path / "port.npz")), g)):
        assert mine.num_nodes == theirs.num_nodes
        assert np.array_equal(mine.src, theirs.src)
        assert np.array_equal(mine.dst, theirs.dst)
        assert mine.src.dtype == theirs.src.dtype == np.int32
    assert graph_io.nbytes(str(tmp_path / "port.npz")) == ref_io.nbytes(
        str(tmp_path / "port.npz"))


def test_plan_file_errors(graphs, tmp_path):
    g, _ = graphs
    graph_io.save(str(tmp_path / "graph.npz"), g)
    with pytest.raises(ValueError, match="not a GraphPlan"):
        plan_mod.GraphPlan.load(str(tmp_path / "graph.npz"))
    # the observability slice is in: an observer hears the plan events
    seen = []

    class Observer:
        def plan_event(self, name, **attrs):
            seen.append(name)

    obs = Observer()
    plan_mod.add_plan_observer(obs)
    try:
        plan_mod.build_plan(g, plan_mod.PlanConfig(method="pcpm",
                                                   part_size=PART))
    finally:
        plan_mod.remove_plan_observer(obs)
    assert seen and set(seen) <= {"png_build", "plan_build",
                                  "plan_cache_hit"}


@pytest.mark.parametrize("method", METHODS)
def test_plan_nbytes_matches_reference(graphs, method):
    g, r = graphs
    mine = plan_mod.build_plan(g, plan_mod.PlanConfig(method=method,
                                                      part_size=PART))
    theirs = ref_plan.build_plan(r, ref_plan.PlanConfig(method=method,
                                                        part_size=PART))
    assert plan_mod.plan_nbytes(mine) == ref_plan.plan_nbytes(theirs) > 0


def test_evict_and_peek_match_reference():
    counts = []
    for plan, gen in ((plan_mod, generators), (ref_plan, ref_gen)):
        g = gen.rmat(8, 4, seed=23)             # fresh to this test
        fp = plan.graph_fingerprint(g)
        for method in METHODS:
            plan.build_plan(g, plan.PlanConfig(method=method,
                                               part_size=PART))
        cfg = plan.PlanConfig(method="pcpm", part_size=PART)
        hits = plan.plan_cache_stats().plan_hits
        assert plan.peek_plan(fp, cfg) is plan.build_plan(g, cfg)
        assert plan.peek_shared_png(fp, PART) is not None
        assert plan.plan_cache_stats().plan_hits == hits + 2
        assert plan.peek_plan("no such graph", cfg) is None
        counts.append((plan.evict_plans(g), plan.evict_plans(g),
                       plan.peek_plan(fp, cfg)))
    assert counts[0] == counts[1] == (5, 0, None)  # 4 plans + 1 shared PNG


def test_evict_follows_patch_chains():
    """A plan patched from another (``parent_fp``) is evicted with it."""
    g0 = generators.rmat(7, 4, seed=31)
    g1 = generators.rmat(7, 4, seed=32)
    cfg = plan_mod.PlanConfig(method="pcpm", part_size=PART)
    p0 = plan_mod.build_plan(g0, cfg)
    p1 = plan_mod.build_plan(g1, cfg)
    fp0 = plan_mod.graph_fingerprint(g0)
    fp1 = plan_mod.graph_fingerprint(g1)
    # stand-in for a streaming patch: g1's plan names g0's as its parent
    plan_mod.install_plan(g1, dataclasses.replace(p1, parent_fp=fp0))
    assert plan_mod._chain_fingerprints(fp1) == {fp0, fp1}
    assert plan_mod.evict_plans(g1, chain=False) == 2   # g1: plan + PNG
    # install_plan seeds g1's PNG again beside its plan
    plan_mod.install_plan(g1, dataclasses.replace(p1, parent_fp=fp0))
    assert plan_mod.evict_plans(g1) == 4      # both plans and PNGs
    assert plan_mod.peek_plan(fp0, cfg) is None and p0.png is not None


def test_comm_model_matches_reference():
    ref = load_reference("core.comm_model")
    for n, m, k, r, c_mr in ((2 ** 21, 65_011_712, 32, 5.619, 1.0),
                             (1000, 31_000, 4, 1.7, 4 / 64),
                             (2 ** 25, 2 ** 25 * 31, 512, 3.3, 0.5)):
        mine = comm_model.ModelParams(n, m, k, r, c_mr=c_mr)
        theirs = ref.ModelParams(n, m, k, r, c_mr=c_mr)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        for name in ("pdpr_bytes", "bvgas_bytes", "pcpm_bytes",
                     "bvgas_wins_over_pdpr", "pcpm_wins_over_pdpr",
                     "random_accesses"):
            assert getattr(comm_model, name)(mine) == getattr(ref, name)(
                theirs), name


def test_pcpm_model_equals_the_layouts_byte_count(graphs):
    """eq. (5) at this layout's n, m, k and r is the PNG's own count."""
    g, _ = graphs
    png = plan_mod.build_plan(g, plan_mod.PlanConfig(
        method="pcpm", part_size=PART)).png
    p = comm_model.ModelParams(png.num_nodes, png.num_edges,
                               png.num_partitions, png.compression_ratio)
    assert round(comm_model.pcpm_bytes(p)) == png.model_bytes()["total"]


@pytest.mark.parametrize("num_nodes", [1, 255, 256, 1000, 2 ** 20 + 1,
                                       2 ** 25])
@pytest.mark.parametrize("budget", [2 ** 10, 256 * 1024, 8 * 2 ** 20,
                                    3 * 2 ** 20 + 7])
def test_partition_for_vmem_matches_reference(num_nodes, budget):
    ref = load_reference("core.partition").partition_for_vmem(
        num_nodes, vmem_budget_bytes=budget)
    mine = partition_for_vmem(num_nodes, vmem_budget_bytes=budget)
    assert (mine.num_nodes, mine.part_size, mine.num_partitions) == (
        ref.num_nodes, ref.part_size, ref.num_partitions)


def test_kron_config_matches_reference():
    ref = load_reference("configs.pagerank_kron")
    assert dataclasses.asdict(pagerank_kron.CONFIG) == dataclasses.asdict(
        ref.CONFIG)
    assert dataclasses.asdict(pagerank_kron.CONFIG.scaled(
        scale=21, edge_factor=31, part_size=65536)) == dataclasses.asdict(
        ref.CONFIG.scaled(scale=21, edge_factor=31, part_size=65536))


def test_engine_config_has_the_reference_fields(graphs):
    g, _ = graphs
    mine = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(ref_api.EngineConfig)}
    assert mine == theirs
    sess = repro_torch.open(g, method="pcpm", part_size=PART, slots=6,
                            chunk=3, num_shards=1, device="cpu")
    assert (sess.config.slots, sess.config.chunk) == (6, 3)
    with pytest.raises(ValueError, match="two_phase"):
        repro_torch.open(g, method="pcpm", two_phase=True, device="cpu")
    # num_shards as the reference takes it: ignored by a backend that
    # cannot shard, bounded by the devices (world size 1 here) for one
    # that can
    assert repro_torch.open(g, method="pcpm", num_shards=2,
                            device="cpu").plan.num_shards is None
    with pytest.raises(ValueError, match="available devices"):
        repro_torch.open(g, method="pcpm_sharded", num_shards=2,
                         device="cpu")
    with pytest.raises(ValueError, match="available devices"):
        ref_api.open(ref_gen.rmat(7, 8, seed=9), method="pcpm_sharded",
                     num_shards=2)
    observed = repro_torch.open(g, method="pcpm", observe=True,
                                device="cpu")
    assert observed.obs is not None
    observed.obs.close()


# ------------------------------------------------ Queue C1: float64 input
@pytest.mark.parametrize("method", METHODS)
def test_spmv_takes_float64_as_the_reference_does(method):
    """numpy's default float64 goes in as float32 (``jnp.asarray`` with
    x64 off): float32 out for every method, equal to the same input
    given as float32, and the reference's values.

    The values are held to 1e-6 absolute on float64 inputs that are
    multiples of 1/64, whose sums are exact in any order. On
    ``rng.random(n)`` both packages' blocked gathers round their
    block-local prefix sums in their own order (outputs up to ~70 here,
    gaps of a few float32 ulps), so there the bound is 1e-6 of the
    largest output. A third reading backs that limit: each package is
    held to 1e-6 of the largest output from the float64 product of the
    same float32 input, and the port to no more than twice the
    reference's gap. ``pytest -s -k float64`` prints the three gaps."""
    from test_torch_reference import dense_spmv
    g, r = generators.rmat(8, 4, seed=0), ref_gen.rmat(8, 4, seed=0)
    sess = repro_torch.open(g, method=method, part_size=64, device="cpu")
    ref_sess = ref_api.open(r, method=method, part_size=64)
    rng = np.random.default_rng(0)
    x = rng.random(g.num_nodes)
    exact = rng.integers(0, 64, g.num_nodes) / 64
    for inp in (x, exact):
        assert inp.dtype == np.float64
        ref = np.asarray(ref_sess.spmv(inp))
        assert ref.dtype == np.float32
        for y in (sess.spmv(inp), sess.engine(inp),
                  sess.spmv(inp.tolist())):
            assert y.dtype == repro_torch.core.spmv.torch.float32
            assert np.array_equal(
                y.numpy(), sess.spmv(inp.astype(np.float32)).numpy())
            gap = np.abs(y.numpy() - ref).max()
            if inp is exact:
                assert gap <= 1e-6
            else:
                scale = np.abs(ref).max()
                want = dense_spmv(g.num_nodes, g.src, g.dst,
                                  inp.astype(np.float32))
                port_gap = np.abs(y.numpy() - want).max()
                ref_gap = np.abs(ref - want).max()
                print(f"C1 {method}: max |y| {float(scale)!r}; port vs reference "
                      f"{float(gap)!r}; vs the float64 product: port "
                      f"{float(port_gap)!r}, "
                      f"reference {float(ref_gap)!r}")
                assert gap <= 1e-6 * scale
                assert max(port_gap, ref_gap) <= 1e-6 * scale
                assert port_gap <= 2 * ref_gap


def test_as_device_tensor_narrows_like_jnp_asarray():
    import jax.numpy as jnp
    import torch
    for x in (np.arange(5), np.arange(5.0), [1, 2], [1.5, 2.0],
              np.arange(3, dtype=np.float32), np.array([True]),
              np.arange(4, dtype=np.int16), torch.arange(3.0).double(),
              torch.arange(3)):
        t = as_device_tensor(x, "cpu")
        want = jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
        assert str(t.dtype).split(".")[1] == str(want.dtype), x
        assert np.array_equal(t.numpy(), np.asarray(want))
