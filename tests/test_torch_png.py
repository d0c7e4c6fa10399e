"""Port vs reference: the PNG build, the blocked gather schedule, the
blocked and packed kernel layouts and plans are host arrays and must be
exactly equal; a reference plan carried over with ``plan_from_arrays``
must run in the port like the port's own build."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.core import (Partitioning, PlanConfig, SpMVEngine,
                              block_png, build_gather_schedule, build_png,
                              build_plan, plan_from_arrays)
from repro_torch.core.plan import blocked_of, install_plan
from repro_torch.graphs import formats, generators
from repro_torch.kernels.pcpm_spmv import pack_blocked

from test_torch_reference import load_reference

ref_gen = load_reference("graphs.generators")
ref_formats = load_reference("graphs.formats")
ref_core = load_reference("core")
ref_ops = load_reference("kernels.pcpm_spmv.ops")

# paper fig. 3a (tests/test_core_pcpm.py PAPER_EDGES): 9 nodes, 3 per part
PAPER_EDGES = np.array([
    [6, 2], [7, 0], [7, 1], [7, 2],
    [3, 4], [6, 3], [6, 4], [6, 5],
    [2, 8], [7, 8],
], dtype=np.int32)

CASES = [
    ("paper", 3),
    ("rmat8", 64),
    ("rmat9", 100),
    ("grid", 16),
]


def _graphs(name):
    if name == "paper":
        return (formats.from_edge_list(9, PAPER_EDGES),
                ref_formats.from_edge_list(9, PAPER_EDGES))
    if name == "rmat8":
        return generators.rmat(8, 8, seed=1), ref_gen.rmat(8, 8, seed=1)
    if name == "rmat9":
        return generators.rmat(9, 4, seed=3), ref_gen.rmat(9, 4, seed=3)
    return generators.grid_2d(9, 13), ref_gen.grid_2d(9, 13)


def _assert_fields_equal(a, b, names):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=name)
            assert x.dtype == y.dtype, name
        else:
            assert x == y, name


PNG_FIELDS = ("update_src", "update_offsets", "edge_update_idx", "edge_dst",
              "edge_offsets", "num_nodes", "num_edges", "num_updates",
              "num_partitions", "compression_ratio")


@pytest.mark.parametrize("name,part_size", CASES)
def test_build_png_equal(name, part_size):
    g, r = _graphs(name)
    png = build_png(g, Partitioning(g.num_nodes, part_size))
    ref = ref_core.build_png(r, ref_core.Partitioning(r.num_nodes, part_size))
    _assert_fields_equal(png, ref, PNG_FIELDS)
    assert png.model_bytes() == ref.model_bytes()
    if name == "paper":
        assert png.num_updates == 6        # paper fig. 5


@pytest.mark.parametrize("block", [4, 16, 256])
@pytest.mark.parametrize("name,part_size", CASES)
def test_gather_schedule_equal(name, part_size, block):
    g, r = _graphs(name)
    png = build_png(g, Partitioning(g.num_nodes, part_size))
    ref = ref_core.build_png(r, ref_core.Partitioning(r.num_nodes, part_size))
    _assert_fields_equal(
        build_gather_schedule(png, block=block),
        ref_core.build_gather_schedule(ref, block=block),
        ("block", "num_edges", "edge_update_idx_padded", "piece_start",
         "piece_end", "piece_dst", "num_blocks"))


@pytest.mark.parametrize("edge_block", [128, 512])
@pytest.mark.parametrize("name,part_size", CASES)
def test_blocked_and_packed_equal(name, part_size, edge_block):
    g, r = _graphs(name)
    blk = block_png(build_png(g, Partitioning(g.num_nodes, part_size)))
    ref = ref_core.block_png(ref_core.build_png(
        r, ref_core.Partitioning(r.num_nodes, part_size)))
    _assert_fields_equal(blk, ref, ("part_size", "update_src",
                                    "edge_update_local", "edge_dst_local",
                                    "update_pad_frac", "edge_pad_frac"))
    packed = pack_blocked(blk, g.num_nodes, edge_block=edge_block,
                          device="cpu")
    ref_packed = ref_ops.pack_blocked(ref, r.num_nodes,
                                      edge_block=edge_block, lane=1)
    assert packed.part_size == ref_packed.part_size
    assert packed.num_nodes == ref_packed.num_nodes
    for field in ("update_src", "update_valid", "edge_upd", "edge_dst"):
        np.testing.assert_array_equal(
            getattr(packed, field).numpy(),
            np.asarray(getattr(ref_packed, field)), err_msg=field)


PLAN_ARRAYS = ("csc_src", "csc_dst", "bv_src", "bv_dst", "reorder_perm")


@pytest.mark.parametrize("reorder", ["none", "hybrid"])
@pytest.mark.parametrize("method", ["pdpr", "bvgas", "pcpm", "pcpm_pallas"])
def test_plan_from_reference_arrays(method, reorder, tmp_path):
    g, r = generators.rmat(9, 6, seed=5), ref_gen.rmat(9, 6, seed=5)
    ref_plan = ref_core.build_plan(r, ref_core.PlanConfig(
        method=method, part_size=128, reorder=reorder))
    path = tmp_path / "ref.plan.npz"
    ref_plan.save(str(path))
    with np.load(path, allow_pickle=False) as z:
        fields = json.loads(str(z["__meta__"]))
        carried = plan_from_arrays(fields, {k: z[k] for k in z.files})
    own = build_plan(g, PlanConfig(method=method, part_size=128,
                                   reorder=reorder))
    assert carried.config == own.config
    assert carried.graph_fp == own.graph_fp
    for name in PLAN_ARRAYS:
        a, b = getattr(carried, name), getattr(own, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name, fields_ in (("png", PNG_FIELDS),
                          ("schedule", ("edge_update_idx_padded",
                                        "piece_start", "piece_end",
                                        "piece_dst", "block")),
                          ("blocked", ("update_src", "edge_update_local",
                                       "edge_dst_local"))):
        # a port plan holds no blocked form: ``blocked_of`` derives it
        a, b = ((blocked_of(carried), blocked_of(own)) if name == "blocked"
                else (getattr(carried, name), getattr(own, name)))
        assert (a is None) == (b is None), name
        if a is not None:
            _assert_fields_equal(a, b, fields_)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (g.num_nodes, 3)).astype(np.float32))
    y_carried = SpMVEngine(g, plan=carried, device="cpu")(x)
    y_own = SpMVEngine(g, plan=own, device="cpu")(x)
    torch.testing.assert_close(y_carried, y_own, rtol=0, atol=0)
    # a carried plan seeds the cache for the port's front doors
    installed = install_plan(g, carried)
    assert build_plan(g, own.config) is installed


def test_plan_from_arrays_rejects_missing_and_sharded():
    g = generators.rmat(6, 4, seed=0)
    plan = build_plan(g, PlanConfig(method="pdpr", part_size=16))
    fields = {"config": dataclasses.asdict(plan.config),
              "num_nodes": plan.num_nodes, "num_edges": plan.num_edges}
    with pytest.raises(ValueError, match="needs"):
        plan_from_arrays(fields, {})
    # sharded plans carry over too (the shd/* arrays of the JAX
    # package's plan file), and one without its layout is refused
    from repro_torch.core.distributed import build_sharded_png
    ref_dist = load_reference("core.distributed")
    sharded = {**fields, "config": {**fields["config"],
                                    "method": "pcpm_sharded",
                                    "num_shards": 2}}
    with pytest.raises(ValueError, match="needs"):
        plan_from_arrays(sharded, {})
    lay = build_sharded_png(g, 2)
    names = ("send_ids", "edge_upd", "edge_dst", "eui_padded",
             "piece_start", "piece_end", "piece_dst")
    sharded["sharded"] = {k: getattr(lay, k) for k in (
        "num_shards", "shard_size", "num_nodes", "gather_block",
        "wire_updates", "wire_edges")}
    carried = plan_from_arrays(sharded, {
        f"shd/{k}": getattr(ref_dist.build_sharded_png(
            ref_gen.rmat(6, 4, seed=0), 2), k) for k in names})
    for k in names:
        assert np.array_equal(getattr(carried.sharded, k), getattr(lay, k))
    # two shards at world size 1: the reference's device-count rule
    with pytest.raises(ValueError, match="available devices"):
        SpMVEngine(g, plan=carried, device="cpu")
