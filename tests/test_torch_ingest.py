"""Port vs reference: real-graph ingest on the CPU.

Every case of the JAX package's ``tests/test_ingest.py`` runs here on the
port and on the reference, on ``tests/fixtures/web_sample.txt`` and the
same small inputs: the streaming parser (chunks, gzip sniffed from the
magic bytes, comments, delimiters, string ids, errors naming the line),
``NodeIdMapping`` (first-seen dense ids, missing modes, ``.npz`` files
that load in either package), the pipeline (link filters, self-loop and
dedup policies, virtual links and their rank mass), the end-to-end path
to ``Session.pagerank``/``top_ranked``/``serve`` in the file's own ids on
plans reordered or not, and the reorder wiring of plans. Parsed chunks,
``IngestStats``, id maps, the graph's arrays and the virtual mass are
exactly equal to the reference's; ranks within 1e-6.
"""
import dataclasses
import gzip
import io
import json
from pathlib import Path

import numpy as np
import pytest

import repro_torch
from repro_torch.core import pagerank_reference
from repro_torch.core.plan import build_plan, install_plan, plan_cache_stats
from repro_torch.graphs import generators
from repro_torch.graphs.io import load_plan
from repro_torch.ingest import (LinkFilter, NodeIdMapping, ingest_edge_list,
                                iter_edge_chunks, read_edge_list)
from repro_torch.ingest import pipeline as pipeline_mod

from test_torch_reference import load_reference

ref_ingest = load_reference("ingest")
ref_core = load_reference("core")
ref_gen = load_reference("graphs.generators")
ref_api = load_reference("api")

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "web_sample.txt"
OFFSITE = LinkFilter("offsite", lambda s, d: d < 900_000_000)
REF_OFFSITE = ref_ingest.LinkFilter("offsite", lambda s, d: d < 900_000_000)
CPU = dict(device="cpu")


def oracle_top(ref, k):
    """Top-k internal ids of a rank vector, score desc then id asc — the
    tie-break ``Session.top_ranked`` uses."""
    part = np.argpartition(-ref, k - 1)[:k]
    return part[np.lexsort((part, -ref[part]))]


def both(fn, *args, **kw):
    """``fn(*args, **kw)`` in the port and in the reference: the name is
    looked up in ``repro_torch.ingest`` and in the reference's
    ``ingest``; sources are handed over fresh (a stream is read once)."""
    fresh = [a() if callable(a) and not isinstance(a, LinkFilter) else a
             for a in args]
    again = [a() if callable(a) and not isinstance(a, LinkFilter) else a
             for a in args]
    return (getattr(repro_torch.ingest, fn)(*fresh, **kw),
            getattr(ref_ingest, fn)(*again, **kw))


def assert_same_result(res, ref):
    """An ``IngestResult`` of each package: every field equal."""
    assert dataclasses.asdict(res.stats) == dataclasses.asdict(ref.stats)
    assert res.graph.num_nodes == ref.graph.num_nodes
    for f in ("src", "dst"):
        a, b = getattr(res.graph, f), getattr(ref.graph, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    a, b = res.idmap.external_ids, ref.idmap.external_ids
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert res.virtual.counts == ref.virtual.counts
    for cat in ref.virtual.categories:
        for x, y in zip(res.virtual.edges(cat), ref.virtual.edges(cat)):
            assert np.array_equal(x, y)


def fixture_ingest():
    return (ingest_edge_list(FIXTURE, filters=[OFFSITE], self_loops="drop",
                             dedup=True),
            ref_ingest.ingest_edge_list(FIXTURE, filters=[REF_OFFSITE],
                                        self_loops="drop", dedup=True))


# -------------------------------------------------------------- parser
class TestParse:
    def test_fixture_streams_in_chunks(self):
        (s, d), (rs, rd) = both("read_edge_list", FIXTURE)
        assert s.dtype == rs.dtype == np.int64 and s.size == 295
        assert np.array_equal(s, rs) and np.array_equal(d, rd)
        assert d.max() >= 900_000_000          # offsite edges present
        chunks = list(iter_edge_chunks(FIXTURE, chunk_edges=37))
        ref_chunks = list(ref_ingest.iter_edge_chunks(FIXTURE,
                                                      chunk_edges=37))
        sizes = [a.size for a, _ in chunks]
        assert max(sizes) == 37 and len(sizes) > 1
        assert sizes == [a.size for a, _ in ref_chunks]
        np.testing.assert_array_equal(np.concatenate([a for a, _ in chunks]),
                                      s)
        np.testing.assert_array_equal(np.concatenate([b for _, b in chunks]),
                                      d)

    def test_gzip_sniffed_from_magic_bytes(self):
        raw = FIXTURE.read_bytes()
        s, d = read_edge_list(FIXTURE)
        # no .gz extension anywhere: detection is content-based
        (gs, gd), (rs, rd) = both(
            "read_edge_list", lambda: io.BytesIO(gzip.compress(raw)))
        for a in (gs, rs):
            np.testing.assert_array_equal(a, s)
        for b in (gd, rd):
            np.testing.assert_array_equal(b, d)

    def test_gzip_file_on_disk(self, tmp_path):
        path = tmp_path / "edges.bin"
        path.write_bytes(gzip.compress(FIXTURE.read_bytes()))
        (s, d), (rs, rd) = both("read_edge_list", str(path))
        assert np.array_equal(s, rs) and np.array_equal(d, rd)
        assert s.size == 295

    def test_comments_blanks_and_extra_columns(self):
        text = "# c\n% c\n\n1 2 0.5 2020\n2 3\n"
        (s, d), (rs, rd) = both("read_edge_list", lambda: io.StringIO(text))
        assert s.tolist() == rs.tolist() == [1, 2]
        assert d.tolist() == rd.tolist() == [2, 3]
        (s, _), _ = both("read_edge_list", lambda: io.StringIO("; x\n1 2\n"),
                         comments=(";",))
        assert s.tolist() == [1]

    def test_explicit_delimiter(self):
        (s, d), (rs, rd) = both("read_edge_list",
                                lambda: io.StringIO("1,2\n3,,4\n"),
                                delimiter=",")
        assert s.tolist() == rs.tolist() == [1, 3]
        assert d.tolist() == rd.tolist() == [2, 4]

    def test_string_ids(self):
        (s, d), (rs, rd) = both("read_edge_list",
                                lambda: io.StringIO("a b\nb c\n"))
        assert s.dtype.kind == "U" and s.tolist() == ["a", "b"]
        assert s.dtype == rs.dtype and np.array_equal(d, rd)

    def test_short_line_names_line_number(self):
        for mod in (repro_torch.ingest, ref_ingest):
            with pytest.raises(mod.ParseError, match="line 3"):
                mod.read_edge_list(io.StringIO("# c\n1 2\noops\n"))

    def test_mixed_dtype_names_culprit(self):
        for mod in (repro_torch.ingest, ref_ingest):
            with pytest.raises(mod.ParseError,
                               match="line 2: non-numeric id 'x'"):
                mod.read_edge_list(io.StringIO("1 2\nx 4\n"))

    def test_chunk_edges_validated(self):
        for mod in (repro_torch.ingest, ref_ingest):
            with pytest.raises(ValueError, match="chunk_edges"):
                list(mod.iter_edge_chunks(io.StringIO("1 2\n"),
                                          chunk_edges=0))

    def test_empty_file(self):
        (s, d), (rs, _) = both("read_edge_list", lambda: io.StringIO("# c\n"))
        assert s.size == d.size == rs.size == 0 and s.dtype == rs.dtype


# --------------------------------------------------------------- idmap
class TestIdMap:
    def test_first_seen_dense_assignment(self):
        for cls in (NodeIdMapping, ref_ingest.NodeIdMapping):
            m = cls()
            out = m.map_chunk(np.array([50, 7, 50, 99]))
            assert out.tolist() == [0, 1, 0, 2] and out.dtype == np.int32
            assert m.num_nodes == len(m) == 3 and 7 in m and 8 not in m
            assert m.external_ids.tolist() == [50, 7, 99]
            np.testing.assert_array_equal(m.to_external([2, 0]), [99, 50])

    def test_to_internal_missing_modes(self):
        for cls in (NodeIdMapping, ref_ingest.NodeIdMapping):
            m = cls()
            m.map_chunk(np.array([5, 6]))
            assert m.to_internal(np.array([6, 5])).tolist() == [1, 0]
            assert m.to_internal(np.array([6, 123]),
                                 missing="mark").tolist() == [1, -1]
            assert m.to_internal(np.int64(6)) == 1
            with pytest.raises(KeyError, match="123"):
                m.to_internal(np.array([123]))
            with pytest.raises(ValueError, match="missing"):
                m.to_internal(np.array([5]), missing="bogus")

    @pytest.mark.parametrize("ids", [[10**12, 5, 7], ["a.com", "b.org"]])
    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_persistence_round_trip(self, ids, writer, tmp_path):
        """A mapping saved by either package loads in both, equal."""
        m = (NodeIdMapping if writer == "port"
             else ref_ingest.NodeIdMapping)()
        m.map_chunk(np.array(ids))
        p = str(tmp_path / "idmap.npz")
        m.save(p)
        for cls in (NodeIdMapping, ref_ingest.NodeIdMapping):
            m2 = cls.load(p)
            np.testing.assert_array_equal(m2.external_ids, m.external_ids)
            assert m2.external_ids.dtype == m.external_ids.dtype
            assert m2.to_internal(m.external_ids).tolist() == \
                list(range(len(ids)))

    def test_load_rejects_foreign_npz(self, tmp_path):
        p = str(tmp_path / "not_idmap.npz")
        np.savez(p, foo=np.arange(3))
        for cls in (NodeIdMapping, ref_ingest.NodeIdMapping):
            with pytest.raises(ValueError, match="not a NodeIdMapping"):
                cls.load(p)

    def test_load_rejects_corrupt_and_unknown_versions(self, tmp_path):
        dup = str(tmp_path / "dup.npz")
        np.savez(dup, __meta__=json.dumps({"version": 1, "num_nodes": 3}),
                 external=np.array([1, 2, 2]))
        v2 = str(tmp_path / "v2.npz")
        np.savez(v2, __meta__=json.dumps({"version": 2, "num_nodes": 1}),
                 external=np.array([1]))
        for cls in (NodeIdMapping, ref_ingest.NodeIdMapping):
            with pytest.raises(ValueError, match="corrupt"):
                cls.load(dup)
            with pytest.raises(ValueError, match="version"):
                cls.load(v2)

    def test_identity(self):
        m = NodeIdMapping.identity(4)
        assert m.to_internal(np.array([3, 0])).tolist() == [3, 0]
        assert np.array_equal(m.external_ids,
                              ref_ingest.NodeIdMapping.identity(4)
                              .external_ids)


# ------------------------------------------------------------ pipeline
class TestPipeline:
    def test_fixture_accounting_balances(self):
        res, ref = fixture_ingest()
        assert_same_result(res, ref)
        st = res.stats
        assert st.edges_read == 295
        assert st.edges_kept == (st.edges_read - st.filtered["offsite"]
                                 - st.self_loops_removed
                                 - st.duplicates_removed)
        assert st.num_nodes == res.graph.num_nodes == res.idmap.num_nodes
        assert res.virtual.counts == {"offsite": st.filtered["offsite"]}
        # filtering BEFORE id mapping: offsite dsts never claim an id
        assert res.idmap.external_ids.max() < 900_000_000
        assert st.summary() == ref.stats.summary()

    @pytest.mark.parametrize("chunk_edges", [1, 37, 1 << 16])
    def test_chunking_changes_nothing(self, chunk_edges):
        res = ingest_edge_list(FIXTURE, filters=[OFFSITE], self_loops="drop",
                               dedup=True, chunk_edges=chunk_edges)
        ref = ref_ingest.ingest_edge_list(
            FIXTURE, filters=[REF_OFFSITE], self_loops="drop", dedup=True,
            chunk_edges=chunk_edges)
        assert_same_result(res, ref)

    def test_self_loop_policies(self):
        text = "1 1\n1 2\n2 1\n"
        for policy, kept in (("keep", 3), ("drop", 2), ("virtual", 2)):
            res, ref = both("ingest_edge_list", lambda: io.StringIO(text),
                            self_loops=policy)
            assert_same_result(res, ref)
            assert res.stats.edges_kept == kept
        assert res.virtual.counts == {"self_loops": 1}
        assert res.stats.self_loops_removed == 1
        for mod in (repro_torch.ingest, ref_ingest):
            with pytest.raises(ValueError, match="self_loops"):
                mod.ingest_edge_list(io.StringIO(text), self_loops="nuke")

    def test_dedup_counts(self):
        res, ref = both("ingest_edge_list",
                        lambda: io.StringIO("1 2\n1 2\n2 1\n"), dedup=True)
        assert_same_result(res, ref)
        assert res.stats.duplicates_removed == 1
        assert res.stats.edges_kept == 2
        s = np.array([3, 1, 3, 0], np.int32)
        d = np.array([1, 2, 1, 5], np.int32)
        out = pipeline_mod.dedup_edges(s, d)
        assert [a.tolist() for a in out[:2]] == [[0, 1, 3], [5, 2, 1]]
        assert out[2] == 1
        # nothing removed: the edges as given, in their order
        a, b = s[:2], d[:2]
        assert pipeline_mod.dedup_edges(a, b) == (a, b, 0)

    def test_non_virtual_filter_only_counts(self):
        f = LinkFilter("spam", lambda s, d: s != 9, virtual=False)
        rf = ref_ingest.LinkFilter("spam", lambda s, d: s != 9,
                                   virtual=False)
        res = ingest_edge_list(io.StringIO("1 2\n9 2\n2 1\n"), filters=[f])
        ref = ref_ingest.ingest_edge_list(io.StringIO("1 2\n9 2\n2 1\n"),
                                          filters=[rf])
        assert_same_result(res, ref)
        assert res.stats.filtered["spam"] == 1
        assert res.virtual.counts == {}

    def test_duplicate_filter_names_rejected(self):
        f = LinkFilter("x", lambda s, d: s == s)
        with pytest.raises(ValueError, match="duplicate filter"):
            ingest_edge_list(io.StringIO("1 2\n"), filters=[f, f])

    def test_filter_mask_shape_checked(self):
        f = LinkFilter("bad", lambda s, d: np.ones(1, bool))
        with pytest.raises(ValueError, match="mask of shape"):
            ingest_edge_list(io.StringIO("1 2\n3 4\n"), filters=[f])

    def test_all_filtered_raises(self):
        f = LinkFilter("all", lambda s, d: np.zeros(s.shape, bool))
        with pytest.raises(ValueError, match="empty graph"):
            ingest_edge_list(io.StringIO("1 2\n"), filters=[f])

    def test_virtual_mass_hand_computed(self):
        # kept graph: 10 <-> 20; virtual: 10 -> 999 (offsite). Node 10
        # would split damping*pr[10] over (1 kept + 1 virtual) links.
        f = LinkFilter("offsite", lambda s, d: d < 900)
        rf = ref_ingest.LinkFilter("offsite", lambda s, d: d < 900)
        text = "10 20\n20 10\n10 999\n"
        res = ingest_edge_list(io.StringIO(text), filters=[f])
        ref = ref_ingest.ingest_edge_list(io.StringIO(text), filters=[rf])
        assert_same_result(res, ref)
        pr = pagerank_reference(res.graph, num_iterations=80)
        mass = res.virtual_mass(pr)
        pr10 = pr[res.idmap.to_internal(np.int64(10))]
        assert mass["offsite"] == pytest.approx(0.85 * pr10 / 2)
        assert mass == ref.virtual_mass(pr)

    def test_virtual_source_not_in_graph_contributes_nothing(self):
        # 999 -> 5 is filtered and 999 never enters the graph: its rank
        # is unknown, so its virtual edge carries zero mass
        f = LinkFilter("off", lambda s, d: (s < 900) & (d < 900))
        res = ingest_edge_list(io.StringIO("1 2\n2 1\n999 5\n"), filters=[f])
        pr = pagerank_reference(res.graph, num_iterations=40)
        assert res.virtual_mass(pr)["off"] == 0.0
        with pytest.raises(ValueError, match="entries"):
            res.virtual_mass(pr[:1])

    def test_fixture_virtual_mass_equals_reference(self):
        res, ref = fixture_ingest()
        pr = ref_core.pagerank_reference(ref.graph, num_iterations=40)
        assert res.virtual_mass(pr) == ref.virtual_mass(pr)
        assert res.virtual_mass(pr, damping=0.5) == ref.virtual_mass(
            pr, damping=0.5)

    def test_incremental_ingest_into_an_existing_idmap(self):
        res, ref = both("ingest_edge_list", lambda: io.StringIO("5 6\n6 7\n"))
        more = ingest_edge_list(io.StringIO("7 8\n5 8\n"), idmap=res.idmap)
        rmore = ref_ingest.ingest_edge_list(io.StringIO("7 8\n5 8\n"),
                                            idmap=ref.idmap)
        assert_same_result(more, rmore)
        assert more.idmap.external_ids.tolist() == [5, 6, 7, 8]


# -------------------------------------- end-to-end external-id parity
@pytest.mark.parametrize("reorder", ["none", "hybrid"])
def test_end_to_end_fixture_parity(reorder):
    """Fixture file -> pipeline -> solve and serve, every result in the
    file's own ids: the dense float64 oracle's, and the reference's."""
    res, ref = fixture_ingest()
    g = res.graph
    oracle = pagerank_reference(g, num_iterations=60)
    kw = dict(method="pcpm", part_size=16, num_iterations=60, tol=0.0,
              reorder=reorder, slots=2, chunk=4)
    sess = res.open(**kw, **CPU)
    rsess = ref.open(**kw)
    out = sess.pagerank()
    ranks = out.ranks.numpy()
    np.testing.assert_allclose(ranks, oracle, atol=1e-6, rtol=0)
    assert np.abs(ranks - np.asarray(rsess.pagerank().ranks)).max() <= 1e-6

    ids, scores = sess.top_ranked(5)
    expect_ext = res.idmap.to_external(oracle_top(oracle, 5))
    assert ids.tolist() == expect_ext.tolist()
    assert ids.tolist() == rsess.top_ranked(5)[0].tolist()
    np.testing.assert_allclose(scores, oracle[oracle_top(oracle, 5)],
                               atol=1e-6)

    sch, rsch = sess.serve(), rsess.serve()
    assert sch.idmap is res.idmap
    results = []
    for s in (sch, rsch):
        u_topk = s.submit(top_k=5, tol=0.0, max_iters=60, route="stepper")
        u_full = s.submit(tol=0.0, max_iters=60, route="stepper")
        done = {r.uid: r for r in s.run_until_drained()}
        results.append((done[u_topk], done[u_full]))
    (topk, full), (rtopk, rfull) = results
    assert topk.error is None and topk.top_external is not None
    assert sorted(topk.top_external.tolist()) == \
        sorted(expect_ext.tolist())
    assert topk.top_external.tolist() == rtopk.top_external.tolist()
    assert topk.top_external.tolist() == \
        res.idmap.to_external(topk.top_ids).tolist()
    assert full.top_external is None
    np.testing.assert_allclose(full.ranks, oracle, atol=1e-6, rtol=0)
    assert np.abs(full.ranks - rfull.ranks).max() <= 1e-6


def test_push_route_speaks_external_ids():
    """Personalized push queries on a reordered plan return the same
    external top-k as on the unreordered plan, and as the reference."""
    res, ref = fixture_ingest()
    seed = np.zeros(res.graph.num_nodes, dtype=np.float32)
    seed[res.idmap.to_internal(res.idmap.external_ids[3])] = 1.0
    tops = {}
    for reorder in ("none", "hybrid"):
        kw = dict(part_size=16, reorder=reorder, slots=2, chunk=4)
        for name, s in (("port", res.open(**kw, **CPU)),
                        ("reference", ref.open(**kw))):
            sch = s.serve(route="push")
            sch.submit(seed, top_k=5, tol=1e-4, max_iters=200)
            sch.run_until_drained()
            (q,) = sch.completed
            assert q.error is None and q.top_external is not None
            tops[reorder, name] = sorted(q.top_external.tolist())
    assert len({tuple(t) for t in tops.values()}) == 1


def test_session_without_idmap_keeps_dense_ids():
    res, _ = fixture_ingest()
    sess = repro_torch.open(res.graph, part_size=16, **CPU)
    sess.pagerank()
    ids, _ = sess.top_ranked(3)
    assert ids.dtype == np.int64 and ids.max() < res.graph.num_nodes
    sch = sess.serve()
    assert sch.idmap is None
    sch.submit(top_k=3, tol=0.0, max_iters=5, route="stepper")
    (q,) = sch.run_until_drained()
    assert q.top_external is None and q.top_ids is not None


def test_ingest_exports_the_reference_names():
    assert repro_torch.ingest.__all__ == ref_ingest.__all__
    for name in ("LinkFilter", "NodeIdMapping", "VirtualLinks",
                 "ingest_edge_list"):
        assert getattr(repro_torch, name) is getattr(repro_torch.ingest,
                                                     name)
        assert name in repro_torch.__all__


# ----------------------------------------- reorder-in-plan wiring
@pytest.fixture(scope="module")
def rmat():
    g, r = generators.rmat(8, 6, seed=3), ref_gen.rmat(8, 6, seed=3)
    assert np.array_equal(g.src, r.src) and np.array_equal(g.dst, r.dst)
    return g, r


class TestReorderPlans:
    @pytest.mark.parametrize("reorder", ["degree", "bfs", "hybrid"])
    def test_engine_parity_each_ordering(self, rmat, reorder):
        g, r = rmat
        oracle = pagerank_reference(g, num_iterations=40)
        sess = repro_torch.open(g, part_size=32, num_iterations=40,
                                tol=0.0, reorder=reorder, **CPU)
        ranks = sess.pagerank().ranks.numpy()
        np.testing.assert_allclose(ranks, oracle, atol=1e-6, rtol=0)
        rsess = ref_api.open(r, part_size=32, num_iterations=40, tol=0.0,
                             reorder=reorder)
        assert np.array_equal(sess.plan.reorder_perm, rsess.plan.reorder_perm)
        assert np.abs(ranks - np.asarray(rsess.pagerank().ranks)).max() \
            <= 1e-6

    def test_distinct_cache_entries_per_ordering(self, rmat):
        g, _ = rmat
        # part_size distinct from every other test in this module, so the
        # cache-miss accounting below starts from a clean key
        cfg = repro_torch.EngineConfig(part_size=64)
        p_none = build_plan(g, cfg.plan_config())
        before = plan_cache_stats().plan_builds
        p_hyb = build_plan(g, cfg.replace(reorder="hybrid").plan_config())
        assert plan_cache_stats().plan_builds == before + 1
        assert p_hyb is not p_none
        assert p_none.reorder_perm is None
        assert p_hyb.reorder_perm is not None
        # a reordered plan is stamped with the ORIGINAL graph fingerprint
        assert p_hyb.graph_fp == p_none.graph_fp
        assert build_plan(g, cfg.replace(reorder="hybrid")
                          .plan_config()) is p_hyb

    def test_unknown_ordering_rejected(self, rmat):
        g, _ = rmat
        with pytest.raises(ValueError, match="reorder"):
            repro_torch.open(g, reorder="gorder", **CPU)

    def test_plan_save_load_round_trips_permutation(self, rmat, tmp_path):
        g, _ = rmat
        cfg = repro_torch.EngineConfig(part_size=32, reorder="hybrid")
        plan = build_plan(g, cfg.plan_config())
        p = str(tmp_path / "g.plan.npz")
        plan.save(p)
        loaded = load_plan(p)
        np.testing.assert_array_equal(loaded.reorder_perm, plan.reorder_perm)
        assert loaded.config.reorder == "hybrid"
        install_plan(g, loaded)
        before = plan_cache_stats().plan_builds
        sess = repro_torch.open(g, cfg, **CPU)
        assert plan_cache_stats().plan_builds == before
        oracle = pagerank_reference(g, num_iterations=40)
        np.testing.assert_allclose(
            sess.pagerank(num_iterations=40, tol=0.0).ranks.numpy(),
            oracle, atol=1e-6, rtol=0)

    def test_batch_server_speaks_original_ids(self, rmat):
        g, _ = rmat
        sess = repro_torch.open(g, part_size=32, num_iterations=40,
                                tol=0.0, reorder="hybrid", **CPU)
        srv = sess.server(batch=1)
        oracle = pagerank_reference(g, num_iterations=40)
        pr, _, _ = srv.query()
        np.testing.assert_allclose(pr.numpy(), oracle, atol=1e-6, rtol=0)
        seeds = np.zeros(g.num_nodes, np.float32)
        seeds[11] = 1.0
        prs, _, _ = srv.query(seeds)
        base = repro_torch.open(g, part_size=32, num_iterations=40,
                                tol=0.0, **CPU).server(batch=1)
        prb, _, _ = base.query(seeds)
        np.testing.assert_allclose(prs.numpy(), prb.numpy(), atol=1e-6,
                                   rtol=0)

    def test_scheduler_apply_delta_guard(self, rmat):
        g, _ = rmat
        sess = repro_torch.open(g, part_size=32, reorder="degree", slots=2,
                                chunk=4, **CPU)
        sch = sess.serve()
        delta = repro_torch.GraphDelta.insert(np.array([[0, 5]],
                                                       dtype=np.int32))
        with pytest.raises(ValueError, match="reorder"):
            sch.apply_delta(delta)

    def test_session_delta_rebuilds_and_warm_falls_back(self, rmat):
        g, _ = rmat
        sess = repro_torch.open(g, part_size=32, num_iterations=40,
                                tol=1e-10, reorder="degree", **CPU)
        sess.pagerank()
        delta = repro_torch.GraphDelta.insert(
            np.array([[1, 7], [3, 9]], dtype=np.int32))
        sess.apply_delta(delta)
        warm = sess.pagerank(warm=True)      # an honest cold fallback
        oracle = pagerank_reference(sess.graph, num_iterations=40)
        np.testing.assert_allclose(warm.ranks.numpy(), oracle, atol=1e-6,
                                   rtol=0)
