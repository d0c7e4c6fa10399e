"""Crash-safe recovery (a port of the JAX package's
``reliability/snapshot.py``; DESIGN.md §10).

Two artifacts, each one ``.npz`` keyed by the graph's CONTENT fingerprint
(core/plan.py), in the JAX package's format — keys, ``__meta__`` JSON and
versions — so a file written by either package loads in the other:

- ``snapshot_scheduler``/``restore_scheduler``: the serving state of a
  ``SlotScheduler`` — every in-flight query's spec and its CURRENT slot
  rank column, and every queued query's spec. Power iteration is
  memoryless given (rank column, base seed), so a restored scheduler
  continues each in-flight query from its exact iterate: the same final
  iteration count and ranks as the uninterrupted run.
- ``save_rank_checkpoint``/``load_rank_checkpoint``: one converged rank
  vector and the residual it achieved, fingerprint-stamped.
  ``Session.load_checkpoint`` (api.py) takes it directly when the
  fingerprints match, or across a ``GraphDelta`` chain (the delta's
  shifted fingerprint proves the lineage) by warm-starting the
  residual-push update (stream/incremental.py) from it.

A scheduler with an observability bundle (``obs``) records a
``snapshot`` event and parks its flight recorder beside the state as
``<path>.trace.jsonl``, as the JAX package does. A sharded pool's
columns are written in full, all ``n_pad`` padded rows, as the JAX
package writes them; above world size 1 rank 0 writes the file and
every rank restores from it (each rank holds the whole pool).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

SNAPSHOT_VERSION = 1
CHECKPOINT_VERSION = 1


# ---------------------------------------------------------------------------
# Rank-vector checkpoints
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RankCheckpoint:
    """A persisted solve: ranks and the L1 step-residual they achieved,
    stamped with the content fingerprint of the graph they solve."""
    graph_fp: str
    ranks: np.ndarray
    residual: float
    damping: float
    dangling: str


def save_rank_checkpoint(path: str, g, ranks, *, residual: float,
                         damping: float, dangling: str) -> None:
    from ..core.plan import graph_fingerprint
    meta = {"version": CHECKPOINT_VERSION,
            "graph_fp": graph_fingerprint(g),
            "residual": float(residual), "damping": float(damping),
            "dangling": dangling}
    np.savez_compressed(path, __meta__=json.dumps(meta),
                        ranks=np.asarray(ranks, dtype=np.float32))


def load_rank_checkpoint(path: str) -> RankCheckpoint:
    z = np.load(path)
    meta = json.loads(str(z["__meta__"]))
    if meta.get("version") != CHECKPOINT_VERSION:
        raise ValueError(
            f"unsupported rank-checkpoint version {meta.get('version')!r}"
            f" in {path!r}")
    return RankCheckpoint(meta["graph_fp"], z["ranks"],
                          meta["residual"], meta["damping"],
                          meta["dangling"])


# ---------------------------------------------------------------------------
# Scheduler snapshot / restore
# ---------------------------------------------------------------------------
def snapshot_scheduler(sch, path: str) -> None:
    """Persist ``sch``'s serving state: per in-flight query its spec,
    iteration count and CURRENT (n_pad,) rank column (n_pad = n unless
    the pool is sharded), and per queued query its spec. Deadlines are
    stored as REMAINING seconds and re-based on the restoring process's
    clock. Completed results are not included — they were already
    delivered.

    The cut is consistent under live traffic: the step lock keeps a
    chunk from advancing mid-snapshot (a half-stepped pool would pair
    pre-step iteration counts with post-step columns) and the intake
    lock keeps the queue still while it is walked (lock order: step,
    then intake, as ``step()`` takes them). The in-flight columns are
    read from the pool in one copy. A sharded scheduler calls this on
    every rank (the SPMD contract): rank 0 writes, and every rank of the
    mesh waits at a barrier until the file is there."""
    import torch
    from ..core.plan import graph_fingerprint
    n = sch._n_pad
    with sch._step_lock, sch._lock:
        now = sch.clock()
        live = [(slot, q) for slot, q in enumerate(sch._slot_query)
                if q is not None]
        pool = (sch._pr[:, [slot for slot, _ in live]].to("cpu",
                                                          torch.float32)
                .numpy().T if live else np.zeros((0, n), np.float32))
        specs = [(q, int(sch._iters[slot]), True) for slot, q in live]
        cols = list(pool)
        for q in sch._queue:
            specs.append((q, 0, False))
            cols.append(np.zeros(n, np.float32))
    seeds = [q.seed if q.seed is not None else np.zeros(n, np.float32)
             for q, _, _ in specs]
    k = len(specs)
    meta = {"version": SNAPSHOT_VERSION,
            "graph_fp": graph_fingerprint(sch.g),
            "damping": sch.damping, "dangling": sch.dangling,
            "n_pad": n,
            # slot columns and seeds are INTERNAL-space vectors when the
            # plan is reordered — the restoring scheduler must use the
            # same ordering or it would misread every column
            "reorder": sch.engine.plan.config.reorder,
            "uid_floor": (max(q.uid for q, _, _ in specs) + 1
                          if specs else 0)}
    mesh = sch.engine.mesh if sch.sharded else None
    if mesh is not None and mesh.shard != 0:
        mesh.barrier()                # rank 0 writes
        return
    np.savez_compressed(
        path, __meta__=json.dumps(meta),
        q_uid=np.array([q.uid for q, _, _ in specs], np.int64),
        q_tol=np.array([q.tol for q, _, _ in specs], np.float64),
        q_max_iters=np.array([q.max_iters for q, _, _ in specs],
                             np.int64),
        q_iters=np.array([it for _, it, _ in specs], np.int64),
        q_top_k=np.array([q.top_k if q.top_k is not None else -1
                          for q, _, _ in specs], np.int64),
        q_priority=np.array([q.priority for q, _, _ in specs], np.int64),
        q_deadline_rem=np.array(
            [q.deadline - now if q.deadline is not None else np.nan
             for q, _, _ in specs], np.float64),
        q_retries=np.array([q.retries for q, _, _ in specs], np.int64),
        q_degraded=np.array([q.degraded for q, _, _ in specs], bool),
        q_inflight=np.array([fl for _, _, fl in specs], bool),
        q_has_seed=np.array([q.seed is not None for q, _, _ in specs],
                            bool),
        seeds=(np.stack(seeds) if k else np.zeros((0, n), np.float32)),
        cols=(np.stack(cols) if k else np.zeros((0, n), np.float32)))
    obs = sch.obs
    if obs is not None:
        # the snapshot is a forensics moment: park the flight recorder
        # next to the state
        obs.tracer.event("snapshot", trace="plan", path=str(path),
                         in_flight=int(sum(1 for _, _, fl in specs
                                           if fl)), queued=len(sch._queue))
        obs.recorder.dump(f"{path}.trace.jsonl")
    if mesh is not None:
        mesh.barrier()


def restore_scheduler(path: str, g, **scheduler_kwargs):
    """Rebuild a ``SlotScheduler`` on ``g`` from a snapshot: build it
    fresh, then re-admit each in-flight query and write its snapshotted
    iterate over the freshly seeded column, so serving resumes mid-query.
    ``scheduler_kwargs`` must describe the same serving configuration
    (damping, dangling and the plan's reordering are checked against the
    snapshot: a mismatch would converge to different answers). If the
    restored pool has fewer slots than there were in-flight queries, the
    overflow goes back to the queue (losing only its iteration progress,
    never the query). Restored uids are kept; the process uid counter is
    advanced past them first."""
    import torch
    from ..core.plan import graph_fingerprint
    from ..serve.scheduler import Query, SlotScheduler, ensure_uid_floor
    with np.load(path) as npz:
        # every array read (and decompressed) once: an ``NpzFile`` reads
        # its member again on each ``npz[key]``
        z = {key: npz[key] for key in npz.files}
    meta = json.loads(str(z["__meta__"]))
    if meta.get("version") != SNAPSHOT_VERSION:
        raise ValueError(
            f"unsupported scheduler-snapshot version "
            f"{meta.get('version')!r} in {path!r}")
    fp = graph_fingerprint(g)
    if meta["graph_fp"] != fp:
        raise ValueError(
            "snapshot/graph mismatch: snapshot was taken on a graph "
            f"with content fingerprint {meta['graph_fp'][:12]}…, got "
            f"{fp[:12]}… — restoring would serve wrong answers")
    sch = SlotScheduler(g, **scheduler_kwargs)
    if (sch.damping, sch.dangling) != (meta["damping"], meta["dangling"]):
        raise ValueError(
            "snapshot/scheduler mismatch: snapshot ran damping="
            f"{meta['damping']}, dangling={meta['dangling']!r}; the "
            f"restored scheduler has damping={sch.damping}, "
            f"dangling={sch.dangling!r}")
    if sch.engine.plan.config.reorder != meta.get("reorder", "none"):
        raise ValueError(
            "snapshot/scheduler mismatch: snapshot slot state is in "
            f"reorder={meta.get('reorder', 'none')!r} internal space; "
            f"the restored scheduler uses "
            f"reorder={sch.engine.plan.config.reorder!r}")
    if sch._n_pad != meta["n_pad"]:
        raise ValueError(
            f"snapshot/scheduler mismatch: snapshot state is padded "
            f"to {meta['n_pad']} rows, scheduler to {sch._n_pad} "
            "(different sharding?)")
    ensure_uid_floor(int(meta["uid_floor"]))
    now = sch.clock()
    free = list(range(sch.slots))
    for i in range(len(z["q_uid"])):
        rem = float(z["q_deadline_rem"][i])
        top_k = int(z["q_top_k"][i])
        q = Query(
            uid=int(z["q_uid"][i]),
            seed=(z["seeds"][i] if bool(z["q_has_seed"][i]) else None),
            top_k=(top_k if top_k >= 0 else None),
            tol=float(z["q_tol"][i]),
            max_iters=int(z["q_max_iters"][i]),
            deadline=(now + rem if np.isfinite(rem) else None),
            priority=int(z["q_priority"][i]),
            degraded=bool(z["q_degraded"][i]),
            retries=int(z["q_retries"][i]))
        sch.metrics.submitted(q.uid)
        if bool(z["q_inflight"][i]) and free:
            slot = free.pop(0)
            sch._admit(slot, q)       # seeds the base, resets bookkeeping
            if q.max_iters == 0:
                continue              # _admit already finished it
            # the base is the seed's, so the iteration continues exactly
            # where it stopped
            sch._pr[:, slot] = torch.from_numpy(z["cols"][i]).to(sch.device)
            sch._iters[slot] = int(z["q_iters"][i])
        else:
            sch._queue.append(q)
    return sch
