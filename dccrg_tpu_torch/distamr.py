"""Crash-safe distributed AMR of the port: an epoch-fenced, abortable
cross-rank structure commit (counterpart of ``dccrg_tpu/distamr.py``).

The reference dccrg resolves induced 2:1 refinement ACROSS process
boundaries with iterated MPI collectives (dccrg.hpp:9730-10693); a rank
that dies mid-commit takes the job with it. Here structure is
replicated and AMR *requests* are rank-local, so a multi-rank adapt
epoch must first exchange every rank's request view and then install
the SAME new structure everywhere, atomically, against real failure:
``kill -9`` at any phase, a stopped zombie with a stale epoch, a wedged
or lying KV store, a torn proposal record.

:func:`distributed_stop_refining` runs one adapt epoch as a fleet-wide
transaction over the coordination KV store (:mod:`coord`: an
:class:`~dccrg_tpu_torch.coord.InMemoryKV` shared by in-process ranks,
or the process group's :class:`~dccrg_tpu_torch.coord.CoordKV`), four
fenced phases, each a named fault point (``amr.propose`` /
``amr.resolve`` / ``amr.install`` with ``phase="prepare"|"commit"``;
:data:`~dccrg_tpu_torch.faults.DIST_AMR_FAULT_SITES`):

``propose``
    Each rank seals (CRC-framed,
    :func:`~dccrg_tpu_torch.coord.seal_record`) its local request sets,
    its structure digest and the one-wave induced-refinement frontier
    it expects to push across its ownership boundary
    (:func:`~dccrg_tpu_torch.amr.frontier_induced_refines`) into a
    proposal record; the records meet at a fenced
    :func:`~dccrg_tpu_torch.coord.kv_barrier`, which doubles as the
    deadline-bounded proposal exchange.

``resolve``
    Each rank verifies every proposal (CRC frame, fence and attempt
    echo, structure-digest agreement, and the frontier recomputed from
    the declared requests against the reader's OWN structure: a
    mismatch convicts the proposer of resolving against another
    structure epoch), merges the request sets and runs the same
    deterministic :func:`~dccrg_tpu_torch.amr.resolve_adaptation`
    fixpoint. The result digests meet at the resolve barrier and must
    be identical.

``prepare``
    Each rank mirrors the local commit's bookkeeping (request sets
    cleared, disappearing cells' data preserved) and builds the new
    plan WITHOUT touching the live one (on a
    :class:`~dccrg_tpu_torch.background.PlanBuildWorker` with
    ``DCCRG_BG_RECOMMIT=1``, inline otherwise). Plan digests meet at the
    prepare barrier and must be identical.

``commit``
    The decision point: the commit barrier, then every rank races its
    verdict onto the round's SINGLE first-writer-wins decision key
    (``kv.create``); every abort path races ``abort``. Whatever record
    lands first IS the round's outcome, and every rank reads it back
    and obeys it. The epoch fence then advances through a create-only
    per-epoch key (monotonic by construction), the plan installs, and
    the decision winner garbage-collects every key of the rounds the
    fence has moved past.

Any failure before the commit decision aborts through
:func:`~dccrg_tpu_torch.txn.cross_rank_transaction`: this rank lands the
``abort`` verdict, rolls back bit for bit (old plan, old data, request
sets; the epoch is retryable) and posts the abort marker its peers'
barriers fast-abort on. Once the verdict is ``commit`` the transaction
is past its point of no return: a rank whose LOCAL install fails ends
its process (:func:`_fatal_install`) rather than roll back into
permanent structural divergence. A stopped zombie that wakes after the
survivors committed finds the fence advanced
(:class:`~dccrg_tpu_torch.coord.StaleFenceError`) and keeps serving the
OLD plan. A retry after an abort is COLLECTIVE: every participant calls
:func:`distributed_stop_refining` again, and the per-process attempt
counter re-aligns the barrier tags.

Ranks that share one card (threads or processes) each hold their own
grid; each protocol call sets that grid's card on its thread before the
first launch. Without an :class:`AmrCommitGroup`,
``Grid.stop_refining`` is the one-process commit, unchanged.
"""

from __future__ import annotations

import json
import logging
import time
import zlib
from contextlib import nullcontext

import numpy as np
import torch

from . import amr, background, coord, faults, telemetry, txn

logger = logging.getLogger("dccrg_tpu_torch.distamr")

#: test hook: called as ``_PHASE_PROBE(phase, rank)`` right before each
#: protocol phase runs (progress markers, a simulated stop of the
#: process). None in production.
_PHASE_PROBE = None


class AmrProposalError(RuntimeError):
    """A peer's proposal record failed verification BEYOND its CRC
    frame: wrong fence/attempt echo, a structure digest that does not
    match this rank's replicated structure, or a declared induction
    frontier that does not recompute from the declared requests — the
    proposer resolved against a different structure epoch. The round
    must abort collectively; acting on the proposal would commit
    diverged structure. ``rank`` names the proposer."""

    def __init__(self, rank: int, detail: str):
        super().__init__(
            f"AMR proposal from rank {rank} rejected: {detail}")
        self.rank = int(rank)


def _crc(arr, h: int = 0) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes(), h) & 0xFFFFFFFF


def structure_digest(grid) -> int:
    """CRC32 of the live plan's (cells, owner) — the replicated
    structure fingerprint every proposal must echo."""
    return _crc(grid.plan.owner, _crc(grid.plan.cells))


def plan_digest(plan) -> int:
    """CRC32 fingerprint of a constructed plan's structural identity
    (cells, owner, layout extents) — what the prepare barrier
    compares, and what the multi-process tests hold survivors to after
    an aborted commit."""
    h = _crc(plan.owner, _crc(plan.cells))
    for scalar in (getattr(plan, "R", 0), getattr(plan, "L", 0)):
        h = zlib.crc32(str(int(scalar)).encode(), h) & 0xFFFFFFFF
    return h


class AmrCommitGroup:
    """One rank's handle on the fleet-wide AMR commit protocol.

    Holds the coordination KV, this rank's identity, the expected
    participant set (narrowed by a :class:`~dccrg_tpu_torch.coord.Membership`
    lease view when one is given — a dead rank's requests are dropped
    and its cells absorbed by reclaim, which is how a retry after a
    death makes progress), and the epoch fence every round is gated
    on. Install with :meth:`~dccrg_tpu_torch.grid.Grid
    .enable_distributed_amr`; ``stop_refining`` then routes through
    :func:`distributed_stop_refining`."""

    def __init__(self, grid, *, kv=None, rank=None, n_ranks=None,
                 membership=None, prefix: str = "dccrg/amr",
                 timeout=None, poll_s: float = 0.02):
        self.grid = grid
        self.kv = kv if kv is not None else coord.default_kv()
        if rank is None:
            rank = coord.process_rank(grid)
        self.rank = int(rank)
        if n_ranks is None:
            n_ranks = coord.process_count()
        self.n_ranks = max(1, int(n_ranks))
        self.membership = membership
        self.prefix = str(prefix)
        self.timeout = timeout  # None: coord.barrier_timeout() per round
        self.poll_s = max(0.001, float(poll_s))
        self.attempt = 0

    def fence_key(self) -> str:
        return f"{self.prefix}/fence"

    def epoch_key(self, n: int) -> str:
        return f"{self.prefix}/fence/{int(n)}"

    def _mirror_fence(self) -> int:
        try:
            return int(self.kv.get(self.fence_key()))
        except (TypeError, ValueError):
            return 0

    def read_fence(self) -> int:
        """The current epoch fence: the max over the CREATE-only
        per-epoch keys (authoritative — they only accumulate, so this
        read can never observe a regression) and the legacy mirror
        key (what a ``dir_get``-degraded service still serves, and
        what the zombie-fencing tests write directly)."""
        best = self._mirror_fence()
        listing = self.kv.dir_get(f"{self.prefix}/fence/")
        for k in (listing or {}):
            try:
                best = max(best, int(k.rsplit("/", 1)[-1]))
            except ValueError:
                continue
        return best

    def advance_fence(self, target: int) -> int:
        """Publish epoch ``target`` monotonically: CREATE the epoch
        key (first-writer-wins and append-only — a rank that stalled
        between deciding and publishing can never drag the fence
        backwards, which the blind ``set`` this replaces could), then
        refresh the mirror best-effort and only ever upwards. Returns
        the fence now observed."""
        target = int(target)
        self.kv.create(self.epoch_key(target), "1")
        if self._mirror_fence() < target:
            self.kv.set(self.fence_key(), str(target))
        return self.read_fence()

    def local_devs(self):
        """This rank's partition ids — the ownership view its proposal declares so peers can recompute
        its frontier."""
        return [int(d) for d in
                np.nonzero(np.asarray(self.grid._proc_local_dev))[0]]

    def expected_ranks(self):
        """The participant set of the NEXT round: every configured
        rank, minus the ones the membership lease view has declared
        dead (their pending requests are lost with them — the
        documented semantics of a mid-epoch death)."""
        if self.membership is not None:
            try:
                self.membership.poll()
            except Exception:  # noqa: BLE001 - view refresh best-effort
                pass
            live = {r for r in self.membership.live_ranks()
                    if 0 <= int(r) < self.n_ranks}
            live.add(self.rank)
            return sorted(live)
        return list(range(self.n_ranks))


class _Attempt:
    """Naming + abort plumbing of one (fence, attempt) round."""

    def __init__(self, group: AmrCommitGroup, fence: int, attempt: int,
                 expected):
        self.group = group
        self.fence = int(fence)
        self.attempt = int(attempt)
        self.expected = list(expected)
        self.timeout = (coord.barrier_timeout() if group.timeout is None
                        else float(group.timeout))

    def tag(self, phase: str) -> str:
        return (f"{self.group.prefix}/b/{self.fence}"
                f"#{self.attempt}/{phase}")

    def key(self, name: str) -> str:
        return (f"{self.group.prefix}/{name}/{self.fence}"
                f"#{self.attempt}")

    def abort_key(self) -> str:
        return self.key("abort")

    def decision_key(self) -> str:
        return self.key("decision")

    def decide(self, want: str, detail: str = "") -> dict:
        """Race this rank's verdict for the round onto the SINGLE
        first-writer-wins decision key and return the verdict that
        actually STANDS (which may be a peer's opposite one — the
        caller must obey it). This is what makes the commit decision
        atomic: a slow rank and a timing-out peer can both reach the
        decision point, but only one record lands, and both act on
        the same one. The read retries a transiently wedged KV; a
        verdict that stays unreadable (or is torn) reads as ABORT —
        keeping the old plan is the one answer a rank may act on
        alone."""
        key = self.decision_key()
        self.group.kv.create(key, coord.seal_record(json.dumps(
            {"decision": str(want), "fence": self.fence,
             "attempt": self.attempt, "rank": self.group.rank,
             "detail": str(detail)[:200]}, sort_keys=True)))
        raw = None
        for _ in range(50):
            raw = self.group.kv.get(key)
            if raw is not None:
                break
            time.sleep(0.02)
        try:
            info = json.loads(coord.unseal_record(raw, key))
            if str(info.get("decision")) in ("commit", "abort"):
                return info
            fallback = f"malformed decision record {info!r}"[:200]
        except Exception as e:  # noqa: BLE001 - torn/unreadable verdict
            fallback = f"unreadable decision record ({type(e).__name__})"
        return {"decision": "abort", "fence": self.fence,
                "attempt": self.attempt, "rank": -1, "detail": fallback}

    def post_abort(self, err: BaseException) -> None:
        """The distributed-rollback announcement
        (:func:`~dccrg_tpu_torch.txn.cross_rank_transaction`'s ``on_abort``):
        FIRST race the round's ABORT verdict onto the decision key —
        so a slow peer that later wakes into a complete-looking
        barrier reads it and rolls back instead of committing alone —
        then land the sealed abort marker every peer blocked in this
        round's barriers fast-aborts on instead of burning its
        deadline."""
        cause = getattr(err, "__cause__", None) or err
        reason = f"{type(cause).__name__}: {cause}"[:200]
        self.group.kv.create(self.decision_key(), coord.seal_record(
            json.dumps({"decision": "abort", "fence": self.fence,
                        "attempt": self.attempt,
                        "rank": self.group.rank, "detail": reason},
                       sort_keys=True)))
        self.group.kv.set(self.abort_key(), coord.seal_record(json.dumps(
            {"rank": self.group.rank, "reason": reason})))

    def barrier(self, phase: str, value: str = "1") -> dict:
        """This round's fenced barrier at ``phase``; returns the
        per-rank values (the built-in all-gather). The fence watch
        reads through :meth:`AmrCommitGroup.read_fence` (the monotonic
        epoch-key max), not the raw mirror key, so a regressed mirror
        can neither spuriously convict a live round nor let a stale
        zombie pass."""
        return coord.kv_barrier(
            self.group.kv, self.tag(phase), self.group.rank,
            self.expected, timeout=self.timeout, value=value,
            poll_s=self.group.poll_s,
            fence=(self.group.read_fence, str(self.fence)),
            abort_key=self.abort_key(), membership=self.group.membership)

    def gc_older_rounds(self) -> None:
        """Best-effort garbage collection after THIS round committed:
        delete every barrier arrival, abort marker, decision record
        and epoch-fence key of rounds STRICTLY older than this fence.
        The current round's keys stay — a slow peer may still be
        reading its decision — and the newest epoch keys stay, so a
        fence read can never regress. Keeps the coordination KV
        bounded across adapt epochs and removes the stale arrivals
        that made tag aliasing possible; a zombie whose whole round
        was collected finds its decision key gone, reads ABORT, and
        stays on its old plan (the fleet-layer rejoin path)."""
        kv = self.group.kv
        prefix = self.group.prefix
        for sub in (f"{prefix}/b/", f"{prefix}/abort/",
                    f"{prefix}/decision/", f"{prefix}/fence/"):
            listing = kv.dir_get(sub)
            for k in (listing or {}):
                if not k.startswith(sub):
                    continue
                head = k[len(sub):].split("#", 1)[0].split("/", 1)[0]
                try:
                    f = int(head)
                except ValueError:
                    continue
                if f < self.fence:
                    kv.delete(k)


def _probe(phase: str, rank: int) -> None:
    if _PHASE_PROBE is not None:
        _PHASE_PROBE(phase, rank)


def _maybe_hang(site: str, phase, rank) -> None:
    hang = faults.take_amr_hang(site, phase=phase, rank=rank)
    if hang:
        time.sleep(min(float(hang), 3600.0))


#: test hook: replaces the process-terminating half of
#: :func:`_fatal_install` so in-process fakes can observe the verdict
#: without dying. Called with the original exception. None in
#: production.
_FATAL_INSTALL = None

#: exit code of a rank whose post-decision install failed — the one
#: failure 2PC cannot roll back (peers committed) and must convert
#: into a death the lease/reclaim machinery absorbs.
INSTALL_FATAL_RC = 86


def _fatal_install(err: BaseException) -> None:
    """A LOCAL failure after the round's verdict landed as COMMIT:
    the peers are installing the new plan, so rolling this rank back
    would leave a permanently structurally diverged survivor (every
    future collective adapt would abort fleet-wide on its stale
    digest, with no in-protocol resync). The only consistent outcome
    is to stop being a survivor: terminate the process and let the
    lease/reclaim machinery absorb it exactly like a post-decision
    death — which is what it is."""
    if _FATAL_INSTALL is not None:
        _FATAL_INSTALL(err)
        return
    import os

    os._exit(INSTALL_FATAL_RC)


def distributed_stop_refining(grid, group: AmrCommitGroup = None):
    """Commit all ranks' refinement requests as one fleet-wide,
    crash-consistent transaction (see module docstring); returns the
    created cells exactly as the local ``stop_refining`` would.

    Any failure before the commit decision raises
    :class:`~dccrg_tpu_torch.txn.CrossRankAbortedError` (or propagates an
    injected rank death raw) with this rank bitwise rolled back and
    the abort announced to the peers; the epoch is collectively
    retryable — every surviving rank calls this again. Once the
    round's verdict is COMMIT, failures roll FORWARD: the plan
    installs even if this rank's commit barrier failed, and a local
    install failure terminates the process (:func:`_fatal_install`)
    instead of leaving a diverged survivor."""
    if group is None:
        group = getattr(grid, "_amr_group", None)
    if group is None:
        raise ValueError("grid has no AmrCommitGroup: call "
                         "enable_distributed_amr() first")
    fence0 = group.read_fence()
    group.attempt += 1
    att = _Attempt(group, fence0, group.attempt, group.expected_ranks())
    t0 = time.perf_counter()
    staged: dict = {}
    # a rank may run on a thread of its own: its grid's card first
    card = grid._card
    on_card = torch.cuda.device(card) if card is not None else nullcontext()
    with on_card:
        try:
            with telemetry.span("grid.adapt.dist"), \
                    txn.cross_rank_transaction(
                        grid, op="distributed_stop_refining",
                        rank=group.rank, on_abort=att.post_abort,
                        validate=False):
                _run_round(grid, group, att, staged)
        except txn.CrossRankAbortedError:
            telemetry.inc("dccrg_dist_amr_aborts_total")
            raise
        # the fleet-wide verdict is COMMIT: from here on failures roll
        # forward, never back — see _install_decided
        _install_decided(grid, group, att, staged)
    telemetry.observe("dccrg_dist_amr_commit_seconds",
                      time.perf_counter() - t0)
    telemetry.inc("dccrg_dist_amr_commits_total")
    return staged["res"].new_cells.copy()


def _install_decided(grid, group: AmrCommitGroup, att: _Attempt,
                     staged: dict) -> None:
    """The post-decision half of the commit: publish the new epoch
    (monotonic create-only key — a stalled rank's late publish can
    never regress it), install the prepared plan, verify in DEBUG
    mode, then let the decision winner garbage-collect the rounds the
    fence moved past. Runs OUTSIDE the abortable transaction: the
    round is decided, so 2PC forbids restoring the old plan here — a
    local failure terminates the process instead
    (:func:`_fatal_install`)."""
    try:
        group.advance_fence(att.fence + 1)
        grid._install_plan(staged["plan"])
        if getattr(grid, "_debug", False):
            from . import verify as verify_mod

            verify_mod.verify_all(grid, check_pins=False)
    except BaseException as err:  # noqa: BLE001 - divergence is fatal
        logger.critical(
            "rank %d: post-decision install failed (%s: %s) — "
            "terminating: the fleet committed fence %d and a survivor "
            "still serving the old plan would diverge it permanently",
            group.rank, type(err).__name__, err, att.fence + 1)
        telemetry.inc("dccrg_dist_amr_install_fatal_total")
        _fatal_install(err)
        raise
    if int(staged.get("decision", {}).get("rank", -1)) == group.rank:
        # exactly one rank won the decision create: it sweeps, the
        # others skip — GC needs no coordination of its own
        att.gc_older_rounds()


def _run_round(grid, group: AmrCommitGroup, att: _Attempt,
               staged: dict) -> None:
    from .grid import DEFAULT_NEIGHBORHOOD_ID

    offsets = grid.neighborhoods[DEFAULT_NEIGHBORHOOD_ID]

    # ---- propose ----------------------------------------------------
    _probe("propose", group.rank)
    faults.fire("amr.propose", rank=group.rank)
    _maybe_hang("amr.propose", None, group.rank)
    cur = group.read_fence()
    if cur != att.fence:
        # stopped between reading the fence and proposing: a zombie
        # already — lose before writing anything
        raise coord.StaleFenceError(att.tag("propose"), att.fence, cur)
    sdig = structure_digest(grid)
    devs = group.local_devs()
    frontier = amr.frontier_induced_refines(
        grid.mapping, grid.plan.cells, grid.plan.owner, offsets,
        grid._refines, devs, topology=grid.topology)
    record = coord.seal_record(json.dumps({
        "rank": group.rank, "fence": att.fence, "attempt": att.attempt,
        "sdig": sdig, "devs": devs,
        "refines": sorted(int(c) for c in grid._refines),
        "unrefines": sorted(int(c) for c in grid._unrefines),
        "dont_refines": sorted(int(c) for c in grid._dont_refines),
        "dont_unrefines": sorted(int(c) for c in grid._dont_unrefines),
        "frontier": [int(c) for c in frontier],
    }, sort_keys=True))
    if faults.take_torn_record("amr.propose", rank=group.rank):
        # a writer that died mid-write: store a frame whose CRC cannot
        # verify — readers must convict, never parse
        record = record[: max(1, len(record) - 4)]
    # the fenced barrier IS the deadline-bounded proposal exchange
    raw = att.barrier("propose", value=record)

    # ---- resolve ----------------------------------------------------
    _probe("resolve", group.rank)
    faults.fire("amr.resolve", rank=group.rank)
    _maybe_hang("amr.resolve", None, group.rank)
    props = {}
    for r, rec in raw.items():
        payload = coord.unseal_record(rec, key=att.tag("propose")
                                      + f"/{r}")
        props[r] = json.loads(payload)
    merged = {"refines": set(), "unrefines": set(),
              "dont_refines": set(), "dont_unrefines": set()}
    for r, p in sorted(props.items()):
        if (int(p.get("fence", -1)) != att.fence
                or int(p.get("attempt", -1)) != att.attempt
                or int(p.get("rank", -1)) != r):
            raise AmrProposalError(
                r, f"round echo mismatch (fence {p.get('fence')!r}, "
                   f"attempt {p.get('attempt')!r})")
        if int(p.get("sdig", -1)) != sdig:
            raise AmrProposalError(
                r, f"structure digest {p.get('sdig')} != local {sdig} "
                   "— proposer resolved against a different structure "
                   "epoch")
        declared = np.sort(np.asarray(p.get("frontier", []),
                                      dtype=np.uint64))
        recomputed = amr.frontier_induced_refines(
            grid.mapping, grid.plan.cells, grid.plan.owner, offsets,
            set(int(c) for c in p.get("refines", [])),
            p.get("devs", []), topology=grid.topology)
        if not np.array_equal(declared, recomputed):
            raise AmrProposalError(
                r, "declared induction frontier does not recompute "
                   "from the declared requests")
        for name in merged:
            merged[name].update(int(c) for c in p.get(name, []))
    res = amr.resolve_adaptation(
        grid.mapping, grid.plan.cells, grid.plan.owner, offsets,
        merged["refines"], merged["unrefines"],
        merged["dont_refines"], merged["dont_unrefines"],
        pins=grid._pins, weights=grid._weights,
        topology=grid.topology, hood_len=grid._hood_len)
    rdig = _crc(res.owner, _crc(res.cells))
    votes = att.barrier("resolve", value=str(rdig))
    bad = {r: v for r, v in votes.items() if v != str(rdig)}
    if bad:
        raise AmrProposalError(
            min(bad), f"resolve digest disagreement: {bad} != {rdig} "
                      "— the deterministic fixpoint diverged")

    # ---- prepare ----------------------------------------------------
    _probe("prepare", group.rank)
    faults.fire("amr.install", phase="prepare", rank=group.rank)
    _maybe_hang("amr.install", "prepare", group.rank)
    # mirror the local commit's bookkeeping (grid.stop_refining): the
    # request sets are consumed, disappearing cells' data preserved
    # for get_old_data(), all inside the transaction snapshot
    grid._refines.clear()
    grid._unrefines.clear()
    grid._dont_refines.clear()
    grid._dont_unrefines.clear()
    old_ids = np.concatenate([res.refined_parents, res.removed_cells])
    # one gather per field over the held rows, as the local commit
    # takes it (the structure is replicated; rows held by other ranks
    # are merged from theirs)
    grid._removed_data = grid._preserved_rows(old_ids)
    grid._removed_cells = res.removed_cells
    grid._new_cells = res.new_cells
    grid._unrefined_parents = res.unrefined_parents

    old_plan = grid.plan
    same_cells = (len(res.cells) == len(old_plan.cells)
                  and np.array_equal(res.cells, old_plan.cells))
    if same_cells:
        changed_hint = (old_plan.cells, np.empty(0, dtype=np.uint64))
    else:
        changed_hint = (old_plan.cells, res.changed_cells)
    if background.bg_recommit_enabled():
        # the per-rank build runs on this rank's PlanBuildWorker
        # against its own arena generation (live + rollback plans stay
        # protected); the commit still waits for it HERE — the install
        # is collective and cannot ride a per-host step boundary
        worker = background.PlanBuildWorker(
            grid, res.cells, res.owner, changed_hint).start()
        worker.wait()
        if worker.error is not None:
            logger.warning(
                "distributed AMR plan build worker failed (%s: %s); "
                "rebuilding inline", type(worker.error).__name__,
                worker.error)
            plan = grid._construct_plan(res.cells, res.owner,
                                        changed_hint)
        else:
            plan = worker.plan
    else:
        plan = grid._construct_plan(res.cells, res.owner, changed_hint)
    pdig = plan_digest(plan)
    votes = att.barrier("prepare", value=str(pdig))
    bad = {r: v for r, v in votes.items() if v != str(pdig)}
    if bad:
        raise AmrProposalError(
            min(bad), f"prepared plan digest disagreement: {bad} != "
                      f"{pdig}")

    # ---- commit -----------------------------------------------------
    _probe("commit", group.rank)
    faults.fire("amr.install", phase="commit", rank=group.rank)
    _maybe_hang("amr.install", "commit", group.rank)
    staged.update(plan=plan, res=res, same_cells=same_cells, pdig=pdig)
    # the decision point: a rank that dies BEFORE the verdict lands
    # aborts the whole round (the survivors time out / convict the
    # lease, land the abort verdict, and keep the old plan bitwise); a
    # rank that dies AFTER it is a post-decision death — the survivors
    # install and reclaim. The verdict itself is one first-writer-wins
    # record (att.decide), so the barrier outcome alone never commits.
    try:
        att.barrier("commit")
    except faults.InjectedRankDeath:
        # a simulated kill -9: a corpse posts no verdict — the peers
        # must convict it by lease/timeout, which is the invariant
        # under test
        raise
    except Exception as err:
        # the barrier failed LOCALLY, but the round may already be
        # decided: race an abort verdict onto the decision key. Losing
        # to a peer's COMMIT means the fleet is installing — this rank
        # must roll forward with it (a decided commit cannot be rolled
        # back), not restore the old plan and diverge.
        verdict = att.decide(
            "abort", detail=f"{type(err).__name__} at commit barrier")
        if verdict["decision"] == "commit":
            logger.warning(
                "rank %d: commit barrier failed (%s: %s) but the "
                "round's verdict is COMMIT (landed by rank %s) — "
                "rolling forward", group.rank, type(err).__name__,
                err, verdict.get("rank"))
            telemetry.inc("dccrg_dist_amr_commit_overruled_total")
            staged["decision"] = verdict
            return
        raise
    verdict = att.decide("commit", detail="commit barrier passed")
    if verdict["decision"] != "commit":
        # a peer's abort verdict won the race (it gave up on this
        # rank's arrival just as the barrier completed): obey it and
        # roll back with everyone else instead of committing alone
        raise coord.RemoteAbortError(
            att.tag("commit"), rank=int(verdict.get("rank", -1)),
            reason=str(verdict.get("detail", ""))[:200])
    staged["decision"] = verdict
