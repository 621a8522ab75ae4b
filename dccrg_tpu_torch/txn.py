"""Transactional grid mutations.

Port of ``dccrg_tpu/txn.py``. The reference guards every structural
mutation (refinement commit, induced 2:1 balancing, load balancing)
with ``#ifdef DEBUG`` invariant checkers because a half-applied mutation
silently corrupts neighbor lists, and every later halo exchange then
moves garbage. This module makes the mutation paths of
:class:`~dccrg_tpu_torch.grid.Grid` **atomic**:

    with grid_transaction(grid, op="stop_refining"):
        ... mutate cells / owners / plan / field tensors ...

- On entry the minimal mutable structural state is snapshotted: the
  plan reference (plans are replaced wholesale; what a hood plan fills
  in lazily — its dense pair tables, roll plan, uploads — is memoized
  for that plan and stays valid for it), the field-tensor dict, the AMR
  request sets, the staged balance, pins and weights
  (``resolve_adaptation`` passes them to children in place), the
  capacity memo, the in-flight split-phase updates and the hybrid
  builder's epoch-reuse cache (``build_hybrid_plan`` swaps its contents
  in place). The compiled-program cache is keyed by static shapes, not
  by a plan, so an entry made inside a transaction stays valid after a
  rollback and is not snapshotted.
- Any exception — including injected :mod:`~dccrg_tpu_torch.faults`
  faults — restores every snapshotted attribute and re-raises as
  :class:`MutationAbortedError` with the original failure as
  ``__cause__``. The grid is then bit for bit its pre-mutation state
  (``grid_state_bytes``) and the same mutation can be retried: the
  request sets were part of the snapshot.
- On a successful commit, when ``DCCRG_DEBUG=1`` (or
  ``validate=True``), ``verify_all`` runs against the NEW state; a
  broken invariant rolls back too and raises
  :class:`GridInvariantError` naming the offending cells.

Transactions are reentrant: the composite ``balance_load`` opens one
transaction and its three stages join it, so a fault anywhere inside
rolls back the whole balance.

Only host state is snapshotted, by reference or as a one-level copy; no
field payload is copied, so a transaction costs O(#dict entries), not
O(data). The reference relies on jax arrays being immutable. Torch
tensors are not, so the grid keeps the snapshot's field tensors intact
itself: the mutation paths install new tensors (the commit's and the
balance's row moves gather into fresh ones, and the balance lands its
staged rows in those), and every in-place writer of ``Grid``
(``set_many``, the halo exchange's receives, the balance's landing)
first clones a field tensor that the open transaction's snapshot holds
(``Grid._own``, keyed by ``_txn_frozen``).
"""

from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager

from . import faults as faults_mod
from . import verify as verify_mod


class MutationError(RuntimeError):
    """Base of the mutation-boundary error hierarchy. ``cells`` names
    the offending cell ids when known (empty tuple otherwise)."""

    def __init__(self, msg: str, cells=()):
        self.cells = tuple(int(c) for c in cells)
        super().__init__(msg + verify_mod.format_cells(self.cells))


class MutationAbortedError(MutationError):
    """A structural mutation failed mid-flight and the grid was rolled
    back to its pre-mutation state. ``op`` names the mutation, the
    original failure is ``__cause__``; the pending requests survived
    the rollback, so the same mutation can be retried."""

    def __init__(self, op: str, cause: BaseException, cells=()):
        self.op = op
        super().__init__(
            f"{op} aborted, grid rolled back "
            f"({type(cause).__name__}: {cause})", cells=cells)


class GridInvariantError(MutationError):
    """Post-commit validation found a broken grid invariant; the
    commit was rolled back. The underlying
    :class:`~dccrg_tpu_torch.verify.VerificationError` is ``__cause__``."""

    def __init__(self, op: str, cause: BaseException, cells=()):
        self.op = op
        super().__init__(
            f"{op} violated a grid invariant, commit rolled back "
            f"({cause})", cells=cells)


class CrossRankAbortedError(MutationAbortedError):
    """A distributed structural mutation aborted on this rank. The local
    half is the inherited contract: the grid — request sets included —
    is bit for bit its pre-mutation state and the mutation can be
    retried. The distributed half happened by the time this propagates:
    the abort was announced to every peer (``on_abort``), so the whole
    group rolls back together. ``rank`` names the aborting rank."""

    def __init__(self, op: str, cause: BaseException, rank: int = -1,
                 cells=()):
        self.rank = int(rank)
        super().__init__(op, cause, cells=cells)


@contextmanager
def cross_rank_transaction(grid, op: str = "distributed_mutation", *,
                           rank: int = -1, on_abort=None, validate=None):
    """:func:`grid_transaction` plus distributed rollback: any failure
    rolls this rank back bit for bit (inherited) and then calls
    ``on_abort(error)``, where a distributed commit announces the abort
    to its peers. Re-raises as :class:`CrossRankAbortedError`.

    Two failure classes bypass the announcement: an
    :class:`~dccrg_tpu_torch.faults.InjectedRankDeath` (a killed process
    posts nothing; its peers must convict it by lease or timeout) and
    ``BaseException`` (interpreter teardown)."""
    try:
        with grid_transaction(grid, op=op, validate=validate):
            yield
    except MutationError as e:
        if on_abort is not None:
            try:
                on_abort(e)
            except Exception:  # noqa: BLE001 - announcing is best-effort
                pass
        if isinstance(e, CrossRankAbortedError):
            raise
        cause = e.__cause__ if e.__cause__ is not None else e
        raise CrossRankAbortedError(
            op, cause, rank=rank, cells=e.cells) from cause


_MISSING = object()

# Attributes whose values the mutation paths REPLACE wholesale (restore
# = re-assign the old reference).
_REF_ATTRS = (
    "plan",
    "_pending_owner",
    "_cells_epoch",
    "_cut_edges",
    "_removed_cells",
    "_new_cells",
    "_unrefined_parents",
)

# Dict attributes mutated in place — item assignment, or clear+update
# (``_hybrid_reuse``); snapshot = one-level copy. Values are never
# edited in place (field tensors are guarded by Grid._own, numpy arrays
# and tuples are rebuilt).
_DICT_ATTRS = (
    "data",
    "_removed_data",
    "_staged_balance",
    "_pins",
    "_weights",
    "_cap_memo",
    "_balance_added",
    "_balance_removed",
    "_cell_item_values",
    "_neighbor_item_values",
    "_hybrid_reuse",
    "_pending",
)

# Set attributes: the AMR request queues the commit clears.
_SET_ATTRS = ("_refines", "_unrefines", "_dont_refines", "_dont_unrefines")


def snapshot_state(grid) -> dict:
    """Capture the minimal mutable structural state (see the module
    docstring). O(host dict and set sizes); no device data is copied."""
    snap = {}
    for name in _REF_ATTRS:
        snap[name] = getattr(grid, name, _MISSING)
    for name in _DICT_ATTRS:
        val = getattr(grid, name, _MISSING)
        snap[name] = dict(val) if isinstance(val, dict) else val
    for name in _SET_ATTRS:
        val = getattr(grid, name, _MISSING)
        snap[name] = set(val) if isinstance(val, set) else val
    return snap


def restore_state(grid, snap: dict) -> None:
    """Reinstall a :func:`snapshot_state` capture. Dict and set
    attributes get fresh copies, so a snapshot can restore more than
    once."""
    for name in _REF_ATTRS:
        _put(grid, name, snap[name])
    for name in _DICT_ATTRS:
        val = snap[name]
        _put(grid, name, dict(val) if isinstance(val, dict) else val)
    for name in _SET_ATTRS:
        val = snap[name]
        _put(grid, name, set(val) if isinstance(val, set) else val)


def _put(grid, name, val):
    if val is _MISSING:
        if hasattr(grid, name):
            delattr(grid, name)
    else:
        setattr(grid, name, val)


def _discard_bg(grid) -> None:
    """Rollback hook: drop a background plan build submitted inside the
    aborted transaction (a build pending at entry was installed by the
    entry barrier). Waits for the worker to stop touching the arena and
    the build caches before the snapshot restores them."""
    if getattr(grid, "_bg_build", None) is not None:
        grid.bg_discard()


@contextmanager
def grid_transaction(grid, op: str = "mutation", validate=None):
    """Run a structural mutation atomically (see the module docstring).

    ``validate=None`` validates post-commit iff the grid runs in debug
    mode (``DCCRG_DEBUG=1``); ``True``/``False`` force it. Reentrant: a
    transaction opened while another is active on the same grid joins
    it — rollback and validation belong to the outermost one."""
    if getattr(grid, "_txn_depth", 0):
        grid._txn_depth += 1
        try:
            yield
        finally:
            grid._txn_depth -= 1
        return

    # background-recommit barrier (DCCRG_BG_RECOMMIT): a pending
    # background build installs before the snapshot, so the mutation
    # sees (and a rollback restores) the final structure epoch and no
    # worker writes arena tables while this mutation rebuilds them. The
    # install runs in its own, completed, transaction.
    if getattr(grid, "_bg_build", None) is not None:
        grid.bg_install(wait=True)

    snap = snapshot_state(grid)
    grid._txn_depth = 1
    # the rollback target plan: the hybrid builder's PlanArena keeps its
    # table buffers protected for the transaction's duration, so a
    # failed rebuild can never scribble on tables a rollback restores
    snap_plan = snap.get("plan")
    grid._txn_plan = None if snap_plan is _MISSING else snap_plan
    # the snapshot's field tensors: in-place writers clone these first
    data = snap.get("data")
    grid._txn_frozen = ({id(t) for t in data.values()}
                        if isinstance(data, dict) else set())
    try:
        try:
            yield
        except Exception as e:
            _discard_bg(grid)
            restore_state(grid, snap)
            if isinstance(e, faults_mod.InjectedRankDeath):
                # a simulated kill -9 keeps its type: peers key their
                # recovery on the death, not on an abort it never
                # announced; the rollback above still runs
                raise
            raise MutationAbortedError(
                op, e, cells=tuple(getattr(e, "cells", ()) or ())) from e
        except BaseException:
            # KeyboardInterrupt & co.: leave a consistent grid, re-raise
            # untouched
            _discard_bg(grid)
            restore_state(grid, snap)
            raise
        check = (getattr(grid, "_debug", False)
                 if validate is None else validate)
        if check:
            try:
                # pins are requests until a balance applies them; the
                # balance paths check placement in their own debug hook
                verify_mod.verify_all(grid, check_pins=False)
            except Exception as e:
                # a VerificationError is a diagnosed invariant break; a
                # verifier crashing on malformed state is the same
                # verdict with less detail: either way, roll back
                _discard_bg(grid)
                restore_state(grid, snap)
                raise GridInvariantError(
                    op, e, cells=getattr(e, "cells", ())) from e
    finally:
        grid._txn_depth = 0
        grid._txn_plan = None
        grid._txn_frozen = None


def grid_state_bytes(grid, header: bytes = b"") -> bytes:
    """The grid's exact ``.dc`` checkpoint bytes (structure metadata and
    every field payload): the fingerprint the atomicity tests compare
    to hold a rolled-back mutation to its pre-mutation state bit for
    bit. Written through a temporary file of ``tempfile``'s directory."""
    fd, path = tempfile.mkstemp(suffix=".dc", prefix="dccrg_txn_")
    os.close(fd)
    try:
        grid.save_grid_data(path, header)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)
