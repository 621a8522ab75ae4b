"""Background work taken off the step loop: the AMR recommit's plan
build and the checkpoint write.

Port of ``dccrg_tpu/background.py``. Two host-side pauses sit on the
serving path:

- an AMR recommit (the plan rebuild after ``stop_refining``) blocks the
  step loop for its whole build, although the build is host work that
  depends only on the new (cells, owner) structure, never on the field
  bytes the loop keeps advancing;
- a checkpoint save serializes the CRC, fsync and rename work against
  the next steps, although the payload is fixed the moment it is
  copied.

:class:`PlanBuildWorker` (``DCCRG_BG_RECOMMIT=1``) builds the next
structure epoch's plan on a worker thread against a third
:class:`~dccrg_tpu_torch.hybrid.PlanArena` generation (the live plan and
a transaction's rollback plan stay protected) while stepping continues
on the live plan; ``Grid.run_steps`` and ``GridBatch.step`` install the
finished plan at the next step or quantum boundary
(``Grid.bg_install``), bit for bit the synchronous build's plan. The
worker builds host tables only and launches nothing on the card: every
upload, and the move of the field data, happens at the install, on the
thread that owns the grid.

:class:`AsyncSaver` (``DCCRG_ASYNC_SAVE=1``) runs a checkpoint write on
a writer thread against a :func:`freeze_grid` snapshot, whose field
bytes were copied to the host on the caller's thread; :meth:`drain` is
the barrier every reader of the written files takes.
"""

from __future__ import annotations

import copy
import os
import threading
import time

import numpy as np
import torch

from . import telemetry


def bg_recommit_enabled() -> bool:
    """``DCCRG_BG_RECOMMIT=1``: defer AMR recommits to a background
    plan-build worker, swapping at the next step/quantum boundary."""
    return os.environ.get("DCCRG_BG_RECOMMIT") == "1"


def async_save_enabled() -> bool:
    """``DCCRG_ASYNC_SAVE=1``: overlap checkpoint writes with the next
    steps."""
    return os.environ.get("DCCRG_ASYNC_SAVE") == "1"


# ---------------------------------------------------------------------
# background plan builds
# ---------------------------------------------------------------------

class PlanBuildWorker:
    """One in-flight background structure-plan build for a grid.

    The worker runs ``grid._construct_plan`` (the pure build half of a
    restructure, no install) on a daemon thread. The build reads only
    the structural inputs captured at submit time plus the grid's build
    caches (the capacity memo, the hybrid stream-reuse cache, the plan
    arena), none of which the step loop touches; the arena is
    lock-protected because the live plan's lazy table thunks may take
    buffers concurrently. At most one build is in flight per grid, so
    the caches see the same ordered build sequence as the synchronous
    path and the plan is bit for bit the synchronous one.

    A worker failure (any exception, injected faults included) is kept,
    not raised: the swap point falls back to the inline rebuild, as it
    does when the worker left no plan."""

    def __init__(self, grid, cells, owner, changed_hint):
        self.cells = cells
        self.owner = owner
        self.changed_hint = changed_hint
        self.plan = None
        self.error = None
        self.seconds = None  # the build's wall time, on the worker
        self.done = threading.Event()
        self._grid = grid
        self.thread = threading.Thread(
            target=self._work, name="dccrg-bg-recommit", daemon=True)

    def start(self) -> "PlanBuildWorker":
        telemetry.inc("dccrg_recommit_bg_builds_total")
        self.thread.start()
        return self

    def _work(self) -> None:
        grid = self._grid
        arena = grid._plan_arena
        t0 = time.perf_counter()
        try:
            # fresh arena allocations fault their pages in on the
            # worker, so a grown table's first touch never lands on the
            # step loop at the swap
            if arena is not None:
                arena.prefault = True
            self.plan = grid._construct_plan(
                self.cells, self.owner, self.changed_hint)
            # the host tables the first post-swap step would derive
            grid._prewarm_plan(self.plan)
        except Exception as e:  # noqa: BLE001 - surfaced at the swap
            self.error = e
            telemetry.inc("dccrg_recommit_bg_errors_total")
        finally:
            if arena is not None:
                arena.prefault = False
            self.seconds = time.perf_counter() - t0
            telemetry.record_span("recommit.bg", self.seconds)
            telemetry.observe("dccrg_recommit_bg_build_seconds", self.seconds)
            self.done.set()

    def ready(self) -> bool:
        return self.done.is_set()

    def wait(self, timeout=None) -> bool:
        """Block until the build finishes; the blocked time is the step
        loop's residual stall and lands in the stall histogram."""
        if not self.done.is_set():
            t0 = time.perf_counter()
            self.done.wait(timeout)
            telemetry.observe("dccrg_recommit_stall_seconds",
                              time.perf_counter() - t0)
        return self.done.is_set()


# ---------------------------------------------------------------------
# async checkpoint writes
# ---------------------------------------------------------------------

def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor holding ``t``'s bytes that no later write to ``t``
    reaches: on the CPU ``t.numpy()`` would alias the live tensor, and
    ``set`` and the halo receives write in place."""
    return t.detach().to("cpu", copy=True)


def freeze_grid(grid, fields=None):
    """A fixed snapshot of ``grid`` for a background checkpoint writer:
    a shallow copy whose field tensors are copied to the host here, on
    the caller's thread (the save's one synchronization point with the
    card); the writer then does host and file work only and launches
    nothing. Plans are replaced wholesale, and mapping, topology,
    geometry and fields never change after ``initialize``, so everything
    else is shared; the writer serializes exactly the bytes a
    synchronous save at the freeze point would write. ``fields``
    restricts the copy to a save's sub-schema.

    A hybrid plan's ``row_of_pos`` is a view into the plan arena: once
    the live grid restructures twice the frozen plan is in no protect
    set and its buffers recycle under the writer, so the one layout
    array a save reads is pinned with a private copy."""
    snap = copy.copy(grid)
    names = sorted(grid.data) if fields is None else sorted(fields)
    snap.data = {n: _host_copy(grid.data[n]) for n in names}
    snap.device = torch.device("cpu")
    snap.devices = [snap.device] * grid.n_dev
    snap.plan = copy.copy(grid.plan)
    snap.plan.row_of_pos = np.array(grid.plan.row_of_pos, copy=True)
    # the dirty set travels with the snapshot (a private copy), so a
    # delta save through the frozen grid sees the live grid's set
    dirty = getattr(grid, "_ckpt_dirty", None)
    snap._ckpt_dirty = set(dirty) if isinstance(dirty, set) else dirty
    # the snapshot never aliases live background machinery: a save of
    # the frozen copy may not drain or install the real grid's builds
    snap._bg_build = None
    return snap


class AsyncSaver:
    """At most one checkpoint write in flight, with a drain barrier.

    ``submit(fn)`` drains any previous write (surfacing its failure at
    this save boundary, as a synchronous save would raise in place),
    then runs ``fn`` on a fresh daemon thread under a ``ckpt.async``
    span. ``drain()`` joins the writer and re-raises its exception after
    calling the submitter's ``on_fail`` hooks. The time a drain blocks
    is the checkpoint stall the overlap did not hide, in
    ``dccrg_ckpt_stall_seconds``."""

    def __init__(self):
        self._thread = None
        self._box = None
        self.last_write_seconds = None  # the last write's wall, on the writer

    def submit(self, fn, on_fail=None, label="") -> None:
        self.drain()
        telemetry.inc("dccrg_ckpt_async_saves_total")
        box = {"error": None, "label": label,
               "on_fail": [on_fail] if on_fail is not None else []}

        def work():
            t0 = time.perf_counter()
            try:
                with telemetry.span("ckpt.async", tags={"path": label}):
                    fn()
            except BaseException as e:  # noqa: BLE001 - rethrown at drain
                box["error"] = e
            finally:
                self.last_write_seconds = time.perf_counter() - t0
                telemetry.observe("dccrg_ckpt_async_write_seconds",
                                  self.last_write_seconds)

        t = threading.Thread(target=work, name="dccrg-async-save",
                             daemon=True)
        self._thread, self._box = t, box
        t.start()

    def add_on_fail(self, cb) -> None:
        """Chain another failure hook onto the in-flight write (no-op
        when nothing is pending)."""
        if self._box is not None:
            self._box["on_fail"].append(cb)

    def pending(self) -> bool:
        return self._thread is not None

    def drain(self) -> None:
        """The readers' barrier: returns once no write is in flight,
        re-raising a captured writer failure after its ``on_fail``
        hooks ran, oldest first. From the writer thread itself it is a
        no-op (that work is already ordered after the write)."""
        t, box = self._thread, self._box
        if t is None or t is threading.current_thread():
            return
        t0 = time.perf_counter()
        t.join()
        stall = time.perf_counter() - t0
        if stall > 0:
            telemetry.observe("dccrg_ckpt_stall_seconds", stall)
        self._thread = self._box = None
        err = box["error"]
        if err is not None:
            telemetry.inc("dccrg_ckpt_async_errors_total")
            for cb in box["on_fail"]:
                cb(err)
            raise err


# ---------------------------------------------------------------------
# background preparation sweeps
# ---------------------------------------------------------------------

class PrewarmWorker:
    """One abortable background preparation sweep, with the discipline
    of :class:`PlanBuildWorker`: a daemon thread whose failure is kept
    on :attr:`error`, never raised into the serving path. ``fn(abort)``
    must only prepare (build host tables, compile kernels) and launch
    nothing on the serving stream; it checks ``abort`` between items.
    :meth:`stop` sets it and joins, so a teardown has a bounded
    wait."""

    def __init__(self, fn, name: str = "dccrg-warm-prewarm"):
        self.fn = fn
        self.error = None
        self.done = threading.Event()
        self.abort = threading.Event()
        self.thread = threading.Thread(target=self._work, name=name,
                                       daemon=True)

    def start(self) -> "PrewarmWorker":
        self.thread.start()
        return self

    def _work(self) -> None:
        t0 = time.perf_counter()
        try:
            self.fn(self.abort)
        except Exception as e:  # noqa: BLE001 - surfaced via .error
            self.error = e
            telemetry.inc("dccrg_prewarm_errors_total")
        finally:
            telemetry.observe("dccrg_prewarm_seconds",
                              time.perf_counter() - t0)
            self.done.set()

    def ready(self) -> bool:
        return self.done.is_set()

    def wait(self, timeout=None) -> bool:
        self.done.wait(timeout)
        return self.done.is_set()

    def stop(self, timeout=5.0) -> bool:
        """Abort and join (bounded). Returns whether the thread
        finished; a straggler is left to die with the process."""
        self.abort.set()
        return self.wait(timeout)
