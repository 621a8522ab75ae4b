"""Seeded stateful fuzzing of structural grid mutations.

Property-based testing of the *stateful* Grid API (the discipline
Hypothesis calls rule-based state machines): a deterministic seeded
loop applies random op sequences — refine/unrefine at random
coordinates, load balances with random curves, checkpoint save/load
round trips, halo exchanges, fused step loops, host writes, structure
queries — and after EVERY op checks

1. every grid invariant (:func:`dccrg_tpu_torch.verify.verify_all`), and
2. a slow pure-numpy **oracle**: an independent ``{cell id: value}``
   mirror of the cell data, advanced with plain numpy (projection on
   refine/unrefine, neighbor-sum steps recomputed through the numpy
   reference engine), plus brute-force cross-checks of the structure
   queries (``get_existing_cell`` resolved by scanning every cell's
   index box; per-cell neighbor lists recomputed from scratch).

With ``fault_rate > 0`` the fuzzer also injects a
:class:`~dccrg_tpu_torch.faults.FaultPlan` mutation fault at a random fault
point before some mutations and asserts the transactional guarantee:
the grid is bitwise either fully rolled back (checkpoint-bytes
identical to the pre-op snapshot) or fully committed, and the retried
mutation succeeds.

Failures raise :class:`FuzzFailure` carrying the seed, op index, the
recent op log and the offending cell ids — everything needed to
replay: two runs with the same seed and config perform the identical
op sequence.

The grid lives on ``n_dev`` partitions of one device: the card unless
the caller passes ``devices`` (``"cpu"`` in the tests). The op trail is
the reference's: for a seed, the same ``default_rng`` draws in the same
order over the same cell lists.

CLI::

    python -m dccrg_tpu_torch.fuzz --seed 0 --ops 200 [--fault-rate 0.3]
    python -m dccrg_tpu_torch.fuzz --seeds 25 --ops 40     # the CI sweep
    python -m dccrg_tpu_torch.fuzz --fleet 4     # on kernel A'
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from . import txn
from .convert import _to_numpy
from .faults import MUTATION_FAULT_SITES, FaultPlan
from .grid import DEFAULT_NEIGHBORHOOD_ID, Grid
from .neighbors import _dedup_entries, _find_neighbors_of_numpy
from .txn import MutationAbortedError, MutationError
from .verify import VerificationError, format_cells, verify_all


class FuzzFailure(AssertionError):
    """An invariant or oracle cross-check failed during a fuzz run."""

    def __init__(self, msg, seed=None, op_index=None, cells=(), log=()):
        self.seed = seed
        self.op_index = op_index
        self.cells = tuple(int(c) for c in cells)
        msg = (f"seed {seed} op {op_index}: {msg}"
               + format_cells(self.cells))
        if log:
            msg += f" (recent ops: {'; '.join(list(log)[-6:])})"
        super().__init__(msg)


def _step_kernel(cell, nbr, offs, mask, *extra):
    """Neighbor-averaging diffusion step, mirrored exactly by the
    oracle: 0.5*self + 0.5*mean(neighbor entries), in the reference's
    float32 order."""
    cnt = torch.clamp_min(mask.sum(dim=1), 1).to(torch.float32)
    s = torch.where(mask, nbr["rho"],
                    torch.zeros((), dtype=torch.float32)).sum(dim=1)
    return {"rho": 0.5 * cell["rho"] + 0.5 * s / cnt}


# fault points reachable from each mutation kind — the canonical
# table lives next to the fire() sites (faults.py)
_FAULT_SITES = MUTATION_FAULT_SITES


def _partitions(devices, n_dev):
    """The grid's partition list: ``devices`` cut to ``n_dev`` entries
    when it is a list, else ``n_dev`` partitions of that one device
    (the card when None). Every partition lives on one device."""
    if isinstance(devices, (list, tuple)):
        return list(devices)[:max(1, int(n_dev))]
    return [devices if devices is not None else "cuda"] * max(1, int(n_dev))


def _np_dtype(dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


class GridFuzzer:
    """One deterministic fuzz run (see module docstring).

    ``GridFuzzer(seed, ops=40).run()`` raises :class:`FuzzFailure` on
    the first violated property; attributes afterwards:
    ``ops_run``, ``faults_injected``, ``log`` (op trail).
    """

    # op weights: mutations dominate (they are what the harness hunts)
    _OPS = ("refine", "unrefine", "balance", "set", "step",
            "exchange", "checkpoint", "query")
    _WEIGHTS = (0.20, 0.15, 0.13, 0.13, 0.13, 0.10, 0.08, 0.08)
    _BALANCE_METHODS = ("morton", "hilbert", "rcb", "block")

    def __init__(self, seed, *, ops=40, length=(4, 4, 2), max_lvl=1,
                 n_dev=2, fault_rate=0.0, devices=None, schema="scalar"):
        self.seed = int(seed)
        self.n_ops = int(ops)
        self.rng = np.random.default_rng(self.seed)
        self.fault_rate = float(fault_rate)
        self.devices = _partitions(devices, n_dev)
        # "aux" is a static payload the ops never write: with it in
        # the schema the dirty set {rho} is a proper subset, so the
        # incremental-checkpoint oracle exercises REAL delta saves
        # (a single-field grid would keyframe every time).
        # schema="mhd" swaps in the model zoo's 8-field MHD schema
        # (rho stays the op target), so every mutation/txn/fault site
        # — refine projection, balance moves, delta chains, rollback
        # snapshots — runs over the new models' multi-field state,
        # and the multi-field exchange op gets proper field subsets
        # with genuinely different payloads
        if schema == "mhd":
            from .models.mhd import mhd_cell_data

            cell_data = dict(mhd_cell_data(torch.float32))
            cell_data["aux"] = ((2,), torch.float32)
        elif schema == "scalar":
            cell_data = {"rho": torch.float32, "aux": ((2,), torch.float32)}
        else:
            raise ValueError(f"unknown fuzz schema {schema!r}")
        self.schema = schema
        self.grid = (
            Grid(cell_data=cell_data)
            .set_initial_length(length)
            .set_maximum_refinement_level(int(max_lvl))
            .set_periodic(True, True, True)
            .set_neighborhood_length(1)
            .set_geometry("cartesian", start=(0.0, 0.0, 0.0),
                          level_0_cell_length=(1.0, 1.0, 1.0))
            .initialize(self.devices)
        )
        cells = self.grid.get_cells()
        vals = self.rng.random(len(cells)).astype(np.float32)
        self.grid.set("rho", cells, vals)
        for name in sorted(self.grid.fields):
            if name == "rho":
                continue
            shape, fdt = self.grid.fields[name]
            self.grid.set(name, cells, self.rng.random(
                (len(cells),) + shape).astype(_np_dtype(fdt)))
        # the oracle: independent host mirror of every cell's value
        self.oracle = {int(c): np.float32(v) for c, v in zip(cells, vals)}
        self.log = []
        self.ops_run = 0
        self.faults_injected = 0
        # incremental-checkpoint oracle state (lazy CheckpointStore)
        self._store = None
        self._store_step = 0

    # -- the run loop -------------------------------------------------

    def run(self) -> "GridFuzzer":
        import shutil

        try:
            self._check(0)
            for i in range(1, self.n_ops + 1):
                name = str(self.rng.choice(self._OPS, p=self._WEIGHTS))
                try:
                    detail = getattr(self, "_op_" + name)()
                except FuzzFailure:
                    raise
                except MutationError as e:
                    raise FuzzFailure(
                        f"unexpected mutation failure in {name}: {e}",
                        seed=self.seed, op_index=i,
                        cells=getattr(e, "cells", ()), log=self.log) from e
                self.log.append(f"{i}:{name}"
                                + (f"({detail})" if detail else ""))
                self.ops_run = i
                self._check(i)
        finally:
            if self._store is not None:
                shutil.rmtree(self._store.dir, ignore_errors=True)
        return self

    def _check(self, i):
        """Invariants + oracle sweep after every op."""
        try:
            verify_all(self.grid, check_pins=False)
        except VerificationError as e:
            raise FuzzFailure(
                f"invariant violated: {e}", seed=self.seed, op_index=i,
                cells=getattr(e, "cells", ()), log=self.log) from e
        cells = self.grid.get_cells()
        if set(map(int, cells)) != set(self.oracle):
            odd = set(map(int, cells)) ^ set(self.oracle)
            raise FuzzFailure(
                "grid cell set diverged from the oracle",
                seed=self.seed, op_index=i, cells=sorted(odd)[:16],
                log=self.log)
        got = np.asarray(self.grid.get("rho", cells), dtype=np.float32)
        want = np.array([self.oracle[int(c)] for c in cells],
                        dtype=np.float32)
        close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
        if not close.all():
            raise FuzzFailure(
                f"cell data diverged from the oracle "
                f"(max err {np.abs(got - want).max():.3e})",
                seed=self.seed, op_index=i,
                cells=np.asarray(cells)[~close][:16], log=self.log)
        # re-sync: keep sub-tolerance float drift from accumulating
        for c, v in zip(cells, got):
            self.oracle[int(c)] = np.float32(v)

    # -- mutations (transactional, optionally fault-injected) ---------

    def _guarded(self, kind, commit):
        """Run a mutation to COMMITTED state. With probability
        ``fault_rate`` a mutation fault is injected first; the abort
        must leave the grid bitwise identical to the pre-op snapshot,
        and the retry must succeed."""
        if self.fault_rate and self.rng.random() < self.fault_rate:
            sites = _FAULT_SITES[kind]
            site, phase = sites[int(self.rng.integers(len(sites)))]
            before = txn.grid_state_bytes(self.grid)
            plan = FaultPlan(seed=int(self.rng.integers(1 << 31)))
            plan.mutation_error(site=site, times=1, phase=phase)
            aborted = False
            try:
                with plan:
                    result = commit()
            except MutationAbortedError:
                aborted = True
            if not aborted:
                # the chosen site was not on this op's path (e.g. the
                # hybrid plan build on a still-uniform grid): committed
                return result, f"fault:{site}:unreached"
            self.faults_injected += 1
            after = txn.grid_state_bytes(self.grid)
            if after != before:
                raise FuzzFailure(
                    f"rollback after injected {site}/{phase} fault is "
                    f"not bitwise identical", seed=self.seed,
                    op_index=self.ops_run + 1, log=self.log)
            return commit(), f"fault:{site}:rolled-back"
        return commit(), ""

    def _commit_adapt(self):
        """stop_refining + data projection, mirrored in the oracle."""
        g = self.grid
        new, detail = self._guarded("adapt", g.stop_refining)
        g.assign_children_from_parents()
        g.average_parents_from_children()
        removed = g.get_removed_cells()
        if len(new):
            parents = g.mapping.get_parent(new)
            for c, p in zip(new, parents):
                self.oracle[int(c)] = self.oracle[int(p)]
            for p in np.unique(parents):
                self.oracle.pop(int(p), None)
        up = g._unrefined_parents
        if len(up):
            kids = g.mapping.get_all_children(up)  # [n, 8]
            means = {
                int(p): np.float32(np.mean(
                    [self.oracle[int(k)] for k in ks], dtype=np.float32))
                for p, ks in zip(up, kids)
            }
            for k in removed:
                self.oracle.pop(int(k), None)
            self.oracle.update(means)
        g.clear_refined_unrefined_data()
        return len(new), len(removed), detail

    def _op_refine(self):
        cells = self.grid.get_cells()
        cid = int(cells[self.rng.integers(len(cells))])
        if not self.grid.refine_completely(cid):
            return f"{cid}:at-max-level"
        n_new, _n_rm, detail = self._commit_adapt()
        return f"{cid}:+{n_new}" + (f":{detail}" if detail else "")

    def _op_unrefine(self):
        g = self.grid
        cells = g.get_cells()
        lvls = g.mapping.get_refinement_level(cells)
        fine = np.asarray(cells)[lvls > 0]
        if len(fine) == 0:
            return "no-fine-cells"
        cid = int(fine[self.rng.integers(len(fine))])
        if not g.unrefine_completely(cid):
            return f"{cid}:rejected"
        _n_new, n_rm, detail = self._commit_adapt()
        return f"{cid}:-{n_rm}" + (f":{detail}" if detail else "")

    def _op_balance(self):
        method = str(self.rng.choice(self._BALANCE_METHODS))
        self.grid.set_load_balancing_method(method)
        _res, detail = self._guarded("balance", self.grid.balance_load)
        return method + (f":{detail}" if detail else "")

    # -- data ops ------------------------------------------------------

    def _op_set(self):
        cells = np.asarray(self.grid.get_cells())
        k = int(self.rng.integers(1, max(2, len(cells) // 2)))
        pick = self.rng.choice(len(cells), size=k, replace=False)
        vals = self.rng.random(k).astype(np.float32)
        self.grid.set("rho", cells[pick], vals)
        for c, v in zip(cells[pick], vals):
            self.oracle[int(c)] = np.float32(v)
        return f"{k} cells"

    def _op_step(self):
        """One fused exchange+stencil step; the oracle advances through
        the numpy reference engine over the SAME dedup'd entry stream
        the gather tables were built from."""
        g = self.grid
        cells = g.plan.cells
        vals = np.array([self.oracle[int(c)] for c in cells],
                        dtype=np.float32)
        src, nbr, _off, _item = _dedup_entries(
            g.mapping, cells, *_find_neighbors_of_numpy(
                g.mapping, g.topology, cells, cells,
                g.neighborhoods[DEFAULT_NEIGHBORHOOD_ID]))
        acc = np.zeros(len(cells), dtype=np.float32)
        cnt = np.zeros(len(cells), dtype=np.float32)
        np.add.at(acc, src, vals[np.searchsorted(cells, nbr)])
        np.add.at(cnt, src, np.float32(1))
        expected = (np.float32(0.5) * vals
                    + np.float32(0.5) * acc / np.maximum(cnt, 1))
        g.run_steps(_step_kernel, ["rho"], ["rho"], 1)
        for c, v in zip(cells, expected):
            self.oracle[int(c)] = np.float32(v)
        return ""

    def _op_exchange(self):
        """Halo exchange over a RANDOM field subset (the per-field
        ``fields=`` boundary) vs the pure-numpy ghost oracle: every
        exchanged field's ghost rows must hold the owner's bytes
        (bitwise — the exchange is a copy), ``rho`` additionally
        checks against the value oracle, and every field NOT in the
        subset must keep its pre-exchange bytes bitwise (a fused
        multi-field program must never move an unrequested field)."""
        g = self.grid
        names = sorted(g.fields)
        if len(names) > 1 and self.rng.random() < 0.6:
            k = int(self.rng.integers(1, len(names)))
            pick = sorted(str(n) for n in self.rng.choice(
                names, size=k, replace=False))
        else:
            pick = names
        frozen = {n: _to_numpy(g.data[n]).tobytes()
                  for n in names if n not in pick}
        g.update_copies_of_remote_neighbors(fields=pick)
        L = g.plan.L
        for n in pick:
            host = _to_numpy(g.data[n])
            for d in range(g.n_dev):
                gids = g.plan.ghost_ids[d]
                if not len(gids):
                    continue
                want = np.asarray(g.get(n, gids))  # the owners' bytes
                got = host[d, L:L + len(gids)]
                if got.tobytes() != want.tobytes():
                    bad = (got != want).reshape(len(gids), -1).any(axis=1)
                    raise FuzzFailure(
                        f"ghost rows of field {n!r} on device {d} are "
                        f"not the owner's bytes after exchange "
                        f"(fields={pick})", seed=self.seed,
                        op_index=self.ops_run + 1,
                        cells=np.asarray(gids)[bad][:16], log=self.log)
            if n != "rho":
                continue
            for d in range(g.n_dev):
                gids = g.plan.ghost_ids[d]
                if not len(gids):
                    continue
                want = np.array([self.oracle[int(c)] for c in gids],
                                dtype=np.float32)
                got = host[d, L:L + len(gids)]
                close = np.isclose(got, want, rtol=1e-4, atol=1e-5)
                if not close.all():
                    raise FuzzFailure(
                        f"ghost rows on device {d} diverged after "
                        f"exchange", seed=self.seed,
                        op_index=self.ops_run + 1,
                        cells=gids[~close][:16], log=self.log)
        for n, before in frozen.items():
            if _to_numpy(g.data[n]).tobytes() != before:
                raise FuzzFailure(
                    f"field {n!r} changed bytes though the exchange "
                    f"moved only {pick}", seed=self.seed,
                    op_index=self.ops_run + 1, log=self.log)
        return ",".join(pick) if pick != names else "all"

    def _op_checkpoint(self):
        """Save/load round trip into the live grid — bytes must be
        stable across an immediate re-save — plus the incremental-save
        oracle: a dirty-field delta chain materialized back must be
        BITWISE identical to a direct full save, whatever random ops
        (host writes and steps dirty fields; mutations bump the
        structure epoch and force keyframes) came in between."""
        g = self.grid
        delta_detail = self._delta_oracle()
        if self.rng.random() < 0.5:
            # the load half of the round trip conservatively dirties
            # every field (correct production behavior), which forces
            # the NEXT oracle save to a keyframe — run it on half the
            # visits so the other half leaves delta-able windows
            return f"delta-only:{delta_detail}"
        fd, path = tempfile.mkstemp(suffix=".dc", prefix="dccrg_fuzz_")
        os.close(fd)
        try:
            g.save_grid_data(path)
            with open(path, "rb") as f:
                first = f.read()
            g.load_grid_data(path)
            g.save_grid_data(path)
            with open(path, "rb") as f:
                second = f.read()
        finally:
            os.unlink(path)
        if first != second:
            raise FuzzFailure(
                "checkpoint round trip is not byte-stable",
                seed=self.seed, op_index=self.ops_run + 1, log=self.log)
        return f"{len(first)}B:{delta_detail}"

    def _delta_oracle(self) -> str:
        """Two periodic CheckpointStore saves and their oracle: the
        reconstructed chain bytes must equal a direct full save. The
        first save lands as whatever the dirty/epoch state dictates
        (usually a keyframe — most op windows contain a structural
        mutation); a random rho write in between makes the second a
        REAL delta window, so every visit pins the delta machinery."""
        kinds = [self._one_store_save()]
        cells = np.asarray(self.grid.get_cells())
        k = int(self.rng.integers(1, max(2, len(cells) // 3)))
        pick = self.rng.choice(len(cells), size=k, replace=False)
        vals = self.rng.random(k).astype(np.float32)
        self.grid.set("rho", cells[pick], vals)
        for c, v in zip(cells[pick], vals):
            self.oracle[int(c)] = np.float32(v)
        kinds.append(self._one_store_save())
        return "+".join(kinds)

    def _one_store_save(self) -> str:
        from . import resilience, supervise

        g = self.grid
        if self._store is None:
            self._store = supervise.CheckpointStore(
                tempfile.mkdtemp(prefix="dccrg_fuzz_store_"),
                keyframe_every=4)
        self._store_step += 1
        path = self._store.save(g, self._store_step)
        kind = ("delta" if path.endswith(resilience.DELTA_SUFFIX)
                else "key")
        fd, ref = tempfile.mkstemp(suffix=".dc", prefix="dccrg_fuzz_ref_")
        os.close(fd)
        out = path + ".chain.oracle"
        try:
            g.save_grid_data(ref)
            src = path
            if kind == "delta":
                resilience.materialize_chain(path, out, g.fields)
                src = out
            with open(ref, "rb") as f:
                want = f.read()
            with open(src, "rb") as f:
                got = f.read()
        finally:
            os.unlink(ref)
            if os.path.exists(out):
                os.unlink(out)
        if got != want:
            raise FuzzFailure(
                f"incremental checkpoint ({kind}) does not reconstruct "
                "the direct full-save bytes", seed=self.seed,
                op_index=self.ops_run + 1, log=self.log)
        return kind

    # -- structure queries vs brute-force oracle ----------------------

    def _op_query(self):
        g = self.grid
        # 1. get_existing_cell vs scanning every cell's index box
        ilen = g.mapping.get_index_length().astype(np.float64)
        scale = float(1 << g.mapping.max_refinement_level)
        coord = tuple(
            (self.rng.integers(int(ilen[d])) + self.rng.uniform(0.15, 0.85))
            / scale
            for d in range(3)
        )
        got = int(g.get_existing_cell(coord))
        want = self._oracle_existing_cell(coord)
        if got != want:
            raise FuzzFailure(
                f"get_existing_cell({coord}) = {got}, oracle says {want}",
                seed=self.seed, op_index=self.ops_run + 1,
                cells=[c for c in (got, want) if c], log=self.log)
        # 2. per-cell neighbor list vs fresh numpy recomputation
        cells = g.plan.cells
        cid = cells[self.rng.integers(len(cells))]
        got_n = {(int(n), o) for n, o in g.get_neighbors_of(int(cid))}
        src, nbr, off, _item = _dedup_entries(
            g.mapping, np.asarray([cid], dtype=np.uint64),
            *_find_neighbors_of_numpy(
                g.mapping, g.topology, cells,
                np.asarray([cid], dtype=np.uint64),
                g.neighborhoods[DEFAULT_NEIGHBORHOOD_ID]))
        want_n = {(int(n), tuple(int(x) for x in o))
                  for n, o in zip(nbr, off)}
        if got_n != want_n:
            odd = {c for c, _o in got_n ^ want_n}
            raise FuzzFailure(
                f"get_neighbors_of({int(cid)}) diverged from the "
                f"numpy oracle", seed=self.seed,
                op_index=self.ops_run + 1, cells=sorted(odd)[:16],
                log=self.log)
        return ""

    def _oracle_existing_cell(self, coordinate) -> int:
        """Brute force: the unique leaf whose index box contains the
        coordinate, by scanning EVERY cell (unit level-0 cells at the
        origin, so physical coordinate * 2^max_lvl = smallest-cell
        index)."""
        g = self.grid
        cells = g.plan.cells
        idx = g.mapping.get_indices(cells).astype(np.int64)
        lvl = g.mapping.get_refinement_level(cells).astype(np.int64)
        size = (1 << (g.mapping.max_refinement_level - lvl))[:, None]
        p = np.asarray(coordinate, dtype=np.float64) * float(
            1 << g.mapping.max_refinement_level)
        inside = ((idx <= p) & (p < idx + size)).all(axis=1)
        hits = cells[inside]
        return int(hits[0]) if len(hits) else 0


# -- fleet-isolation scenario (the fleet layer's oracle) --------------

#: the port's float32 tolerance between kernel A' (the bulk program) and
#: a one-grid-at-a-time run of the same job: ``|a - b| <= atol * peak +
#: rtol * |b|``, ``peak`` the solo state's largest magnitude. The two
#: re-associate the stencil sum differently, and ``advect_x`` at these
#: time steps grows values to several hundred, the gap with them (at
#: most 7.2e-7 of the peak over seeds 0-5 at 8^3 on the CPU)
BULK_TOL = dict(rtol=1e-6, atol=1e-5)


def _within_bulk_tol(got, want) -> bool:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    peak = float(np.abs(want).max()) if want.size else 0.0
    return bool(np.all(np.abs(got - want) <= BULK_TOL["atol"] * peak
                       + BULK_TOL["rtol"] * np.abs(want)))


def _solo_state(job, device) -> dict:
    """The solo run's final owned rows ``{field: [L, ...]}`` (the
    template grid's row order, which a bucket slot shares)."""
    from .fleet import template_grid

    g = template_grid(job, device)
    job.apply_init(g)
    extras = tuple(torch.tensor(p, dtype=torch.float32, device=g.device)
                   for p in job.params)
    if job.n_steps:
        g.run_steps(job.resolved_kernel(), job.fields_in, job.fields_out,
                    job.n_steps, extra_args=extras)
    L = int(g.plan.L)
    return {n: _to_numpy(g.data[n][0, :L]) for n in g.fields}


def fleet_isolation_case(seed: int, jobs: int = 8, n: int = 8,
                         quantum: int = 4, fault: str = "nan",
                         device=None, bulk: bool = True) -> dict:
    """One seeded fleet-isolation scenario: ``jobs`` randomized
    same-shape scenario runs (random kernels, dt, seeds, step counts,
    priorities) are multiplexed through one
    :class:`~dccrg_tpu_torch.scheduler.FleetScheduler` batch on
    ``device`` (the card when None) while a
    :class:`~dccrg_tpu_torch.faults.FaultPlan` corrupts ONE random
    victim job's field at a random step — ``fault="nan"`` poisons it
    with NaN (the numerics-watchdog class), ``fault="flip"`` lands a
    FINITE silent bit-flip (the SDC class, invisible to the finiteness
    watchdog: only the integrity invariants can convict). The oracle is
    the one-grid-at-a-time path: every job — the victim included, whose
    trip must roll back and replay clean — must finish equal to its
    solo ``Grid.run_steps`` run: its digest bit for bit with the table
    program (``bulk=False``), its final state within :data:`BULK_TOL`
    of the peak when its bucket steps through kernel A' (``bulk=True``). ONLY the
    victim may trip, and for the SDC case the victim's trip must be a
    CORRUPT verdict. Raises :class:`FuzzFailure`; returns ``{victim,
    trips, report, bulk}`` on success (``bulk``: whether the buckets
    ran the bulk program)."""
    import tempfile

    from .fleet import FleetJob, run_solo
    from .scheduler import FleetScheduler

    rng = np.random.default_rng(seed)
    kernels = ("diffuse", "advect_x")

    def mk(i):
        return FleetJob(
            f"f{seed}_{i:02d}", length=(n,) * 3,
            kernel=kernels[int(rng.integers(0, len(kernels)))],
            n_steps=int(rng.integers(6, 24)),
            params=(float(rng.uniform(0.01, 0.08)),),
            priority=int(rng.integers(0, 3)),
            seed=int(rng.integers(0, 2 ** 31)),
            checkpoint_every=int(rng.integers(3, 9)))

    def fresh(j):
        return FleetJob(j.name, length=j.length, kernel=j.kernel,
                        n_steps=j.n_steps, params=j.params, seed=j.seed)

    specs = [mk(i) for i in range(jobs)]
    if bulk:
        solo = {j.name: _solo_state(fresh(j), device) for j in specs}
    else:
        solo = {j.name: run_solo(fresh(j), device) for j in specs}
    victim = specs[int(rng.integers(0, jobs))]
    poison_step = int(rng.integers(1, victim.n_steps + 1))
    plan = FaultPlan(seed=seed)
    if fault == "flip":
        plan.silent_flip("rho", step=poison_step, job=victim.name)
        site = "step.flip"
    else:
        plan.nan_poison("rho", step=poison_step, job=victim.name)
        site = "step.poison"
    states, ran_bulk = {}, set()
    with tempfile.TemporaryDirectory(prefix="dccrg_fleet_fuzz_") as wd:
        sched = FleetScheduler(wd, specs, quantum=quantum,
                               devices=[device], bulk=bulk)
        finish = sched._finish

        def keep_final(batch, slot, job, status="done"):
            if batch is not None and status == "done":
                ran_bulk.add(batch.bulk_active())
                states[job.name] = {k: v[:batch.L] for k, v in
                                    batch.extract(slot).items()}
            finish(batch, slot, job, status)

        sched._finish = keep_final
        with plan:
            report = sched.run()
    if plan.fired(site) != 1:
        raise FuzzFailure(
            f"fleet {fault} for {victim.name} at step {poison_step} "
            f"never landed", seed=seed)
    if ran_bulk != {bool(bulk)}:
        raise FuzzFailure(
            f"the buckets ran {'the bulk' if True in ran_bulk else 'the table'}"
            f" program, asked for bulk={bulk}", seed=seed)
    for j in specs:
        row = report.get(j.name)
        if row is None or row["status"] != "done":
            raise FuzzFailure(
                f"fleet job {j.name} did not finish: {row}", seed=seed)
        if bulk:
            same = all(_within_bulk_tol(states[j.name][f], want)
                       for f, want in solo[j.name].items())
        else:
            same = row["digest"] == solo[j.name]
        if not same:
            raise FuzzFailure(
                f"fleet job {j.name} final state differs from its "
                f"solo run (victim was {victim.name}, {fault} after "
                f"step {poison_step})", seed=seed)
        if j.name != victim.name and row["trips"]:
            raise FuzzFailure(
                f"non-victim job {j.name} tripped {row['trips']} "
                f"time(s); only {victim.name} was corrupted",
                seed=seed)
    if report[victim.name]["trips"] < 1:
        raise FuzzFailure(
            f"victim {victim.name} ({fault} after step {poison_step} "
            f"of {victim.n_steps}) never tripped", seed=seed)
    if fault == "flip" and report[victim.name]["sdc_trips"] < 1:
        raise FuzzFailure(
            f"victim {victim.name}'s silent flip tripped, but not as "
            "a CORRUPT verdict", seed=seed)
    return {"victim": victim.name,
            "trips": report[victim.name]["trips"], "report": report,
            "bulk": bool(bulk)}


# -- distributed-AMR commit scenario (the distamr layer's oracle) -----

def _dist_amr_digest(grid):
    """Bitwise fingerprint of one faked rank's world: structure
    (plan digest), owned payload bytes (process-local state digest),
    the pending request sets the rollback must restore, and the epoch
    fence. ``txn.grid_state_bytes`` is the single-controller
    fingerprint; a faked-split rank cannot run a whole two-phase save
    alone, so the distributed scenario composes the same coverage from
    rank-local pieces."""
    from . import distamr
    from .checkpoint import state_digest

    return (distamr.plan_digest(grid.plan), state_digest(grid),
            tuple(sorted(grid._refines)), tuple(sorted(grid._unrefines)),
            tuple(sorted(grid._dont_refines)),
            tuple(sorted(grid._dont_unrefines)),
            grid._amr_group.read_fence())


def dist_amr_case(seed: int, rounds: int = 4, abort_rate: float = 0.6,
                  length=(6, 6, 4), max_lvl: int = 1, device=None) -> dict:
    """One seeded distributed-AMR crash-consistency scenario: two
    faked ranks (process-split partition masks over two partitions of
    ``device``, the card when None; one shared
    :class:`~dccrg_tpu_torch.coord.InMemoryKV`, one protocol thread per
    rank) drive ``rounds`` adapt epochs of random rank-local
    refine/unrefine requests through
    :func:`~dccrg_tpu_torch.distamr.distributed_stop_refining`. With
    probability ``abort_rate`` a round first runs with an injected
    fault at a random :data:`~dccrg_tpu_torch.faults.DIST_AMR_FAULT_SITES`
    point on a random victim rank: EVERY rank must abort
    (:class:`~dccrg_tpu_torch.txn.CrossRankAbortedError`), every rank's
    fingerprint (structure, owned bytes, request sets, fence) must be
    bitwise its pre-round value, and the collective fault-free retry
    must commit. After every committed epoch each rank's grid must
    match the single-controller oracle (the merged requests through
    the unchanged local ``stop_refining``) and re-verify
    :func:`~dccrg_tpu_torch.verify.verify_refinement_balance` and
    :func:`~dccrg_tpu_torch.verify.verify_neighbor_symmetry` from scratch.
    Raises :class:`FuzzFailure`; returns summary counts."""
    import threading

    from . import coord, distamr
    from .faults import FaultPlan as _FaultPlan
    from .txn import CrossRankAbortedError
    from .verify import verify_neighbor_symmetry, verify_refinement_balance

    rng = np.random.default_rng(seed)
    devs = _partitions(device, 2)

    def mk():
        g = (
            Grid(cell_data={"rho": np.float32})
            .set_initial_length(length)
            .set_maximum_refinement_level(int(max_lvl))
            .set_periodic(True, True, True)
            .set_neighborhood_length(1)
            .initialize(devs, partition="block")
        )
        cells = g.get_cells()
        g.set("rho", cells,
              (np.asarray(cells) % np.uint64(29)).astype(np.float32))
        return g

    ref = mk()
    kv = coord.InMemoryKV()
    # the ranks' grids share nothing but the KV, and torch takes
    # dispatches from two threads: no lock around the device work
    grids = {}
    for rank in (0, 1):
        g = mk()
        g._proc_local_dev = np.array(
            [(d < 1) == (rank == 0) for d in range(g.n_dev)], dtype=bool)
        g._ckpt_rank = rank
        g.enable_distributed_amr(kv=kv, rank=rank, n_ranks=2, timeout=60)
        grids[rank] = g

    def run_all(plan=None):
        """One collective round on both rank threads; returns
        ``{rank: outcome}`` (the new cells, or the raised error)."""
        out = {}

        def one(rank):
            try:
                out[rank] = grids[rank].stop_refining()
            except BaseException as e:  # noqa: BLE001 - asserted below
                out[rank] = e

        ctx = plan if plan is not None else _NullCtx()
        with ctx:
            ts = [threading.Thread(target=one, args=(r,)) for r in (0, 1)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
        return out

    aborts = commits = 0
    for rnd in range(1, rounds + 1):
        # random rank-local requests, mirrored into the oracle grid
        any_req = False
        for rank in (0, 1):
            g = grids[rank]
            local = g.local_cells().ids
            for cid in rng.choice(local, size=min(2, len(local)),
                                  replace=False):
                if (max_lvl and rng.random() < 0.7
                        and g.refine_completely(int(cid))):
                    ref.refine_completely(int(cid))
                    any_req = True
                elif g.unrefine_completely(int(cid)):
                    ref.unrefine_completely(int(cid))
                    any_req = True
        if not any_req:
            continue

        if rng.random() < abort_rate:
            from .faults import DIST_AMR_FAULT_SITES

            site, phase = DIST_AMR_FAULT_SITES[
                int(rng.integers(len(DIST_AMR_FAULT_SITES)))]
            victim = int(rng.integers(2))
            before = {r: _dist_amr_digest(grids[r]) for r in (0, 1)}
            plan = _FaultPlan(seed=int(rng.integers(1 << 31)))
            plan.amr_error(site=site, phase=phase, rank=victim)
            out = run_all(plan)
            for r in (0, 1):
                if not isinstance(out[r], CrossRankAbortedError):
                    raise FuzzFailure(
                        f"round {rnd}: rank {r} did not abort on "
                        f"injected {site}/{phase}@rank{victim} "
                        f"(got {out[r]!r})", seed=seed)
                if _dist_amr_digest(grids[r]) != before[r]:
                    raise FuzzFailure(
                        f"round {rnd}: rank {r} is not bitwise its "
                        f"pre-round state after the {site} abort",
                        seed=seed)
            aborts += 1

        out = run_all()
        for r in (0, 1):
            if isinstance(out[r], BaseException):
                raise FuzzFailure(
                    f"round {rnd}: fault-free commit failed on rank "
                    f"{r}: {out[r]!r}", seed=seed)
        ref.stop_refining()
        commits += 1
        for r in (0, 1):
            g = grids[r]
            if not (np.array_equal(g.plan.cells, ref.plan.cells)
                    and np.array_equal(g.plan.owner, ref.plan.owner)):
                raise FuzzFailure(
                    f"round {rnd}: rank {r} structure diverged from "
                    "the single-controller oracle", seed=seed)
            try:
                verify_refinement_balance(g)
                verify_neighbor_symmetry(g)
            except VerificationError as e:
                raise FuzzFailure(
                    f"round {rnd}: rank {r} invariants broken after "
                    f"commit: {e}", seed=seed,
                    cells=getattr(e, "cells", ())) from e
            g.clear_refined_unrefined_data()
        ref.clear_refined_unrefined_data()
    return {"rounds": rounds, "aborts": aborts, "commits": commits}


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# -- CLI --------------------------------------------------------------

def _main(argv=None) -> int:
    """``python -m dccrg_tpu_torch.fuzz --seed N --ops M`` — run one (or
    ``--seeds K``: seeds 0..K-1) deterministic fuzz run and report;
    ``--fleet K`` runs K seeded fleet-isolation scenarios
    (:func:`fleet_isolation_case`) and ``--dist-amr K`` K distributed-AMR
    scenarios instead. Runs on the card unless ``--device cpu``; exit 2
    when the card is asked for and there is none."""
    import argparse
    import time

    ap = argparse.ArgumentParser(prog="python -m dccrg_tpu_torch.fuzz",
                                 description=_main.__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=None,
                    help="sweep seeds 0..K-1 instead of --seed")
    ap.add_argument("--ops", type=int, default=40)
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--length", type=int, nargs=3, default=(4, 4, 2))
    ap.add_argument("--max-level", type=int, default=1)
    ap.add_argument("--devices", type=int, default=2,
                    help="partitions of the device the grid lives on")
    ap.add_argument("--device", default=None,
                    help="the device (default: the card; 'cpu' runs the "
                         "plain paths)")
    ap.add_argument("--schema", choices=("scalar", "mhd"),
                    default="scalar",
                    help="cell-data schema: the classic scalar rho "
                         "(+aux) or the model zoo's 8-field MHD "
                         "schema (txn/fault sites then exercise the "
                         "multi-field mutation paths)")
    ap.add_argument("--fleet", type=int, default=None, metavar="K",
                    help="run K seeded fleet-isolation scenarios "
                         "(one poisoned batch slot; every job must "
                         "match its solo run) instead of the "
                         "mutation fuzz")
    ap.add_argument("--dist-amr", type=int, default=None, metavar="K",
                    help="run K seeded distributed-AMR commit "
                         "scenarios (two faked ranks, random aborted "
                         "commits, bitwise rollback + re-verified "
                         "2:1/neighbor invariants) instead of the "
                         "mutation fuzz")
    args = ap.parse_args(argv)
    dev = args.device
    if (dev is None or torch.device(dev).type == "cuda") \
            and not torch.cuda.is_available():
        print("no CUDA device is available; pass --device cpu")
        return 2

    if args.dist_amr is not None:
        t0 = time.time()
        for s in range(args.dist_amr):
            try:
                out = dist_amr_case(s, device=dev)
            except FuzzFailure as e:
                print(f"FAIL {e}")
                return 1
            print(f"dist-amr seed {s}: {out['commits']} commit(s), "
                  f"{out['aborts']} injected abort(s) rolled back")
        print(f"OK {args.dist_amr} dist-amr seed(s), "
              f"{time.time() - t0:.1f}s")
        return 0

    if args.fleet is not None:
        t0 = time.time()
        for s in range(args.fleet):
            # even seeds exercise the NaN class, odd seeds the silent
            # (finite bit-flip) SDC class — same isolation oracle
            fault = "flip" if s % 2 else "nan"
            try:
                out = fleet_isolation_case(s, fault=fault, device=dev)
            except FuzzFailure as e:
                print(f"FAIL {e}")
                return 1
            print(f"fleet seed {s} ({fault}): victim {out['victim']} "
                  f"tripped {out['trips']}x, all jobs match solo")
        print(f"OK {args.fleet} fleet seed(s), "
              f"{time.time() - t0:.1f}s")
        return 0

    seeds = range(args.seeds) if args.seeds is not None else [args.seed]
    t0 = time.time()
    total_faults = 0
    for s in seeds:
        try:
            fz = GridFuzzer(
                s, ops=args.ops, length=tuple(args.length),
                max_lvl=args.max_level, n_dev=args.devices,
                fault_rate=args.fault_rate, schema=args.schema,
                devices=dev,
            ).run()
        except FuzzFailure as e:
            print(f"FAIL {e}")
            return 1
        total_faults += fz.faults_injected
        print(f"seed {s}: {fz.ops_run} ops ok"
              + (f", {fz.faults_injected} fault(s) rolled back"
                 if fz.faults_injected else ""))
    print(f"OK {len(list(seeds))} seed(s) x {args.ops} ops, "
          f"{total_faults} injected fault(s), {time.time() - t0:.1f}s")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via CLI
    raise SystemExit(_main())
