"""The models, the fleet's lanes and the ranks on distinct devices of one
process.

The CPU names distinct host devices ``cpu:0``, ``cpu:1``, ... (a tensor
made on ``cpu:1`` reports ``cpu``, and a copy between them is a real
copy), as the reference's tests force XLA host devices.

- **Models.** ``AmrAdvection``, ``GridMHD``, ``GridVlasov``,
  ``ParticleModel`` and ``ScalabilityModel`` (and ``run_sweep`` over a
  device list) run on one partition per device and on two partitions
  per device, and are held bit for bit to the same four partitions on
  one device (``["cpu"] * 4``), and to the reference's 4-device mesh
  within the tolerances of the port's parity tests for each model.
- **Lanes.** A scheduler on lanes ``["cpu:0", "cpu:1"]`` runs the SDC
  quarantine scenario of tests/test_torch_scheduler.py: lane 0 is
  quarantined and its jobs migrate into buckets on ``cpu:1``, and every
  job ends at its solo digest.
- **Ranks.** Two gloo ranks on localhost, started once for the file,
  each hold ``["cpu:0", "cpu:1"]`` (the reference harness's two devices
  per process, tests/mp_harness.py:233-235): the step loop with the
  overlap off and on, the exchange and the split phase, a distributed
  AMR commit, a balance, the two-phase ``.dc`` bytes, ``AmrAdvection``,
  ``GridMHD``, ``ParticleModel`` and the dense mesh with its two solvers
  hold bit for bit to one process's ``["cpu"] * 4``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu.models import mhd as ref_mhd
from dccrg_tpu.models import vlasov as ref_vlasov
from dccrg_tpu.models.advection_amr import AmrAdvection as RefAmr
from dccrg_tpu.models.particles import ParticleModel as RefParticles
from dccrg_tpu.models.scalability import ScalabilityModel as RefScale

from dccrg_tpu_torch import checkpoint, faults, fleet, scheduler, telemetry
from dccrg_tpu_torch.grid import Grouped
from dccrg_tpu_torch.models import GridMHD, GridVlasov
from dccrg_tpu_torch.models.advection_amr import AmrAdvection
from dccrg_tpu_torch.models.particles import ParticleModel
from dccrg_tpu_torch.models.scalability import ScalabilityModel, run_sweep

from test_torch_ranks import _COMMON as GRID_COMMON
from test_torch_ranks_models import _COMMON as MODEL_COMMON
from torch_ranks_fixture import HELD, collect_ranks, start_ranks

ONE = ["cpu"] * 4
PLACES = {"spread": ["cpu:0", "cpu:1", "cpu:2", "cpu:3"],
          "pairs": ["cpu:0", "cpu:0", "cpu:1", "cpu:1"]}
places = pytest.mark.parametrize("place", sorted(PLACES))

# the port's parity tolerances against the reference, per model
AMR_TOL = dict(rtol=1e-5, atol=1e-7)    # test_torch_advection_amr_partitions
ZOO_TOL = dict(rtol=1e-6, atol=1e-6)    # test_torch_zoo
PART_TOL = dict(rtol=0, atol=1e-6)      # test_torch_particles
SCALE_TOL = dict(rtol=1e-5, atol=1e-6)  # test_torch_scalability

AMR_KW = dict(length=(8, 8, 1), max_refinement_level=1)
MHD_KW = dict(n=8, profile="random", seed=3)
VLASOV_KW = dict(n=8, nv=16)
PART_KW = dict(length=(8, 8, 8), capacity=4, periodic=(True, True, True))
SCALE_KW = dict(length=(4, 4, 4), floats_per_cell=2, work_iters=16)


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("dev",))


def held(g, names=None):
    """Every held row of each field (ghost and pad rows too), on the
    host, slots in order, whatever the storage groups."""
    return {n: g._to_held(g.data[n]).numpy().copy()
            for n in (names or g.fields)}


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def assert_bits(got, want, tag=""):
    assert set(got) == set(want), tag
    for n in want:
        assert got[n].shape == want[n].shape, (tag, n)
        np.testing.assert_array_equal(_bits(got[n]), _bits(want[n]),
                                      err_msg=f"{tag} {n}")


def assert_groups(g, devs):
    """One storage group per distinct device, in order, none sharing
    memory with another."""
    want = list(dict.fromkeys(devs))
    assert [str(x.device) for x in g._groups] == want
    ptrs = []
    for t in g.data.values():
        assert isinstance(t, Grouped) and len(t.groups) == len(want)
        ptrs += [x.untyped_storage().data_ptr() for x in t.groups]
    assert len(set(ptrs)) == len(ptrs)


# ---------------------------------------------------------------------
# the models on one process's distinct devices

def drift(pos):
    return torch.stack([torch.full_like(pos[:, 0], 0.9),
                        -0.45 * torch.ones_like(pos[:, 0]),
                        0.3 * torch.cos(pos[:, 0])], dim=1)


def ref_drift(pos):
    return jnp.stack([jnp.full_like(pos[:, 0], 0.9),
                      -0.45 * jnp.ones_like(pos[:, 0]),
                      0.3 * jnp.cos(pos[:, 0])], axis=1)


PTS = np.random.default_rng(7).uniform(0, 8, (500, 3)).astype(np.float32)


def amr_run(device):
    """run(6, adapt_n=3) (two adapts) and a balance from block to rcb:
    the scalars, the structure and the rows."""
    app = AmrAdvection(device=device, **AMR_KW)
    out = {"dt0": app.max_time_step(), "m0": app.total_mass()}
    app.run(6, adapt_n=3)
    app.grid.set_load_balancing_method("rcb")
    app.balance()
    g = app.grid
    out.update(dt=app.max_time_step(), m=app.total_mass(),
               cells=g.plan.cells.copy(), owner=g.plan.owner.copy(),
               density=g.get("density", g.plan.cells))
    return app, held(g), out


def mhd_run(device, dts):
    m = GridMHD(device=device, **MHD_KW)
    out = {"sums0": m.conserved_sums(), "dts": []}
    for dt in dts:
        out["dts"].append(m.max_time_step())
        m.run(2, dt=dt)
    out["sums"] = m.conserved_sums()
    return m, held(m.grid), out


def vlasov_run(device):
    v = GridVlasov(device=device, **VLASOV_KW)
    out = {"m0": v.total_mass()}
    v.run(6, dt=0.04)
    out["m"] = v.total_mass()
    return v, held(v.grid), out


def particle_run(device):
    m = ParticleModel(drift, device=device, **PART_KW)
    out = {"placed": m.add_particles(PTS), "caps": []}
    for _ in range(5):
        m.step(0.5)
        out["caps"].append(m.capacity)
    rows = dict(held(m.grid, ["pos", "count"]), counts=m.counts(),
                particles=m.particles())
    return m, rows, out


def scale_run(device):
    m = ScalabilityModel(device=device, **SCALE_KW)
    rep = m.run(steps=2, warmup=0)
    keys = ("n_devices", "n_cells", "halo_bytes_per_step",
            "rank_halo_bytes_per_step")
    return m, held(m.grid), dict({k: rep[k] for k in keys},
                                 device=rep["device_halo_bytes_per_step"])


MODELS = {"amr": amr_run, "vlasov": vlasov_run, "particles": particle_run,
          "scale": scale_run}


@pytest.fixture(scope="module")
def one():
    """The reference's 4-device runs and the port's on ``["cpu"] * 4``."""
    ref, out = {}, {}
    ra = RefAmr(mesh=mesh_of(4), **AMR_KW)
    ra.run(6, adapt_n=3)
    ra.grid.set_load_balancing_method("rcb")
    ra.balance()
    ref["amr"] = {"cells": ra.grid.plan.cells, "owner": ra.grid.plan.owner,
                  "density": ra.grid.get("density", ra.grid.plan.cells),
                  "dt": ra.max_time_step(), "m": ra.total_mass()}
    rm = ref_mhd.GridMHD(mesh=mesh_of(4), **MHD_KW)
    dts = []
    for _ in range(3):
        dts.append(0.4 * rm.max_time_step())
        rm.run(2, dt=dts[-1])
    ref["mhd"] = {n: rm.grid.get(n, rm.grid.plan.cells)
                  for n in ref_mhd.MHD_ALL}
    ref["mhd_dts"] = dts
    rv = ref_vlasov.GridVlasov(mesh=mesh_of(4), **VLASOV_KW)
    rv.run(6, dt=0.04)
    ref["vlasov"] = {n: rv.grid.get(n, rv.grid.plan.cells)
                     for n in ref_vlasov.VLASOV_FIELDS}
    rp = RefParticles(ref_drift, mesh=mesh_of(4), **PART_KW)
    rp.add_particles(PTS)
    for _ in range(5):
        rp.step(0.5)
    ref["particles"] = {"counts": np.asarray(rp.counts()),
                        "particles": np.asarray(rp.particles())}
    rs = RefScale(mesh=mesh_of(4), **SCALE_KW)
    for _ in range(2):
        rs.step()
    ref["scale"] = rs.grid.get("payload", rs.grid.plan.cells)
    for name, run in MODELS.items():
        out[name] = run(ONE)[1:]
    out["mhd"] = mhd_run(ONE, dts)[1:]
    return {"ref": ref, "one": out}


def _run(name, device, one):
    if name == "mhd":
        return mhd_run(device, one["ref"]["mhd_dts"])
    return MODELS[name](device)


@places
def test_amr_advection_on_devices(one, place):
    """Two adapts and a balance: cells, owners, rows, CFL steps and
    masses bit for bit with one device; the cells and owners the
    reference's, the density within its tolerance, the mass conserved."""
    app, rows, out = _run("amr", PLACES[place], one)
    assert_groups(app.grid, PLACES[place])
    want_rows, want = one["one"]["amr"]
    assert_bits(rows, want_rows, "amr")
    for k in ("dt0", "m0", "dt", "m"):
        assert out[k] == want[k], k
    for k in ("cells", "owner", "density"):
        np.testing.assert_array_equal(_bits(out[k]), _bits(want[k]))
    ref = one["ref"]["amr"]
    np.testing.assert_array_equal(out["cells"], ref["cells"])
    np.testing.assert_array_equal(out["owner"], ref["owner"])
    np.testing.assert_allclose(out["density"], ref["density"], **AMR_TOL)
    assert out["dt"] == ref["dt"]
    assert out["m"] == pytest.approx(ref["m"], rel=1e-6)
    assert abs(out["m"] - out["m0"]) < 1e-5 * out["m0"]
    assert len(out["cells"]) > 64  # the adapts refined


@places
def test_mhd_on_devices(one, place):
    """Three run(2) at the reference's steps: rows, CFL steps and the
    conserved sums bit for bit with one device, the state within the
    zoo's tolerance of the reference's."""
    m, rows, out = _run("mhd", PLACES[place], one)
    assert_groups(m.grid, PLACES[place])
    want_rows, want = one["one"]["mhd"]
    assert_bits(rows, want_rows, "mhd")
    assert out == want
    cells = m.grid.plan.cells
    for n, r in one["ref"]["mhd"].items():
        np.testing.assert_allclose(m.grid.get(n, cells), r, err_msg=n,
                                   **ZOO_TOL)


@places
def test_vlasov_on_devices(one, place):
    """Six steps: rows and masses bit for bit with one device, the state
    within the zoo's tolerance of the reference's."""
    v, rows, out = _run("vlasov", PLACES[place], one)
    assert_groups(v.grid, PLACES[place])
    want_rows, want = one["one"]["vlasov"]
    assert_bits(rows, want_rows, "vlasov")
    assert out == want
    cells = v.grid.plan.cells
    for n, r in one["ref"]["vlasov"].items():
        np.testing.assert_allclose(v.grid.get(n, cells), r, err_msg=n,
                                   **ZOO_TOL)


@places
def test_particles_on_devices(one, place):
    """The 3-D cloud at a capacity that overflows: positions, counts,
    the overflow's growth and the particles bit for bit with one device;
    the counts the reference's and the positions within its
    tolerance."""
    m, rows, out = _run("particles", PLACES[place], one)
    assert_groups(m.grid, PLACES[place])
    want_rows, want = one["one"]["particles"]
    assert_bits(rows, want_rows, "particles")
    assert out == want and out["caps"][-1] > PART_KW["capacity"]
    ref = one["ref"]["particles"]
    np.testing.assert_array_equal(rows["counts"], ref["counts"])

    def srt(p):
        return p[np.lexsort(p.T)]
    np.testing.assert_allclose(srt(rows["particles"]),
                               srt(ref["particles"]), **PART_TOL)


@places
def test_scalability_on_devices(one, place):
    """Two timed steps: rows and the report's placement, cells and halo
    bytes the one device's; the bytes between devices counted; the
    payload within the reference's tolerance."""
    m, rows, out = _run("scale", PLACES[place], one)
    assert_groups(m.grid, PLACES[place])
    want_rows, want = one["one"]["scale"]
    assert_bits(rows, want_rows, "scale")
    dev = out.pop("device")
    assert out == {k: v for k, v in want.items() if k != "device"}
    assert want["device"] == 0 < dev <= out["halo_bytes_per_step"]
    # one partition per device: every send crosses devices
    assert (dev == out["halo_bytes_per_step"]) == (place == "spread")
    np.testing.assert_allclose(
        m.grid.get("payload", m.grid.plan.cells), one["ref"]["scale"],
        **SCALE_TOL)


def test_sweep_over_devices():
    """run_sweep over a device list runs count n on its first n devices
    (the reference's ``devices[:n]``): each row's placement, cells and
    halo bytes those of n partitions of one device, the bytes between
    devices counted; a count past the list is skipped."""
    kw = dict(length=(4, 4, 4), floats_per_cell=2, work_iters=4, steps=2)
    devs = PLACES["spread"][:3]
    rows = run_sweep([1, 2, 4], device=devs, **kw)
    base = run_sweep([1, 2], device="cpu", **kw)
    assert [r["n_devices"] for r in rows] == [1, 2]
    for got, want in zip(rows, base):
        for k in ("n_devices", "n_cells", "halo_bytes_per_step"):
            assert got[k] == want[k], k
        assert want["device_halo_bytes_per_step"] == 0
    assert rows[0]["device_halo_bytes_per_step"] == 0
    assert rows[1]["device_halo_bytes_per_step"] == \
        rows[1]["halo_bytes_per_step"] > 0


# ---------------------------------------------------------------------
# the fleet's lanes on distinct devices

def _lane_jobs():
    """tests/test_torch_scheduler.py's ``_sjobs(side, 8, 16)``."""
    return [fleet.FleetJob(f"s{i:02d}", length=(8, 8, 8), n_steps=16,
                           params=(0.02 + 0.004 * (i % 4),), seed=i,
                           checkpoint_every=4) for i in range(8)]


def test_lane_quarantine_migrates_across_devices(tmp_path):
    """test_repeat_offender_lane_quarantined_and_migrated on lanes
    ``["cpu:0", "cpu:1"]``: lane 0's buckets live on ``cpu:0``, two
    flips there quarantine it, and its jobs migrate into a bucket built
    on ``cpu:1`` (its template grid and state there, none of the old
    storage reused); every job ends at its solo digest."""
    lanes = ["cpu:0", "cpu:1"]
    sched = scheduler.FleetScheduler(
        str(tmp_path), _lane_jobs(), devices=lanes, bulk=False, quantum=4,
        quarantine_after=2)
    seen = {}
    orig = sched._quarantine

    def quarantine(lane):
        seen["old"] = [b for bs in sched.buckets.values() for b in bs
                       if b.lane == lane]
        seen["ptrs"] = {t.untyped_storage().data_ptr()
                        for b in seen["old"] for t in b.state.values()}
        orig(lane)

    sched._quarantine = quarantine
    plan = faults.FaultPlan(seed=5)
    plan.silent_flip("rho", step=5, job="s02")
    plan.silent_flip("rho", step=9, job="s04")
    with plan:
        report = sched.run()
    assert plan.fired("step.flip") == 2
    assert sched.quarantined == {0} and sched.suspects == [2, 0]
    assert all(r["status"] == "done" for r in report.values())
    assert {n for n, r in report.items() if r["trips"]} == {"s02", "s04"}
    assert [str(b.device) for b in seen["old"]] == ["cpu:0"]
    batches = [b for bs in sched.buckets.values() for b in bs]
    assert batches and all(b.lane == 1 for b in batches)
    for b in batches:
        assert str(b.device) == "cpu:1"
        assert str(b.grid._groups[0].device) == "cpu:1"
        for t in b.state.values():
            assert t.untyped_storage().data_ptr() not in seen["ptrs"]
    solo = {}
    for j in _lane_jobs():
        g = fleet.template_grid(j, "cpu")
        j.apply_init(g)
        g.run_steps(j.resolved_kernel(), j.fields_in, j.fields_out,
                    j.n_steps, extra_args=tuple(
                        torch.tensor(p, dtype=torch.float32)
                        for p in j.params))
        solo[j.name] = checkpoint.state_digest(g)
    assert {n: r["digest"] for n, r in report.items()} == solo


# ---------------------------------------------------------------------
# two ranks, each holding two distinct devices

_CASES = GRID_COMMON + MODEL_COMMON + r'''
import json
import os

from dccrg_tpu_torch import distamr, integrity, resilience


def held_rows(g, names=None):
    return {n: g._to_held(g.data[n]).numpy().copy()
            for n in (names or g.fields)}


ADV_CASES = [("block", "0"), ("block", "1"), ("morton", "0"),
             ("morton", "1")]


def grid_cases(device, seed, out_dir, tag):
    """The grid's cases on ``device``: ({case: held rows}, scalars)."""
    rows, res = {}, {}
    for part, ov in ADV_CASES:
        os.environ["DCCRG_OVERLAP"] = ov
        g, kern, _app = adv_grid(part, device)
        g.set_many(seed["adv_cells"], {f: seed[f"{part}_{f}"]
                                       for f in ("density", "vx", "vy")})
        g.update_copies_of_remote_neighbors()
        g.run_steps(kern, ["density", "vx", "vy"], ["density"], STEPS,
                    extra_args=(torch.tensor(float(seed["dt"]),
                                             dtype=torch.float32),))
        rows[f"adv_{part}_{ov}"] = held_rows(g, ["density"])
        res[f"adv_{part}_{ov}"] = g.last_overlap["mode"]
    os.environ["DCCRG_OVERLAP"] = "0"

    g = exch_grid(device)
    cells = g.plan.cells
    g.set_many(cells, exch_values(cells, 0))
    g.update_copies_of_remote_neighbors()
    rows["exch_update"] = held_rows(g)
    g.set_many(cells, exch_values(cells, 5))
    g.start_remote_neighbor_copy_updates(fields=["v", "p"])
    g.wait_remote_neighbor_copy_updates()
    rows["exch_split"] = held_rows(g)

    g = amr_grid(device)
    if g._rank_held:
        g.enable_distributed_amr(timeout=60)
    for c in amr_picks(g):
        if g._proc_local_dev[g.plan.owner[np.searchsorted(
                g.plan.cells, np.uint64(c))]]:
            g.refine_completely(c)
    new = g.stop_refining()
    g.assign_children_from_parents()
    g.update_copies_of_remote_neighbors()
    rows["amr"] = held_rows(g)
    res["amr"] = {"new": int(len(new)), "pdig": distamr.plan_digest(g.plan)}

    g, kern, _app = adv_grid("block", device)
    g.set_many(seed["adv_cells"], {f: seed[f"block_{f}"]
                                   for f in ("density", "vx", "vy")})
    resilience.save_checkpoint(g, os.path.join(out_dir, f"{tag}.dc"))
    g.set_load_balancing_method("rcb")
    g.balance_load()
    g.update_copies_of_remote_neighbors()
    g.run_steps(kern, ["density", "vx", "vy"], ["density"], STEPS,
                extra_args=(torch.tensor(float(seed["dt"]),
                                         dtype=torch.float32),))
    rows["balance"] = held_rows(g, ["density"])
    res["balance"] = json.loads(json.dumps({
        "owner": g.plan.owner.tolist(),
        "fingerprint": integrity.grid_fingerprint(g),
        "finite": resilience.check_finite(g)}))
    return rows, res


def dense_cases(device, adv_dt, rhs):
    """AdvectionSolver(16, 4) on a (2, 1, 2) mesh, ten steps, and the
    periodic DensePoissonSolver(8^3) on a (1, 2, 2) mesh: each held
    block, and the scalars."""
    s = AdvectionSolver(n=ADV_N, nz=ADV_NZ,
                        mesh=dense_mesh(device, DENSE_SHAPE))
    out = {"adv_dt": s.max_time_step(), "adv_m0": s.total_mass()}
    for _ in range(ADV_STEPS):
        s.step(np.float32(adv_dt))
    out["adv_m"] = s.total_mass()
    out["adv_l2"] = s.l2_error()
    rho = s.grid.arrays["rho"]
    blocks = {"adv_rho": np.stack([b.cpu().numpy()
                                   for b in s.grid._split(rho)])}
    ps = DensePoissonSolver((POISSON_N,) * 3, periodic=(True, True, True),
                            mesh=dense_mesh(device, POISSON_SHAPE))
    x, info = ps.solve(rhs, rtol=1e-5)
    out["cg"] = int(info["iterations"])
    out["cg_res"] = info["residual"]
    blocks["cg"] = np.stack([b.cpu().numpy() for b in ps.grid._split(x)])
    return blocks, out
'''

_WORKER = _CASES + r'''
import json, sys
from dccrg_tpu_torch import coord

r, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
coord.distributed_init(f"127.0.0.1:{port}", 2, r, retries=20, backoff=0.1)
os.environ["DCCRG_BARRIER_TIMEOUT"] = "60"
PLACE = coord.rank_devices(2, ["cpu:0", "cpu:1"])
seed = dict(np.load(os.path.join(out_dir, "seed.npz")))
res = {}
rows, res["grid"] = grid_cases(PLACE, seed, out_dir, "ranks")
rows["amr_model"], res["amr_model"] = amr_case(PLACE)
rows["mhd"], res["mhd"] = mhd_case(PLACE, seed["mhd_dts"].tolist())
rows["particles"], res["particles"] = particle_case(PLACE, seed["pts"])
rows["dense"], res["dense"] = dense_cases(PLACE, float(seed["adv_dt"]),
                                          seed["rhs"])
np.savez(os.path.join(out_dir, f"rows_{r}.npz"),
         **{f"{case}/{n}": a for case, d in rows.items()
            for n, a in d.items()})
res["groups"] = [str(x.device) for x in exch_grid(PLACE)._groups]
res["bytes"] = {leg: halo_bytes(leg) for leg in (
    "halo", "rows", "slab", "device_halo", "device_rows", "device_slab")}
print("RESULT " + json.dumps(res), flush=True)
try:
    coord.barrier("end", timeout=60)
except Exception:
    pass
os._exit(0)
'''

_ns: dict = {}
exec(compile(_CASES, "<devices ranks cases>", "exec"), _ns)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' rows and scalars, and one process's on
    ``["cpu"] * 4`` from the same uploaded state."""
    out = tmp_path_factory.mktemp("devices_ranks")
    C = _ns
    seed = {}
    adv = C["adv_grid"]("block", ONE)[2]
    seed["dt"] = np.float64(0.5 * adv.max_time_step())
    for part in ("block", "morton"):
        g = C["adv_grid"](part, ONE)[0]
        seed["adv_cells"] = g.plan.cells
        for f in ("density", "vx", "vy"):
            seed[f"{part}_{f}"] = g.get(f, g.plan.cells)
    seed["mhd_dts"] = np.asarray([0.004, 0.005, 0.003])
    seed["pts"] = np.random.default_rng(7).uniform(0, 8, (500, 3)) \
        .astype(np.float32)
    seed["adv_dt"] = np.float64(0.4 * C["AdvectionSolver"](
        n=C["ADV_N"], nz=C["ADV_NZ"], device="cpu").max_time_step())
    rhs = np.random.default_rng(5).standard_normal((C["POISSON_N"],) * 3)
    seed["rhs"] = (rhs - rhs.mean()).astype(np.float32)
    np.savez(out / "seed.npz", **seed)
    procs = start_ranks(_WORKER, out)

    one_rows, one = {}, {}
    grid_rows, one["grid"] = C["grid_cases"](ONE, seed, str(out), "one")
    one_rows.update(grid_rows)
    one_rows["amr_model"], one["amr_model"] = C["amr_case"](ONE)
    one_rows["mhd"], one["mhd"] = C["mhd_case"](ONE, seed["mhd_dts"].tolist())
    one_rows["particles"], one["particles"] = C["particle_case"](
        ONE, seed["pts"])
    one_rows["dense"], one["dense"] = C["dense_cases"](
        ONE, float(seed["adv_dt"]), seed["rhs"])
    res = collect_ranks(procs)
    got = {}
    for r in HELD:
        got[r] = {}
        for key, a in np.load(out / f"rows_{r}.npz").items():
            case, name = key.split("/")
            got[r].setdefault(case, {})[name] = a
    return {"one": one, "one_rows": one_rows, "res": res, "rows": got,
            "dir": out}


def _rank_rows(ranks, case, r):
    """Rank r's held rows of ``case``, and one process's rows of the
    same partitions (or blocks)."""
    want = {n: a[list(HELD[r])] for n, a in ranks["one_rows"][case].items()}
    return ranks["rows"][r][case], want


def _same_on_ranks(ranks, key, sub):
    vals = [ranks["res"][r][key][sub] for r in HELD]
    assert vals[0] == vals[1], (key, sub, vals)
    return vals[0]


def test_ranks_hold_two_devices_each(ranks):
    """Each rank's placement names two distinct devices, and each rank's
    rows crossed between them and to the other rank, every byte under
    its leg: the halo, the moved rows and the slabs."""
    for r in HELD:
        assert ranks["res"][r]["groups"] == ["cpu:0", "cpu:1"]
        b = ranks["res"][r]["bytes"]
        for leg in ("halo", "rows", "slab", "device_halo", "device_rows",
                    "device_slab"):
            assert b[leg] > 0, (r, leg, b)


@pytest.mark.parametrize("case", [f"adv_{p}_{ov}" for p in ("block", "morton")
                                  for ov in ("0", "1")])
def test_ranks_devices_step_loop(ranks, case):
    """Eight steps of the main path's grid, block and morton, the
    overlap off and on: each rank's rows (ghost rows included) are one
    process's bit for bit, and the overlap ran in the same mode."""
    for r in HELD:
        got, want = _rank_rows(ranks, case, r)
        assert_bits(got, want, f"{case} rank {r}")
    assert _same_on_ranks(ranks, "grid", case) == ranks["one"]["grid"][case]


@pytest.mark.parametrize("case", ["exch_update", "exch_split"])
def test_ranks_devices_exchange(ranks, case):
    """The halo update and the split phase of three fields: each rank's
    rows are one process's bit for bit."""
    for r in HELD:
        got, want = _rank_rows(ranks, case, r)
        assert_bits(got, want, f"{case} rank {r}")


def test_ranks_devices_amr_commit(ranks):
    """A distributed AMR commit, each rank refining its own cells: the
    same plan (digest) and created cells as one process's commit, and
    the projected rows bit for bit."""
    assert _same_on_ranks(ranks, "grid", "amr") == ranks["one"]["grid"]["amr"]
    for r in HELD:
        got, want = _rank_rows(ranks, "amr", r)
        assert_bits(got, want, f"amr rank {r}")


def test_ranks_devices_balance(ranks):
    """A balance from block to rcb, then eight steps: the owners, the
    fingerprint, the finite probe and each rank's rows are one
    process's bit for bit."""
    got = _same_on_ranks(ranks, "grid", "balance")
    assert got == ranks["one"]["grid"]["balance"] and got["finite"]
    for r in HELD:
        got, want = _rank_rows(ranks, "balance", r)
        assert_bits(got, want, f"balance rank {r}")


def test_ranks_devices_dc_bytes(ranks):
    """The two-phase save of the ranks writes one process's ``.dc`` file
    byte for byte."""
    a = (ranks["dir"] / "ranks.dc").read_bytes()
    assert a == (ranks["dir"] / "one.dc").read_bytes() and len(a) > 0


@pytest.mark.parametrize("case", ["amr_model", "mhd"])
def test_ranks_devices_models(ranks, case):
    """AmrAdvection (two adapts by the distributed commit, a balance)
    and GridMHD (three run(2)): each rank's rows are one process's bit
    for bit, and every scalar (CFL steps, masses, conserved sums, the
    cells, owners and flags) the same on both ranks and one process's."""
    for r in HELD:
        got, want = _rank_rows(ranks, case, r)
        assert_bits(got, want, f"{case} rank {r}")
    want = ranks["one"][case]
    for key, val in want.items():
        if key in ("halo", "flagged"):
            continue
        assert _same_on_ranks(ranks, case, key) == val, key
    if case == "amr_model":
        flagged = sorted(map(tuple, ranks["res"][0][case]["flagged"]
                             + ranks["res"][1][case]["flagged"]))
        assert flagged == [tuple(x) for x in want["flagged"]]


def test_ranks_devices_particles(ranks):
    """The cloud, one overflow and its growth: each rank's buffers are
    one process's bit for bit; the ranks' cells, counts and particles
    together are one process's."""
    rows, want = ranks["one_rows"]["particles"], ranks["one"]["particles"]
    for r in HELD:
        got = ranks["rows"][r]["particles"]
        for n in ("pos", "count"):
            np.testing.assert_array_equal(_bits(got[n]),
                                          _bits(rows[n][list(HELD[r])]))
    assert _same_on_ranks(ranks, "particles", "caps") == want["caps"]
    placed = [ranks["res"][r]["particles"]["placed"] for r in HELD]
    assert sum(placed) == want["placed"]
    cells = np.concatenate([ranks["rows"][r]["particles"]["cells"]
                            for r in HELD])
    order = np.argsort(cells, kind="stable")
    np.testing.assert_array_equal(cells[order], rows["cells"])
    np.testing.assert_array_equal(
        np.concatenate([ranks["rows"][r]["particles"]["counts"]
                        for r in HELD])[order], rows["counts"])
    assert np.concatenate([ranks["rows"][r]["particles"]["particles"]
                           for r in HELD]).tobytes() == \
        rows["particles"].tobytes()


def test_ranks_devices_dense_mesh(ranks):
    """AdvectionSolver ten steps and the periodic DensePoissonSolver on
    blocks held two devices to a rank: each held block is one process's
    bit for bit; the CFL step, masses, L2 error, CG iterations and
    residual the same on both ranks and one process's."""
    for r in HELD:
        got, want = _rank_rows(ranks, "dense", r)
        assert_bits(got, want, f"dense rank {r}")
    for key, val in ranks["one"]["dense"].items():
        assert _same_on_ranks(ranks, "dense", key) == val, key
