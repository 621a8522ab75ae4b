"""The models and the dense mesh on partitions or blocks that span
processes: two real ranks of a gloo group on localhost, each holding
two of four CPU partitions (``coord.rank_devices(2, "cpu")``) or two of
four blocks of a ``dense_mesh``.

Three sides run the same seeded cases: the reference (``dccrg_tpu`` on
4 of the conftest's 8 virtual host devices) and the port on four
partitions or blocks of one process, here in the test process; and the
two ranks, started once for the whole file, which write each case's
held rows or blocks to ``<case>_<rank>.npz`` and their scalars to one
``RESULT`` line. Each rank's held rows (ghost rows included) or blocks
equal the one process's bit for bit, and the reference's within the
tolerances of the models' own tests; every scalar a rank reads (a CFL
step, a mass, a conserved sum, a particle capacity, CG iterations) is
the same on both ranks and the one process's.

The ``test_fault_*`` cases build a state whose per-rank extrema or sums
differ, or whose rows a rank does not hold, and show the value every
rank must read.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from dccrg_tpu.dense import AXES, _shard_map
from dccrg_tpu.dense import DenseGrid as RefDenseGrid
from dccrg_tpu.dense import dense_mesh as ref_mesh
from dccrg_tpu.models import mhd as ref_mhd
from dccrg_tpu.models import vlasov as ref_vlasov
from dccrg_tpu.models.advection import AdvectionSolver as RefAdvection
from dccrg_tpu.models.advection_amr import AmrAdvection as RefAmr
from dccrg_tpu.models.poisson import DensePoissonSolver as RefDensePoisson
from dccrg_tpu.models.scalability import ScalabilityModel as RefScale

from torch_ranks_fixture import HELD, collect_ranks, start_ranks

# the cases, built the same way by the ranks and by this process
_COMMON = r'''
import numpy as np
import torch
from dccrg_tpu_torch import telemetry
from dccrg_tpu_torch.dense import BLOCKS, WHOLE, DenseGrid, dense_mesh
from dccrg_tpu_torch.grid import DEFAULT_NEIGHBORHOOD_ID
from dccrg_tpu_torch.models import AdvectionSolver, GridMHD, GridVlasov
from dccrg_tpu_torch.models.particles import ParticleModel
from dccrg_tpu_torch.models.scalability import ScalabilityModel
from dccrg_tpu_torch.models.advection_amr import AmrAdvection
from dccrg_tpu_torch.models.mhd import MHD_ALL
from dccrg_tpu_torch.models.poisson import DensePoissonSolver
from dccrg_tpu_torch.models.vlasov import VLASOV_EXCHANGE, VLASOV_FIELDS

MHD_KW = dict(n=8, profile="random", seed=3)
VLASOV_KW = dict(n=8, nv=16)
VLASOV_STEPS, VLASOV_DT = 6, 0.04
PART_CAP, PART_STEPS, PART_DT = 4, 5, 0.5  # only partition 1 overflows
SCALE_KW = dict(length=(4, 4, 4), floats_per_cell=2, work_iters=16)
DENSE_LEN = (4, 6, 8)
DENSE_PERIODIC = (True, False, True)
DENSE_SHAPE = (2, 1, 2)
ADV_N, ADV_NZ, ADV_STEPS = 16, 4, 10
POISSON_N, POISSON_SHAPE = 8, (1, 2, 2)
POISSON_PERIODIC = [(True, True, True), (True, True, False)]


def halo_bytes(leg="halo"):
    return telemetry.registry().counter_total("dccrg_rank_bytes_total",
                                              leg=leg)


def held_rows(g, names=None):
    return {n: g.data[n].numpy().copy() for n in (names or g.fields)}


def scale_partitions(g, name, parts, k):
    """Multiply ``name``'s rows of the partitions ``parts`` (those this
    process holds) by ``k``: a state whose per-rank extrema differ."""
    for i, p in enumerate(g._held):
        if int(p) in parts:
            g.data[name][i] *= k


def amr_case(device):
    """tests/test_device_counts.py's AmrAdvection: run(6, adapt_n=3), a
    balance from morton to rcb (which moves rows between the ranks), the
    flagged cells of the end state, and the CFL step of a state whose
    partitions 2 and 3 move three times faster."""
    app = AmrAdvection(length=(8, 8, 1), max_refinement_level=1,
                       device=device)
    out = {"dt0": app.max_time_step(), "m0": app.total_mass()}
    app.run(6, adapt_n=3)
    app.grid.set_load_balancing_method("rcb")
    app.balance()
    g = app.grid
    out.update(dt=app.max_time_step(), m=app.total_mass(),
               cells=g.plan.cells.tolist(), owner=g.plan.owner.tolist())
    rows = held_rows(g)
    g.update_copies_of_remote_neighbors(fields=["density"])
    g.apply_stencil(app._diff_kernel, ["density", "ilen"], ["max_diff"])
    ids, codes = app._flagged_cells()
    out["flagged"] = sorted(zip(ids.tolist(), codes.tolist()))
    scale_partitions(g, "vx", (2, 3), 3.0)
    app._cfl_cache = None
    out["dt_fast"] = app.max_time_step()
    return rows, out


def mhd_case(device, dts):
    """GridMHD at tests/test_torch_zoo.py's random8 state: three run(2)
    at the given steps, the CFL step before each, the conserved sums
    before and after, and the CFL step of a state whose partitions 2
    and 3 carry four times the momentum."""
    m = GridMHD(device=device, **MHD_KW)
    out = {"sums0": m.conserved_sums(), "dts": []}
    b0 = halo_bytes()
    for dt in dts:
        out["dts"].append(m.max_time_step())
        m.run(2, dt=dt)
    out["halo"] = halo_bytes() - b0
    out["sums"] = m.conserved_sums()
    rows = held_rows(m.grid)
    scale_partitions(m.grid, "mx", (2, 3), 4.0)
    out["dt_fast"] = m.max_time_step()
    return rows, out


def vlasov_case(device):
    v = GridVlasov(device=device, **VLASOV_KW)
    g = v.grid
    out = {"m0": v.total_mass()}
    b0 = halo_bytes()
    v.run(VLASOV_STEPS, dt=VLASOV_DT)
    out["halo"] = halo_bytes() - b0
    cross = g._exchange_cross(DEFAULT_NEIGHBORHOOD_ID,
                              tuple(sorted(VLASOV_EXCHANGE)))
    out["moments_cross"] = (sum(cross.send_bytes.values())
                            if cross is not None else 0)
    out["m"] = v.total_mass()
    return held_rows(g), out


def drift(pos):
    return torch.stack([torch.full_like(pos[:, 0], 0.9),
                        -0.45 * torch.ones_like(pos[:, 0]),
                        0.3 * torch.cos(pos[:, 0])], dim=1)


def particle_case(device, pts):
    """tests/test_torch_particles.py's 3-D cloud at a capacity where
    only partition 1 overflows (once, in the second step)."""
    m = ParticleModel(drift, length=(8, 8, 8), capacity=PART_CAP,
                      device=device, periodic=(True, True, True))
    out = {"placed": m.add_particles(pts), "caps": []}
    for _ in range(PART_STEPS):
        m.step(PART_DT)
        out["caps"].append(m.capacity)
    g = m.grid
    mine = g._owned_subset(g.get_cells())
    arrays = dict(held_rows(g, ["pos", "count"]), cells=mine,
                  counts=m.counts(), particles=m.particles())
    return arrays, out


def scale_case(device):
    m = ScalabilityModel(device=device, **SCALE_KW)
    rep = m.run(steps=2, warmup=0)
    keys = ("n_devices", "n_cells", "halo_bytes_per_step",
            "rank_halo_bytes_per_step")
    return held_rows(m.grid), {k: rep[k] for k in keys}


def dense_fields(seed_arrays, grid):
    for n in ("u", "v"):
        grid.arrays[n] = grid.hold(torch.as_tensor(seed_arrays[n]))


def dense_step_fn(grid):
    """tests/test_torch_dense_mesh.py's step: the block's mesh position,
    a blocked extra and a whole extra."""
    length = grid.length

    def fn(b, ext, w):
        u = b["u"]
        core = u[1:-1, 1:-1, 1:-1]
        nloc = core.shape
        out = u[2:, 1:-1, 1:-1] - u[:-2, 1:-1, 1:-1] + ext[1:-1, 1:-1, 1:-1]
        for d in range(3):
            shape = [1, 1, 1]
            shape[d] = nloc[d]
            glob = (grid.axis_index("xyz"[d]) * nloc[d]
                    + torch.arange(nloc[d]).view(shape))
            out = torch.where(glob == length[d] - 1, out + w, out)
        return {"v": out, "u": core - w}
    return fn


def dense_case(device, seed_arrays, adv_dt, rhs):
    """The mesh itself (the pads and a step) on DENSE_SHAPE, the
    AdvectionSolver there, and DensePoissonSolver on POISSON_SHAPE:
    {name: this process's layout}, scalars."""
    out, arrays = {}, {}
    g = DenseGrid(DENSE_LEN, {"u": torch.float32, "v": torch.float32},
                  mesh=dense_mesh(device, DENSE_SHAPE),
                  periodic=DENSE_PERIODIC, start=(0.0, 1.0, -1.0),
                  cell_length=(0.5, 0.25, 0.125))
    dense_fields(seed_arrays, g)
    for h in (1, 2):
        arrays[f"pad{h}"] = g.pad_with_halo(g.arrays["u"], h, -1.5)
    ext = g.pad_with_halo(g.arrays["v"], 1)
    step = g.make_step(dense_step_fn(g), ("u",), ("v", "u"), halo=1,
                       boundary=2.0, extra_specs=(BLOCKS, WHOLE))
    got = step(g.arrays, ext, torch.tensor(np.float32(0.75)))
    arrays["step_u"], arrays["step_v"] = got["u"], got["v"]
    out["x_bytes"] = g.exchange_bytes(1)
    out["x_cross"] = g.exchange_bytes(1, cross_rank=True)
    try:
        g.to_host("u")
        out["to_host"] = "read"
    except RuntimeError:
        out["to_host"] = "RuntimeError"

    s = AdvectionSolver(n=ADV_N, nz=ADV_NZ,
                        mesh=dense_mesh(device, DENSE_SHAPE))
    out["adv_dt"] = s.max_time_step()
    out["adv_m0"] = s.total_mass()
    b0 = halo_bytes("slab")
    for _ in range(ADV_STEPS):
        s.step(np.float32(adv_dt))
    out["adv_slab"] = halo_bytes("slab") - b0
    out["adv_cross"] = s.grid.exchange_bytes(1, ["rho"], cross_rank=True)
    out["adv_m"] = s.total_mass()
    out["adv_l2"] = s.l2_error()
    arrays["adv_rho"] = s.grid.arrays["rho"]

    for i, periodic in enumerate(POISSON_PERIODIC):
        ps = DensePoissonSolver((POISSON_N,) * 3, periodic=periodic,
                                mesh=dense_mesh(device, POISSON_SHAPE))
        x, info = ps.solve(rhs, rtol=1e-5)
        out[f"cg{i}"] = int(info["iterations"])
        out[f"cg{i}_res"] = info["residual"]
        arrays[f"cg{i}"] = x
    return {k: v.numpy().copy() for k, v in arrays.items()}, out
'''

_WORKER = _COMMON + r'''
import json, os, sys
from dccrg_tpu_torch import coord

r, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
coord.distributed_init(f"127.0.0.1:{port}", 2, r, retries=20, backoff=0.1)
os.environ["DCCRG_BARRIER_TIMEOUT"] = "60"
PLACE = coord.rank_devices(2, "cpu")
seed = np.load(os.path.join(out_dir, "seed.npz"))
res = {}


def dump(case, arrays, extra, held):
    np.savez(os.path.join(out_dir, f"{case}_{r}.npz"), held=held, **arrays)
    res[case] = extra


rows, extra = amr_case(PLACE)
dump("amr", rows, extra, held=[0, 1] if r == 0 else [2, 3])
rows, extra = mhd_case(PLACE, seed["mhd_dts"].tolist())
dump("mhd", rows, extra, held=[0, 1] if r == 0 else [2, 3])
rows, extra = vlasov_case(PLACE)
dump("vlasov", rows, extra, held=[0, 1] if r == 0 else [2, 3])
rows, extra = particle_case(PLACE, seed["pts"])
dump("particles", rows, extra, held=[0, 1] if r == 0 else [2, 3])
rows, extra = scale_case(PLACE)
dump("scale", rows, extra, held=[0, 1] if r == 0 else [2, 3])
arrays, extra = dense_case(PLACE, {n: seed[f"dense_{n}"] for n in "uv"},
                           float(seed["adv_dt"]), seed["rhs"])
dump("dense", arrays, extra, held=[0, 1] if r == 0 else [2, 3])
res["bytes"] = {leg: halo_bytes(leg) for leg in ("halo", "rows", "slab")}
print("RESULT " + json.dumps(res), flush=True)
try:
    coord.barrier("end", timeout=60)
except Exception:
    pass
os._exit(0)
'''

_ns: dict = {}
exec(compile(_COMMON, "<ranks models common>", "exec"), _ns)
ONE = ["cpu"] * 4


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("dev",))


def _dense_blocks(whole, shape, ext=None):
    """The blocks of a whole (one-process) dense tensor in mesh order;
    ``ext`` is the block extent (the padded one of a padded array)."""
    if ext is None:
        ext = tuple(whole.shape[d] // shape[d] for d in range(3))
    out = []
    for i in range(shape[0]):
        for j in range(shape[1]):
            for k in range(shape[2]):
                out.append(whole[i * ext[0]:(i + 1) * ext[0],
                                 j * ext[1]:(j + 1) * ext[1],
                                 k * ext[2]:(k + 1) * ext[2]])
    return np.stack(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks_models")
    C = _ns
    ref, one = {}, {}
    # the seeds: the reference's MHD steps, the particle cloud, the
    # dense fields, the advection step and the Poisson rhs
    rm = ref_mhd.GridMHD(mesh=mesh_of(4), **C["MHD_KW"])
    dts = []
    for _ in range(3):
        dts.append(0.4 * rm.max_time_step())
        rm.run(2, dt=dts[-1])
    ref["mhd"] = {n: np.asarray(rm.grid.data[n]) for n in C["MHD_ALL"]}
    rng = np.random.default_rng(11)
    seed = {
        "mhd_dts": np.asarray(dts),
        "pts": np.random.default_rng(7).uniform(0, 8, (500, 3))
        .astype(np.float32),
        "dense_u": rng.standard_normal(C["DENSE_LEN"]).astype(np.float32),
        "dense_v": rng.standard_normal(C["DENSE_LEN"]).astype(np.float32)}
    adv_ref = RefAdvection(n=C["ADV_N"], nz=C["ADV_NZ"],
                           mesh=ref_mesh(jax.devices()[:4], C["DENSE_SHAPE"]))
    seed["adv_dt"] = np.float64(0.4 * adv_ref.max_time_step())
    rhs = np.random.default_rng(5).standard_normal((C["POISSON_N"],) * 3)
    seed["rhs"] = (rhs - rhs.mean()).astype(np.float32)
    np.savez(out / "seed.npz", **seed)
    procs = start_ranks(_WORKER, out)

    # meanwhile: the one-process port and the reference
    one["amr"] = C["amr_case"](ONE)
    one["mhd"] = C["mhd_case"](ONE, dts)
    one["vlasov"] = C["vlasov_case"](ONE)
    one["particles"] = C["particle_case"](ONE, seed["pts"])
    one["scale"] = C["scale_case"](ONE)
    one["dense"] = C["dense_case"](ONE, {n: seed[f"dense_{n}"] for n in "uv"},
                                   float(seed["adv_dt"]), seed["rhs"])

    ra = RefAmr(length=(8, 8, 1), max_refinement_level=1, mesh=mesh_of(4))
    ra.run(6, adapt_n=3)
    ra.grid.set_load_balancing_method("rcb")
    ra.balance()
    ref["amr"] = {"cells": ra.grid.plan.cells, "owner": ra.grid.plan.owner,
                  "density": np.asarray(ra.grid.data["density"]),
                  "dt": ra.max_time_step(), "m": ra.total_mass()}
    rv = ref_vlasov.GridVlasov(mesh=mesh_of(4), **C["VLASOV_KW"])
    rv.run(C["VLASOV_STEPS"], dt=C["VLASOV_DT"])
    ref["vlasov"] = {n: np.asarray(rv.grid.data[n]) for n in C["VLASOV_FIELDS"]}
    rs = RefScale(mesh=mesh_of(4), **C["SCALE_KW"])
    for _ in range(2):
        rs.step()
    ref["scale"] = np.asarray(rs.grid.data["payload"])
    ref["dense"] = _ref_dense(seed, C)
    for _ in range(C["ADV_STEPS"]):
        adv_ref.step(np.float32(seed["adv_dt"]))
    ref["adv"] = {"rho": np.asarray(adv_ref.grid.to_host("rho"), np.float64),
                  "m": adv_ref.total_mass()}
    for i, periodic in enumerate(C["POISSON_PERIODIC"]):
        rp = RefDensePoisson((C["POISSON_N"],) * 3, periodic=periodic,
                             mesh=ref_mesh(jax.devices()[:4],
                                           C["POISSON_SHAPE"]))
        x, info = rp.solve(seed["rhs"], rtol=1e-5)
        ref[f"cg{i}"] = (np.asarray(x, np.float64), int(info["iterations"]))

    res = collect_ranks(procs)

    def held(case, r):
        return dict(np.load(out / f"{case}_{r}.npz"))

    return {"ref": ref, "one": one, "res": res, "held": held}


def _ref_dense(seed, C):
    """The reference's pads and step of ``dense_case`` on its mesh."""
    rd = RefDenseGrid(C["DENSE_LEN"], {"u": jnp.float32, "v": jnp.float32},
                      mesh=ref_mesh(jax.devices()[:4], C["DENSE_SHAPE"]),
                      periodic=C["DENSE_PERIODIC"], start=(0.0, 1.0, -1.0),
                      cell_length=(0.5, 0.25, 0.125))
    for n in ("u", "v"):
        rd.arrays[n] = jax.device_put(jnp.asarray(seed[f"dense_{n}"]),
                                      rd.sharding())
    out = {}
    for h in (1, 2):
        pad = jax.jit(_shard_map(lambda b, h=h: rd.pad_with_halo(b, h, -1.5),
                                 mesh=rd.mesh, in_specs=P(*AXES),
                                 out_specs=P(*AXES)))
        out[f"pad{h}"] = np.asarray(pad(rd.arrays["u"]))
    pad1 = jax.jit(_shard_map(lambda b: rd.pad_with_halo(b, 1),
                              mesh=rd.mesh, in_specs=P(*AXES),
                              out_specs=P(*AXES)))
    length = C["DENSE_LEN"]

    def fn(b, ext, w):
        from jax import lax

        u = b["u"]
        core = u[1:-1, 1:-1, 1:-1]
        nloc = core.shape
        o = u[2:, 1:-1, 1:-1] - u[:-2, 1:-1, 1:-1] + ext[1:-1, 1:-1, 1:-1]
        for d in range(3):
            pos = lax.axis_index(AXES[d])
            glob = pos * nloc[d] + lax.broadcasted_iota(jnp.int32, nloc, d)
            o = jnp.where(glob == length[d] - 1, o + w, o)
        return {"v": o, "u": core - w}

    step = rd.make_step(fn, ("u",), ("v", "u"), halo=1, boundary=2.0,
                        extra_specs=(P(*AXES), P()))
    got = step(rd.arrays, pad1(rd.arrays["v"]), jnp.float32(0.75))
    out["step_u"], out["step_v"] = np.asarray(got["u"]), np.asarray(got["v"])
    return out


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _assert_held(runs, case, want, names, exact=True, **tol):
    """Each rank's rows of ``names`` are its two partitions' rows of
    ``want`` (``{name: [4, R, ...]}``): bit for bit, or within ``tol``."""
    for r in HELD:
        got = runs["held"](case, r)
        for n in names:
            a, b = got[n], np.asarray(want[n])[list(HELD[r])]
            assert a.shape == b.shape, (case, n, a.shape, b.shape)
            if exact:
                np.testing.assert_array_equal(_bits(a), _bits(b),
                                              err_msg=f"{case} rank {r} {n}")
            else:
                np.testing.assert_allclose(a, b, err_msg=f"{case} {r} {n}",
                                           **tol)


def _same_on_ranks(runs, case, key):
    vals = [runs["res"][r][case][key] for r in HELD]
    assert vals[0] == vals[1], (case, key, vals)
    return vals[0]


# -- AmrAdvection -----------------------------------------------------------

def test_amr_advection_across_ranks(runs):
    """run(6, adapt_n=3) and a balance to rcb: the cell set and owners are the
    one process's and the reference's; the held rows are the one
    process's bit for bit and the reference's within rtol 1e-5, atol
    1e-7; the CFL step and the mass are the same on both ranks and the
    one process's."""
    rows, want = runs["one"]["amr"]
    rref = runs["ref"]["amr"]
    for r in HELD:
        got = runs["res"][r]["amr"]
        for w in (want, rref):
            np.testing.assert_array_equal(np.asarray(got["cells"], np.uint64),
                                          np.asarray(w["cells"], np.uint64))
            np.testing.assert_array_equal(got["owner"], w["owner"])
    _assert_held(runs, "amr", rows, list(rows))
    _assert_held(runs, "amr", {"density": rref["density"]}, ["density"],
                 exact=False, rtol=1e-5, atol=1e-7)
    for key in ("dt0", "m0", "dt", "m"):
        assert _same_on_ranks(runs, "amr", key) == want[key], key
    assert want["dt"] == rref["dt"]
    assert want["m"] == pytest.approx(rref["m"], rel=1e-6)
    assert abs(want["m"] - want["m0"]) < 1e-5 * want["m0"]


def test_fault_amr_cfl_step_is_the_group_minimum(runs):
    """Partitions 2 and 3 (rank 1's) move three times faster: both ranks
    take the one process's step, the minimum over every partition."""
    dt = _same_on_ranks(runs, "amr", "dt_fast")
    assert dt == runs["one"]["amr"][1]["dt_fast"]
    assert dt < runs["one"]["amr"][1]["dt"]


def test_fault_amr_flags_own_cells(runs):
    """The adaptation criterion's rows are held slots: each rank flags
    cells of its own partitions, and the ranks' flags together are the
    one process's."""
    want = runs["one"]["amr"][1]["flagged"]
    got, owner = [], np.asarray(runs["res"][0]["amr"]["owner"])
    cells = np.asarray(runs["res"][0]["amr"]["cells"], np.uint64)
    for r in HELD:
        mine = runs["res"][r]["amr"]["flagged"]
        pos = np.searchsorted(cells, np.asarray([c for c, _ in mine],
                                                np.uint64))
        assert set(owner[pos].tolist()) <= set(HELD[r])
        got += mine
    assert len(want) > 0
    assert sorted(map(tuple, got)) == [tuple(x) for x in want]


# -- GridMHD and GridVlasov --------------------------------------------------

def test_mhd_across_ranks(runs):
    """Three run(2) at the reference's steps: the held rows bit for bit
    with one process and within rtol 1e-6, atol 1e-6 of the reference;
    each CFL step and the conserved sums before and after the same on
    both ranks and the one process's; both exchanges crossed ranks."""
    rows, want = runs["one"]["mhd"]
    names = list(rows)
    _assert_held(runs, "mhd", rows, names)
    _assert_held(runs, "mhd", runs["ref"]["mhd"], names, exact=False,
                 rtol=1e-6, atol=1e-6)
    for key in ("dts", "sums0", "sums"):
        assert _same_on_ranks(runs, "mhd", key) == want[key], key
    for r in HELD:
        assert runs["res"][r]["mhd"]["halo"] > 0


def test_fault_mhd_cfl_step_is_the_group_maximum(runs):
    """Rank 1's partitions carry four times the momentum: both ranks
    take the one process's step."""
    dt = _same_on_ranks(runs, "mhd", "dt_fast")
    assert dt == runs["one"]["mhd"][1]["dt_fast"]
    assert dt < runs["one"]["mhd"][1]["dts"][-1]


def test_vlasov_across_ranks(runs):
    """Six steps: the held rows bit for bit with one process and within
    rtol 1e-6, atol 1e-6 of the reference, the mass the same on both
    ranks and the one process's, and only the moments crossed ranks:
    one exchange of them per step."""
    rows, want = runs["one"]["vlasov"]
    names = list(rows)
    _assert_held(runs, "vlasov", rows, names)
    _assert_held(runs, "vlasov", runs["ref"]["vlasov"], names, exact=False,
                 rtol=1e-6, atol=1e-6)
    for key in ("m0", "m"):
        assert _same_on_ranks(runs, "vlasov", key) == want[key], key
    steps = _ns["VLASOV_STEPS"]
    for r in HELD:
        got = runs["res"][r]["vlasov"]
        assert got["moments_cross"] > 0
        assert got["halo"] == steps * got["moments_cross"], got


# -- particles and scalability ----------------------------------------------

def test_particles_across_ranks(runs):
    """The cloud seeded on both ranks lands once (the ranks' placements
    add up to one process's); only rank 0 overflows, and both ranks
    grow to the one process's capacity and collect again together; the
    rows, counts and particles are the one process's bit for bit."""
    arrays, want = runs["one"]["particles"]
    placed = [runs["res"][r]["particles"]["placed"] for r in HELD]
    assert sum(placed) == want["placed"] and min(placed) > 0
    caps = _same_on_ranks(runs, "particles", "caps")
    assert caps == want["caps"] and caps[-1] > _ns["PART_CAP"]
    _assert_held(runs, "particles", arrays, ["pos", "count"])
    cells, counts, pts = [], [], []
    for r in HELD:
        got = runs["held"]("particles", r)
        cells.append(got["cells"])
        counts.append(got["counts"])
        pts.append(got["particles"])
    order = np.argsort(np.concatenate(cells), kind="stable")
    np.testing.assert_array_equal(np.concatenate(cells)[order],
                                  arrays["cells"])
    np.testing.assert_array_equal(np.concatenate(counts)[order],
                                  arrays["counts"])
    assert np.concatenate(pts).tobytes() == arrays["particles"].tobytes()


def test_scalability_across_ranks(runs):
    """tests/test_torch_scalability.py's step case at four partitions:
    the rows bit for bit with one process and within rtol 1e-5, atol
    1e-6 of the reference; the report's placement, cells and group
    halo bytes the one process's, each rank's own share beside them."""
    rows, want = runs["one"]["scale"]
    _assert_held(runs, "scale", rows, ["payload"])
    _assert_held(runs, "scale", {"payload": runs["ref"]["scale"]},
                 ["payload"], exact=False, rtol=1e-5, atol=1e-6)
    shares = []
    for r in HELD:
        got = runs["res"][r]["scale"]
        for k in ("n_devices", "n_cells", "halo_bytes_per_step"):
            assert got[k] == want[k], k
        shares.append(got["rank_halo_bytes_per_step"])
    assert want["n_devices"] == 4 and want["n_cells"] == 64
    assert sum(shares) == want["halo_bytes_per_step"] == \
        want["rank_halo_bytes_per_step"]
    assert min(shares) > 0


# -- the dense mesh ------------------------------------------------------------

def _dense_held(runs, name, r):
    return runs["held"]("dense", r)[name]


@pytest.mark.parametrize("name", ["pad1", "pad2", "step_u", "step_v"])
def test_dense_mesh_blocks_across_ranks(runs, name):
    """pad_with_halo (halo 1 and 2) and make_step (the mesh position, a
    blocked and a whole extra) on a (2, 1, 2) mesh: each rank's padded
    blocks and step outputs are the one process's blocks and the
    reference's bit for bit."""
    whole = runs["one"]["dense"][0][name]
    np.testing.assert_array_equal(whole, runs["ref"]["dense"][name])
    shape = _ns["DENSE_SHAPE"]
    blocks = _dense_held(runs, name, 0).shape[1:4]
    want = _dense_blocks(whole, shape, blocks)
    for r in HELD:
        got = _dense_held(runs, name, r)
        np.testing.assert_array_equal(_bits(got),
                                      _bits(want[list(HELD[r])]))


def test_dense_mesh_surface_across_ranks(runs):
    """Each rank counts its own blocks' slabs (the ranks' counts add up
    to one process's, the cross-rank ones a part of them), and to_host
    raises on blocks that span ranks."""
    want = runs["one"]["dense"][1]
    got = [runs["res"][r]["dense"] for r in HELD]
    assert sum(g["x_bytes"] for g in got) == want["x_bytes"]
    assert want["x_cross"] == 0  # one process: no slab crosses ranks
    for g in got:
        assert 0 < g["x_cross"] < g["x_bytes"]
        assert g["to_host"] == "RuntimeError"
    assert want["to_host"] == "read"


def test_dense_advection_across_ranks(runs):
    """AdvectionSolver(16, 4) on the (2, 1, 2) mesh, 10 steps: the held
    blocks bit for bit with one process's mesh and within rtol 2e-5,
    atol 1e-6 of the reference; the CFL step, the masses and the L2
    error the same on both ranks and the one process's; each step's
    slabs crossed ranks once."""
    arrays, want = runs["one"]["dense"]
    shape = _ns["DENSE_SHAPE"]
    blocks = _dense_blocks(arrays["adv_rho"], shape)
    rblocks = _dense_blocks(runs["ref"]["adv"]["rho"], shape)
    for r in HELD:
        got = _dense_held(runs, "adv_rho", r)
        np.testing.assert_array_equal(_bits(got), _bits(blocks[list(HELD[r])]))
        np.testing.assert_allclose(got, rblocks[list(HELD[r])], rtol=2e-5,
                                   atol=1e-6)
    for key in ("adv_dt", "adv_m0", "adv_m", "adv_l2"):
        assert _same_on_ranks(runs, "dense", key) == want[key], key
    assert abs(want["adv_m"] - runs["ref"]["adv"]["m"]) < 1e-6
    for r in HELD:
        got = runs["res"][r]["dense"]
        assert got["adv_slab"] == _ns["ADV_STEPS"] * got["adv_cross"] > 0


@pytest.mark.parametrize("case", [0, 1])
def test_dense_poisson_across_ranks(runs, case):
    """DensePoissonSolver(8^3) on a (1, 2, 2) mesh, periodic and with a
    Neumann z: the dots reduce over the group, so both ranks run the one
    process's iterations and hold its solution's blocks bit for bit; the
    reference's within 2 iterations and 1e-4 of its peak."""
    arrays, want = runs["one"]["dense"]
    shape = _ns["POISSON_SHAPE"]
    its = _same_on_ranks(runs, "dense", f"cg{case}")
    assert its == want[f"cg{case}"] > 0
    assert _same_on_ranks(runs, "dense", f"cg{case}_res") == \
        want[f"cg{case}_res"]
    blocks = _dense_blocks(arrays[f"cg{case}"], shape)
    for r in HELD:
        got = _dense_held(runs, f"cg{case}", r)
        np.testing.assert_array_equal(_bits(got), _bits(blocks[list(HELD[r])]))
    xr, ir = runs["ref"][f"cg{case}"]
    assert abs(its - ir) <= 2
    assert np.abs(arrays[f"cg{case}"] - xr).max() <= 1e-4 * np.abs(xr).max()


def test_rows_and_slabs_crossed_ranks(runs):
    """The halo rows, the balance's moved rows and the dense slabs
    crossed ranks on both ranks, each under its own leg."""
    for r in HELD:
        b = runs["res"][r]["bytes"]
        assert b["halo"] > 0 and b["rows"] > 0 and b["slab"] > 0, b


def test_dense_mesh_placement_rules():
    """``dense_mesh`` takes ``(rank, device)`` entries: all of one rank
    is a one-process mesh; a second rank needs a group of two; distinct
    devices of one rank put each block on its own device, and ``meta``
    is refused."""
    from dccrg_tpu_torch.dense import dense_mesh

    m = dense_mesh([(0, "cpu")] * 4, (2, 1, 2))
    assert m.ranks is None and m.held.tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="process group has 1 rank"):
        dense_mesh([(0, "cpu"), (1, "cpu")])
    m = dense_mesh([(0, "cpu:0"), (0, "cpu:1")])
    assert m.ranks is None and m.spans_devices
    assert [(str(d), sl) for d, sl in m.groups] == [("cpu:0", [0]),
                                                    ("cpu:1", [1])]
    with pytest.raises(ValueError, match="meta"):
        dense_mesh([(0, "cpu"), (0, "meta")])
