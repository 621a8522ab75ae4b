"""The port's grid metadata against the reference package, bit for bit.

``dccrg_tpu_torch`` keeps its own copies of the host-side metadata
modules (mapping, length, topology, geometry, neighborhoods). The same
random cells and coordinates, made from a seed with numpy, go through
both packages and must give identical arrays. The last tests pin the
port's import hygiene: importing it never loads ``jax`` and no module
of the port (or ``chip_smoke.py``) imports ``jax`` or ``dccrg_tpu``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import dccrg_tpu as ref
import dccrg_tpu_torch as port

REPO = Path(__file__).resolve().parent.parent

CASES = [((5, 7, 3), 3), ((1, 1, 1), 4), ((16, 4, 9), 2), ((3, 3, 3), 0)]


def _random_cells(mapping, n, seed):
    rng = np.random.default_rng(seed)
    last = int(mapping.get_last_cell())
    return rng.integers(1, last + 1, size=n, dtype=np.uint64)


@pytest.mark.parametrize("length,max_lvl", CASES)
def test_mapping_matches_reference(length, max_lvl):
    mr = ref.Mapping(length, max_lvl)
    mp = port.Mapping(length, max_lvl)
    assert mr.get_maximum_possible_refinement_level() == \
        mp.get_maximum_possible_refinement_level()
    assert int(mr.get_last_cell()) == int(mp.get_last_cell())
    np.testing.assert_array_equal(mr.get_index_length(), mp.get_index_length())
    cells = _random_cells(mr, 4000, seed=sum(length) + max_lvl)
    for name in ("get_refinement_level", "get_indices",
                 "get_cell_length_in_indices", "get_parent",
                 "get_level_0_parent", "get_child", "get_all_children",
                 "get_siblings"):
        a = getattr(mr, name)(cells)
        b = getattr(mp, name)(cells)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    # ids <-> indices round trip at every level
    idx = mr.get_indices(cells)
    for lvl in range(max_lvl + 1):
        np.testing.assert_array_equal(
            mr.get_cell_from_indices(idx, lvl),
            mp.get_cell_from_indices(idx, lvl))
    assert mp.to_bytes() == mr.to_bytes()


def test_grid_length_and_topology_match_reference():
    for length in ((1, 1, 1), (5, 7, 3), (512, 512, 512)):
        a, b = ref.GridLength(length), port.GridLength(length)
        np.testing.assert_array_equal(a.get(), b.get())
        assert a.total_level0_cells == b.total_level0_cells
    with pytest.raises(ValueError):
        port.GridLength((0, 1, 1))
    for per in ((False, False, False), (True, False, True)):
        a, b = ref.GridTopology(per), port.GridTopology(per)
        assert a.to_bytes() == b.to_bytes()
        assert [a.is_periodic(d) for d in range(3)] == \
            [b.is_periodic(d) for d in range(3)]


def _geometries(pkg, length, max_lvl, periodic):
    m = pkg.Mapping(length, max_lvl)
    t = pkg.GridTopology(periodic)
    rng = np.random.default_rng(11)
    coords = [np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 2.0, n))]) - 3.0
              for n in length]
    return m, {
        "none": pkg.NoGeometry(m, t),
        "cartesian": pkg.CartesianGeometry(m, t, start=(-1.0, 0.5, 2.0),
                                           level_0_cell_length=(0.25, 1.5, 0.1)),
        "stretched": pkg.StretchedCartesianGeometry(m, t, coordinates=coords),
    }


@pytest.mark.parametrize("kind", ["none", "cartesian", "stretched"])
def test_geometry_matches_reference(kind):
    length, max_lvl, periodic = (5, 7, 3), 3, (True, False, True)
    mr, gr = _geometries(ref, length, max_lvl, periodic)
    _mp, gp = _geometries(port, length, max_lvl, periodic)
    gr, gp = gr[kind], gp[kind]
    cells = _random_cells(mr, 3000, seed=5)
    for name in ("get_center", "get_min", "get_max", "get_length"):
        np.testing.assert_array_equal(getattr(gr, name)(cells),
                                      getattr(gp, name)(cells), err_msg=name)
    np.testing.assert_array_equal(gr.get_start(), gp.get_start())
    np.testing.assert_array_equal(gr.get_end(), gp.get_end())
    rng = np.random.default_rng(3)
    lo, hi = gr.get_start(), gr.get_end()
    pts = lo + (hi - lo) * rng.uniform(-0.2, 1.2, size=(2000, 3))
    for lvl in range(max_lvl + 1):
        np.testing.assert_array_equal(gr.get_cell(lvl, pts),
                                      gp.get_cell(lvl, pts))
    np.testing.assert_array_equal(gr.get_real_coordinate(pts),
                                  gp.get_real_coordinate(pts))
    assert gr.to_bytes() == gp.to_bytes()


@pytest.mark.parametrize("length", [0, 1, 2])
def test_neighborhoods_match_reference(length):
    from dccrg_tpu.neighbors import make_neighborhood, validate_neighborhood

    a = make_neighborhood(length)
    b = port.make_neighborhood(length)
    np.testing.assert_array_equal(a, b)
    sub = a[: max(1, len(a) // 2)]
    np.testing.assert_array_equal(validate_neighborhood(sub, max(length, 1)),
                                  port.validate_neighborhood(sub, max(length, 1)))


def test_import_leaves_jax_out():
    """Importing every module of the port loads neither jax nor the
    reference package."""
    code = (
        "import sys\n"
        "import dccrg_tpu_torch, dccrg_tpu_torch.convert\n"
        "import dccrg_tpu_torch.models.advection\n"
        "import dccrg_tpu_torch.ops.roll_executor\n"
        "import dccrg_tpu_torch.ops.advection_kernel\n"
        "import dccrg_tpu_torch.ops.poisson_kernel\n"
        "import dccrg_tpu_torch.models.poisson, dccrg_tpu_torch.dense\n"
        "import dccrg_tpu_torch.fleet, dccrg_tpu_torch.integrity\n"
        "import dccrg_tpu_torch.checkpoint, dccrg_tpu_torch.faults\n"
        "import dccrg_tpu_torch.resilience\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'dccrg_tpu'\n"
        "             or m.startswith('dccrg_tpu.') or m == 'ml_dtypes')\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    files = sorted((REPO / "dccrg_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "dccrg_tpu"), \
                f"{path.relative_to(REPO)} imports {mod}"
