"""The port's particle tracker (models/particles.py) against the
reference, on the CPU: tests/test_particles.py's scenarios on both
packages, the same seeds, counts equal and positions within ``atol
1e-6`` (the reference test's own tolerance across device counts; the
drift and wrap scenarios agree bit for bit). Inside the port, four
partitions give one partition's positions and counts bit for bit, and
an overflowing collect is rolled back to a copy of the buffers, not to
the tensors the halo update writes in place.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from dccrg_tpu.models.particles import ParticleModel as RefModel

from dccrg_tpu_torch.models.particles import ParticleModel

TOL = dict(atol=1e-6, rtol=0)


def mesh_of(n):
    return Mesh(np.array(jax.devices()[:n]), ("dev",))


def ref_drift_x(pos):
    return jnp.zeros_like(pos).at[:, 0].set(1.0)


def drift_x(pos):
    v = torch.zeros_like(pos)
    v[:, 0] = 1.0
    return v


def ref_converge(pos):
    return jnp.zeros_like(pos).at[:, 0].set(jnp.sign(2.25 - pos[:, 0]))


def converge(pos):
    v = torch.zeros_like(pos)
    v[:, 0] = torch.sign(2.25 - pos[:, 0])
    return v


def ref_swirl(pos):
    return jnp.stack([jnp.ones(pos.shape[0]), 0.3 * jnp.sin(pos[:, 0]),
                      jnp.zeros(pos.shape[0])], axis=1)


def swirl(pos):
    return torch.stack([torch.ones(pos.shape[0]), 0.3 * torch.sin(pos[:, 0]),
                        torch.zeros(pos.shape[0])], dim=1)


def pair(vel, ref_vel, n_dev=1, **kw):
    return (RefModel(ref_vel, mesh=mesh_of(n_dev), **kw),
            ParticleModel(vel, device=["cpu"] * n_dev, **kw))


def _sorted(p):
    return p[np.lexsort(p.T)]


def assert_same(r, p, bitwise=False):
    np.testing.assert_array_equal(p.counts(), r.counts())
    a, b = _sorted(np.asarray(r.particles())), _sorted(p.particles())
    assert a.shape == b.shape
    if bitwise:
        assert a.tobytes() == b.tobytes()
    else:
        np.testing.assert_allclose(b, a, **TOL)


def test_seeding_and_counts():
    pts = [[0.5, 0.5, 0.5], [0.6, 0.5, 0.5], [3.5, 0.5, 0.5], [9.0, 0.5, 0.5]]
    r, p = pair(drift_x, ref_drift_x, 2, length=(4, 1, 1), capacity=4)
    assert p.add_particles(pts) == r.add_particles(pts) == 3
    np.testing.assert_array_equal(p.counts(), [2, 0, 0, 1])
    assert_same(r, p, bitwise=True)


def test_seeding_matches_reference_order_and_capacity(rng):
    """Many particles into few cells, beyond capacity: the same ones
    are kept, in the same slots."""
    pts = np.column_stack([rng.uniform(-0.5, 4.5, 40), rng.uniform(0, 1, 40),
                           rng.uniform(0, 1, 40)]).astype(np.float32)
    r, p = pair(drift_x, ref_drift_x, 2, length=(4, 1, 1), capacity=6)
    assert p.add_particles(pts) == r.add_particles(pts)
    assert p.add_particles(pts[:7]) == r.add_particles(pts[:7])
    cells = p.grid.get_cells()
    assert (np.asarray(r.grid.get("pos", cells)).tobytes()
            == p.grid.get("pos", cells).tobytes())
    np.testing.assert_array_equal(p.counts(), r.counts())


@pytest.mark.parametrize("n_dev", [1, 4])
def test_particles_drift_across_cells_and_partitions(n_dev):
    start = np.array([[0.5, 0.5, 0.5], [0.25, 0.4, 0.6], [2.5, 0.5, 0.5]],
                     np.float32)
    r, p = pair(drift_x, ref_drift_x, n_dev, length=(8, 1, 1), capacity=8)
    r.add_particles(start)
    p.add_particles(start)
    for _ in range(10):
        r.step(0.5)
        p.step(0.5)
    assert_same(r, p, bitwise=True)
    cnt = p.counts()
    assert cnt.sum() == 3 and cnt[5] == 2 and cnt[7] == 1


def test_particles_leave_grid():
    r, p = pair(drift_x, ref_drift_x, 1, length=(2, 1, 1), capacity=4)
    for m in (r, p):
        m.add_particles([[1.5, 0.5, 0.5]])
        for _ in range(3):
            m.step(0.4)
    assert len(p.particles()) == 0 == len(r.particles())


def test_capacity_overflow_grows_and_preserves_particles():
    pts = [[0.7, 0.5, 0.5], [1.2, 0.3, 0.5], [2.7, 0.5, 0.5], [3.2, 0.6, 0.5]]
    r, p = pair(converge, ref_converge, 1, length=(4, 1, 1), capacity=2)
    for m in (r, p):
        m.add_particles(pts)
        for _ in range(8):
            m.step(0.4)
    assert p.capacity == r.capacity > 2
    assert len(p.particles()) == 4
    assert_same(r, p, bitwise=True)


def test_overflow_rollback_restores_a_copy():
    """The collect that overflows is redone from the buffers as they
    were before it: the same result as a model that had the larger
    capacity all along, on two partitions."""
    pts = [[0.7, 0.5, 0.5], [1.2, 0.3, 0.5], [2.7, 0.5, 0.5], [3.2, 0.6, 0.5]]
    grown = ParticleModel(converge, length=(4, 1, 1), capacity=2,
                          device=["cpu"] * 2)
    big = ParticleModel(converge, length=(4, 1, 1), capacity=2,
                        device=["cpu"] * 2)
    for m in (grown, big):
        m.add_particles(pts)
    for _ in range(8):
        grown.step(0.4)
    assert grown.capacity > 2
    big.ensure_capacity(grown.capacity)
    for _ in range(8):
        big.step(0.4)
    assert big.capacity == grown.capacity
    assert _sorted(big.particles()).tobytes() == \
        _sorted(grown.particles()).tobytes()


def test_ensure_capacity_grows_buffers():
    r, p = pair(drift_x, ref_drift_x, 2, length=(4, 1, 1), capacity=2)
    for m in (r, p):
        m.add_particles([[0.2, 0.5, 0.5], [0.6, 0.5, 0.5]])
        m.ensure_capacity(8)
        assert m.capacity == 8
        assert len(m.particles()) == 2
        m.add_particles([[0.3, 0.5, 0.5]] * 5)
        assert m.counts()[0] == 7
        m.step(0.25)
        assert len(m.particles()) == 7
    assert p.grid.data["pos"].shape[2] == 8
    assert p.grid.fields["pos"] == ((8, 3), torch.float32)
    assert_same(r, p, bitwise=True)


def test_partition_invariance(rng):
    pts = np.column_stack([rng.uniform(0, 8, 12), rng.uniform(0, 1, 12),
                           rng.uniform(0, 1, 12)]).astype(np.float32)
    out = []
    for n in (1, 8):
        m = ParticleModel(swirl, length=(8, 1, 1), capacity=16,
                          device=["cpu"] * n)
        m.add_particles(pts)
        for _ in range(6):
            m.step(0.3)
        out.append(m)
    assert _sorted(out[0].particles()).tobytes() == \
        _sorted(out[1].particles()).tobytes()
    np.testing.assert_array_equal(out[0].counts(), out[1].counts())
    r = RefModel(ref_swirl, length=(8, 1, 1), capacity=16, mesh=mesh_of(8))
    r.add_particles(pts)
    for _ in range(6):
        r.step(0.3)
    assert_same(r, out[1])


def test_periodic_wrap_preserves_particles():
    r, p = pair(drift_x, ref_drift_x, 2, length=(4, 1, 1), capacity=4,
                periodic=(True, False, False))
    for m in (r, p):
        m.add_particles([[3.6, 0.5, 0.5]])
        for _ in range(4):
            m.step(0.5)
    got = p.particles()
    assert len(got) == 1
    np.testing.assert_allclose(got[0, 0], (3.6 + 2.0) % 4.0, atol=1e-5)
    assert_same(r, p, bitwise=True)


def test_3d_cloud_four_partitions_bitwise():
    """A 3-D drift crossing cells in every direction on a periodic 8³
    grid: four partitions against one, positions and counts bit for
    bit, the particle count conserved."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 8, (500, 3)).astype(np.float32)

    def drift(pos):
        return torch.stack([torch.full_like(pos[:, 0], 0.9),
                            -0.45 * torch.ones_like(pos[:, 0]),
                            0.3 * torch.cos(pos[:, 0])], dim=1)

    res = []
    for n in (1, 4):
        m = ParticleModel(drift, length=(8, 8, 8), capacity=8,
                          device=["cpu"] * n, periodic=(True, True, True))
        assert m.add_particles(pts) == 500
        for _ in range(5):
            m.step(0.5)
        res.append((m.counts(), m.particles()))
    np.testing.assert_array_equal(res[0][0], res[1][0])
    assert res[0][1].tobytes() == res[1][1].tobytes()
    assert res[0][0].sum() == 500
