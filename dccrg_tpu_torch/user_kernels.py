"""User ``SlotwiseKernel``s with no named device flux: the kernels the
generated forms of kernels A and A' are checked and timed on, defined
once for ``chip_smoke.py``'s ``[user flux]``, ``python -m
dccrg_tpu_torch.gen_tile_rule`` and the tests.

- :func:`weighted`: the reference's tests/test_slotwise.py kernel
  (fields ``v`` and ``w``, writes ``v``), the weight of ``v`` 2 where
  the slot's x offset is +1;
- :func:`gauss`: a bfloat16 ``u`` relaxed by ``exp(-d^2) d`` of each
  neighbour difference ``d``, ``u + dt * acc``;
- :func:`weighted_diffuse`: the fleet twin (the weights of
  :func:`weighted` over one field ``rho``, ``rho + dt * acc``) and
  :func:`weighted_diffuse_table`, its table kernel;
- :func:`field_sum`: the sum of ``n`` float32 fields at every
  neighbour (a light slot staging ``n`` fields);
- :func:`polynomial`: a float32 ``u`` and a slot of about ``2 terms``
  float operations a neighbour (a light or heavy cell by the number of
  terms).
"""

from __future__ import annotations

import torch

from .grid import SlotwiseKernel, slot_sum

_F32 = torch.float32


def _weight(offs, mask):
    return torch.where(mask & (offs[..., 0] == 1), 2.0,
                       torch.where(mask, 1.0, 0.0))


def weighted():
    def init(cell, *extra):
        return torch.zeros_like(cell["v"], dtype=_F32)

    def slot(acc, cell, nbr, offs, mask, *extra):
        return acc + _weight(offs, mask) * torch.where(
            mask, nbr["v"], 0.0) + torch.where(mask, nbr["w"], 0.0)

    def finish(acc, cell, *extra):
        return {"v": cell["v"] + acc}

    return SlotwiseKernel(init, slot, finish)


def gauss():
    def init(cell, dt):
        return torch.zeros_like(cell["u"])

    def slot(acc, cell, nbr, offs, mask, dt):
        d = nbr["u"] - cell["u"]
        return acc + torch.where(mask, torch.exp(-d * d) * d, 0)

    def finish(acc, cell, dt):
        return {"u": cell["u"] + dt * acc}

    return SlotwiseKernel(init, slot, finish)


def weighted_diffuse():
    def init(c, dt):
        return torch.zeros_like(c["rho"])

    def slot(acc, c, nbr, offs, mask, dt):
        return acc + _weight(offs, mask) * torch.where(
            mask, nbr["rho"] - c["rho"], 0.0)

    def finish(acc, c, dt):
        return {"rho": c["rho"] + dt * acc}

    return SlotwiseKernel(init, slot, finish)


def weighted_diffuse_table(c, nbr, offs, mask, dt):
    """``weighted_diffuse``'s table kernel (the fleet's table program and
    ``run_solo``): the twin's sum over the slot axis in slot order."""
    acc = slot_sum(_weight(offs, mask) * torch.where(
        mask, nbr["rho"] - c["rho"][..., None], 0.0))
    return {"rho": c["rho"] + dt * acc}


def field_sum(n):
    """Fields ``f0`` .. ``f{n-1}``, writes ``f0``: ``f0`` plus every
    field at every valid neighbour."""
    names = [f"f{i}" for i in range(n)]

    def init(cell, dt):
        return torch.zeros_like(cell["f0"])

    def slot(acc, cell, nbr, offs, mask, dt):
        for f in names:
            acc = acc + torch.where(mask, nbr[f], 0.0)
        return acc

    def finish(acc, cell, dt):
        return {"f0": cell["f0"] + dt * acc}

    return SlotwiseKernel(init, slot, finish)


def polynomial(terms):
    """A float32 ``u``: each valid neighbour's difference ``d`` adds
    ``d (1 + d (1 + d (...)))`` to the sum, ``terms`` levels deep."""

    def init(cell, dt):
        return torch.zeros_like(cell["u"])

    def slot(acc, cell, nbr, offs, mask, dt):
        d = nbr["u"] - cell["u"]
        p = torch.ones_like(d)
        for _ in range(terms):
            p = p * d + 0.5
        return acc + torch.where(mask, p, 0.0)

    def finish(acc, cell, dt):
        return {"u": cell["u"] + dt * acc}

    return SlotwiseKernel(init, slot, finish)
