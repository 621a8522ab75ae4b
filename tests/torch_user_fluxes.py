"""User ``SlotwiseKernel``s with no named device flux, shared by the
flux generator's CPU tests (tests/test_torch_flux_gen.py) and the card
tests (tests/test_torch_cuda.py). Imports no jax.

- :func:`weighted_kernel`: tests/test_slotwise.py's kernel (fields ``v``
  and ``w``, writes ``v``), with weights that depend on the slot's
  offset;
- :func:`gauss_kernel`: a bfloat16 ``u`` relaxed by ``exp(-d^2) d`` of
  each neighbour difference ``d``, ``u + dt * acc``;
- :func:`mix_kernel`: two carry leaves, two outputs, a clamp, a
  division, a comparison with a float constant and an extra;
- :func:`weighted_diffuse`: the fleet twin ``weighted_diffuse`` (the
  weights of :func:`weighted_kernel` over one field ``rho``, finish
  ``rho + dt * acc``) and :func:`weighted_diffuse_table`, its table
  kernel; :func:`register_weighted_diffuse` registers both;
- :func:`wrap_kernel`: int32 arithmetic on the slot's offset that
  overflows (ATen wraps it), read back as a sign and a float;
- the declines: a branch on a value, a sum over the cells, an op
  outside the set, a uint8 value; and a kernel whose trace raises an
  error of its own (:func:`buggy_kernel`), which is no decline.
"""

import torch

from dccrg_tpu_torch import fleet
from dccrg_tpu_torch.grid import SlotwiseKernel, slot_sum

_F32 = torch.float32


def weighted_kernel():
    def init(cell, *extra):
        return torch.zeros_like(cell["v"], dtype=_F32)

    def slot(acc, cell, nbr, offs, mask, *extra):
        wgt = torch.where(mask & (offs[..., 0] == 1), 2.0,
                          torch.where(mask, 1.0, 0.0))
        return acc + wgt * torch.where(mask, nbr["v"], 0.0) + torch.where(
            mask, nbr["w"], 0.0)

    def finish(acc, cell, *extra):
        return {"v": cell["v"] + acc}

    return SlotwiseKernel(init, slot, finish)


def gauss_kernel():
    def init(cell, dt):
        return torch.zeros_like(cell["u"])

    def slot(acc, cell, nbr, offs, mask, dt):
        d = nbr["u"] - cell["u"]
        return acc + torch.where(mask, torch.exp(-d * d) * d, 0)

    def finish(acc, cell, dt):
        return {"u": cell["u"] + dt * acc}

    return SlotwiseKernel(init, slot, finish)


def mix_kernel():
    def init(cell, dt):
        return (torch.zeros_like(cell["a"]),
                {"m": torch.full_like(cell["b"], -1.0)})

    def slot(carry, cell, nbr, offs, mask, dt):
        s, rest = carry
        up = (offs[..., 2] < 0) | (offs[..., 0] > 0)
        d = torch.clamp(nbr["a"] - cell["a"], min=-0.75, max=0.75)
        s = s + torch.where(mask & up, d * 0.3, 0.0) + torch.where(
            mask, nbr["b"] / 3.0, 0.0)
        m = torch.maximum(rest["m"], torch.where(mask, nbr["b"], -1.0))
        return s, {"m": m}

    def finish(carry, cell, dt):
        s, rest = carry
        hot = cell["a"] > 0.3
        return {"a": torch.where(hot, cell["a"] - dt * s, cell["a"] + s / 7),
                "b": torch.sqrt(torch.abs(rest["m"])) + 1.0 - dt}

    return SlotwiseKernel(init, slot, finish)


def weighted_diffuse():
    def init(c, dt):
        return torch.zeros_like(c["rho"])

    def slot(acc, c, nbr, offs, mask, dt):
        wgt = torch.where(mask & (offs[..., 0] == 1), 2.0,
                          torch.where(mask, 1.0, 0.0))
        return acc + wgt * torch.where(mask, nbr["rho"] - c["rho"], 0.0)

    def finish(acc, c, dt):
        return {"rho": c["rho"] + dt * acc}

    return SlotwiseKernel(init, slot, finish)


def weighted_diffuse_table(c, nbr, offs, mask, dt):
    """The table program's kernel: the twin's sum over the slot axis in
    slot order."""
    wgt = torch.where(mask & (offs[..., 0] == 1), 2.0,
                      torch.where(mask, 1.0, 0.0))
    acc = slot_sum(wgt * torch.where(mask, nbr["rho"] - c["rho"][..., None],
                                     0.0))
    return {"rho": c["rho"] + dt * acc}


def register_weighted_diffuse():
    """Register ``weighted_diffuse``'s table kernel and its slot-wise
    twin with the port's fleet."""
    fleet.register_kernel("weighted_diffuse", weighted_diffuse_table)
    fleet.register_bulk_kernel("weighted_diffuse", weighted_diffuse())


def wrap_kernel():
    def init(cell, dt):
        return torch.zeros_like(cell["u"])

    def slot(acc, cell, nbr, offs, mask, dt):
        h = ((offs[..., 0] + 3) * 1000003 * 2047 + offs[..., 1] * 65599
             - offs[..., 2])
        s = torch.where(torch.abs(-h) > 1 << 30, 1.0, -0.5)
        return acc + torch.where(mask, nbr["u"] * s
                                 + h.to(torch.float32) * 2.0 ** -32, 0.0)

    def finish(acc, cell, dt):
        return {"u": cell["u"] + dt * acc}

    return SlotwiseKernel(init, slot, finish)


def narrow_int_kernel():
    def init(cell, dt):
        return torch.zeros_like(cell["u"])

    def slot(acc, cell, nbr, offs, mask, dt):
        k = (offs[..., 0].to(torch.uint8) * 100).to(torch.float32)
        return acc + torch.where(mask, nbr["u"] * k, 0.0)

    def finish(acc, cell, dt):
        return {"u": cell["u"] + dt * acc}

    return SlotwiseKernel(init, slot, finish)


def buggy_kernel():
    def init(cell, dt):
        return torch.zeros_like(cell["u"])

    def slot(acc, cell, nbr, offs, mask, dt):
        raise ValueError("a bug in the kernel's slot function")

    def finish(acc, cell, dt):
        return {"u": cell["u"] + dt * acc}

    return SlotwiseKernel(init, slot, finish)


def branch_kernel():
    def init(cell, dt):
        return torch.zeros_like(cell["u"])

    def slot(acc, cell, nbr, offs, mask, dt):
        if bool((nbr["u"] > 0).any()):
            return acc + nbr["u"]
        return acc

    def finish(acc, cell, dt):
        return {"u": cell["u"] + dt * acc}

    return SlotwiseKernel(init, slot, finish)


def reduce_kernel():
    def init(cell, dt):
        return torch.zeros_like(cell["u"])

    def slot(acc, cell, nbr, offs, mask, dt):
        return acc + torch.where(mask, nbr["u"], 0.0) - nbr["u"].mean()

    def finish(acc, cell, dt):
        return {"u": cell["u"] + dt * acc}

    return SlotwiseKernel(init, slot, finish)


def outside_kernel():
    def init(cell, dt):
        return torch.zeros_like(cell["u"])

    def slot(acc, cell, nbr, offs, mask, dt):
        return acc + torch.where(mask, torch.sin(nbr["u"]), 0.0)

    def finish(acc, cell, dt):
        return {"u": cell["u"] + dt * acc}

    return SlotwiseKernel(init, slot, finish)
