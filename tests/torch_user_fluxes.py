"""User ``SlotwiseKernel``s with no named device flux, shared by the
flux generator's CPU tests (tests/test_torch_flux_gen.py) and the card
tests (tests/test_torch_cuda.py). Imports no jax.

- :func:`weighted_kernel`, :func:`gauss_kernel`, :func:`weighted_diffuse`
  and :func:`weighted_diffuse_table`: ``dccrg_tpu_torch.user_kernels``'
  ``weighted``, ``gauss``, ``weighted_diffuse`` and its table kernel;
- :func:`mix_kernel`: two carry leaves, two outputs, a clamp, a
  division, a comparison with a float constant and an extra;
- :func:`register_weighted_diffuse` registers the twin and its table
  kernel;
- :func:`wrap_kernel`: int32 arithmetic on the slot's offset that
  overflows (ATen wraps it), read back as a sign and a float;
- the declines: a branch on a value, a sum over the cells, an op
  outside the set, a uint8 value; and a kernel whose trace raises an
  error of its own (:func:`buggy_kernel`), which is no decline.
"""

import torch

from dccrg_tpu_torch import fleet
from dccrg_tpu_torch import user_kernels
from dccrg_tpu_torch.grid import SlotwiseKernel

# the kernels the port's smoke and tile rule share (dccrg_tpu_torch/
# user_kernels.py)
weighted_kernel = user_kernels.weighted
gauss_kernel = user_kernels.gauss
weighted_diffuse = user_kernels.weighted_diffuse
weighted_diffuse_table = user_kernels.weighted_diffuse_table


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
