"""Lowers a user ``SlotwiseKernel`` into a CUDA flux functor for kernels
A and A'.

The reference's bulk executor traces any ``SlotwiseKernel``'s ``init``,
``slot`` and ``finish`` into its Pallas body
(``dccrg_tpu/ops/roll_executor.py:279-310``). This module is the port's
counterpart: :func:`lower` traces the three functions with
``torch.fx.experimental.proxy_tensor.make_fx`` on data-free ``meta``
tensors of ``L_TRACE`` cells (the cell fields and neighbour columns in
their storage dtypes, ``offs`` int32 ``[3]``, ``mask`` bool, the extras
as float32 0-d host tensors, or ``[1]`` device columns for a fleet
bucket) and lowers the aten graphs into a typed program (:class:`Prog`)
over a functor's registers, then into the C++ text of a flux functor
(:meth:`Flux.functor`) and, since a grid's slot table is fixed for its
life, of the table's slot sequence (:meth:`Flux.slots_text`), which the
hand-written templates of ``csrc/gen_tiles.cuh`` (the tiled routes)
and ``csrc/bulk_direct.cuh`` (the runtime-table routes) instantiate:
:func:`source` writes one source a (flux, table).

Every operation rounds as the plain PyTorch version rounds it on the
target device: it computes in float32 and rounds to bfloat16 wherever
the node's result is bfloat16, and an operand that ATen reads as a CPU
scalar (a 0-d host tensor or a Python number beside a device tensor) is
read the way :func:`aten_semantics` measured the device to read it: at
float32 ("opmath") or rounded to the op's dtype ("cast"), and a divisor
either divided by or multiplied by its reciprocal. Values that depend
only on the extras and constants are what the plain path computes on
the host: they are computed there by the same aten ops at each launch
(:meth:`Flux.host_values`) and handed to the kernel as float32
parameters, so they carry the same bits.

The op set: add, sub, rsub, mul, div, neg, abs, maximum, minimum,
clamp; where, comparisons, bool and / or / xor / not; casts between
float32, bfloat16, bool, int32 and int64, scalar constants (exact bits)
and ``select`` on ``offs``; sqrt, exp and log. Integer add, sub, mul,
neg and abs wrap at their width, as ATen's do. :func:`lower` returns a
reason string instead of a :class:`Flux` (a decline, counted in
:data:`declined` and logged once per kernel at WARNING) for an op
outside the set, for an op that reduces over or indexes across the
cell axis, for data-dependent Python (a value read into Python, an
output whose shape depends on the data: :func:`_trace`), for a value of
the 8- or 16-bit integer types, and for a value or carry the functor
cannot hold. Any other error raised while tracing (a bug in the
kernel, an op with no meta kernel, a device mismatch) propagates.
"""

from __future__ import annotations

import collections
import hashlib
import logging
import struct

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

logger = logging.getLogger(__name__)

#: decline reason -> count, over the process
declined = collections.Counter()
_logged = set()

L_TRACE = 11  # cells of the trace: a length no other axis of the trace has
MAX_FIELDS = 8
MAX_HOST = 32
MAX_CARRY = 32

aten = torch.ops.aten
_F32, _BF16 = torch.float32, torch.bfloat16
_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.bool: "bool",
          torch.int32: "i32", torch.int64: "i64"}
_NARROW = (torch.int8, torch.int16, torch.uint8)
_TORCH = {"f32": _F32, "bf16": _BF16, "bool": torch.bool,
          "i32": torch.int32, "i64": torch.int64}
FLOATS = ("f32", "bf16")

_BIN = {aten.add.Tensor: "add", aten.add.Scalar: "add",
        aten.sub.Tensor: "sub", aten.sub.Scalar: "sub",
        aten.rsub.Tensor: "rsub", aten.rsub.Scalar: "rsub",
        aten.mul.Tensor: "mul", aten.mul.Scalar: "mul",
        aten.div.Tensor: "div", aten.div.Scalar: "div",
        aten.maximum.default: "max", aten.minimum.default: "min"}
_CMP = {}
for _n in ("eq", "ne", "lt", "le", "gt", "ge"):
    _CMP[getattr(aten, _n).Tensor] = _n
    _CMP[getattr(aten, _n).Scalar] = _n
_LOGIC = {aten.bitwise_and.Tensor: "and", aten.bitwise_and.Scalar: "and",
          aten.bitwise_or.Tensor: "or", aten.bitwise_or.Scalar: "or",
          aten.bitwise_xor.Tensor: "xor", aten.bitwise_xor.Scalar: "xor",
          aten.logical_and.default: "and", aten.logical_or.default: "or",
          aten.logical_xor.default: "xor"}
_UN = {aten.neg.default: "neg", aten.abs.default: "abs",
       aten.sqrt.default: "sqrt", aten.exp.default: "exp",
       aten.log.default: "log", aten.bitwise_not.default: "not",
       aten.logical_not.default: "not"}
_IDENT = {aten.alias.default, aten.clone.default, aten.detach.default,
          aten.lift_fresh_copy.default, aten.contiguous.default,
          aten.view.default, aten.reshape.default, aten._unsafe_view.default,
          aten.expand.default}
_FILL = {aten.zeros.default: 0, aten.zeros_like.default: 0,
         aten.new_zeros.default: 0, aten.ones.default: 1,
         aten.ones_like.default: 1, aten.new_ones.default: 1}
_FULL = {aten.full.default: 1, aten.full_like.default: 1,
         aten.new_full.default: 2, aten.scalar_tensor.default: 0,
         aten.fill.Scalar: 1}
_CLAMP = {aten.clamp.default, aten.clamp.Tensor, aten.clamp_min.default,
          aten.clamp_max.default, aten.clamp_min.Tensor,
          aten.clamp_max.Tensor}
# ops over the cell axis: reductions, scans, gathers, shifts, joins
_ACROSS = ("sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
           "argmax", "argmin", "cumsum", "cumprod", "std", "var", "norm",
           "linalg_vector_norm", "logsumexp", "index", "index_select",
           "gather", "scatter", "scatter_add", "index_add", "index_put",
           "roll", "cat", "stack", "slice", "flip", "narrow", "take",
           "masked_select", "nonzero", "sort", "topk", "unbind", "split",
           "select", "diff", "count_nonzero", "median", "mode", "kthvalue")


class Declined(Exception):
    """A stated rule turns the kernel away; ``str(self)`` is the
    reason."""


# ---------------------------------------------------------------------
# ATen's reading of CPU scalars, measured on the device
# ---------------------------------------------------------------------

_SEM = {}
_PROBE_OPS = ("add", "sub", "rsub", "mul", "div", "eq", "ne", "lt", "le",
              "gt", "ge")


def _probe_x(dtype):
    """Operands that tell the readings apart: every bfloat16 step near
    the scalar 0.3 (whose bfloat16 rounding is 0.30078125) and a spread
    of magnitudes, no zero."""
    g = torch.Generator().manual_seed(5)
    spread = (torch.rand(2048, generator=g) * 6 - 3)
    near = torch.tensor([0.30078125, 0.298828125, 0.302734375, 0.3,
                         0.30000001192092896, -0.3])
    x = torch.cat([spread, near, torch.linspace(0.25, 0.35, 256)])
    x = torch.where(x == 0, torch.ones(()), x)
    return x.to(dtype)


def _aten_call(op, x, s, pos):
    """The eager aten call of ``op`` with scalar ``s`` at node position
    ``pos`` (rsub's traced node holds it at 2 and computes ``s - x``)."""
    if op == "rsub":
        fn = aten.rsub.Scalar if not isinstance(s, torch.Tensor) \
            else aten.rsub.Tensor
        return fn(x, s)
    over = getattr(aten, op)
    if not isinstance(s, torch.Tensor):
        fn = over.Scalar if op in ("eq", "ne", "lt", "le", "gt", "ge") \
            else over.Tensor
        return fn(x, s)
    return over.Tensor(s, x) if pos == 1 else over.Tensor(x, s)


def _candidate(op, pos, x, s_read, recip, dtype):
    """The result were the scalar read as ``s_read`` (float32 0-d) and
    the op computed in float32, rounded to ``dtype``."""
    xf = x.float()
    a, b = (s_read, xf) if (pos == 1 or op == "rsub") else (xf, s_read)
    if op in ("add",):
        r = a + b
    elif op in ("sub", "rsub"):
        r = a - b
    elif op == "mul":
        r = a * b
    elif op == "div":
        r = a * (torch.ones((), dtype=_F32) / b) if recip else a / b
    else:
        return getattr(torch, op)(a, b)
    return r.to(dtype)


def aten_semantics(device) -> dict:
    """How ATen on ``device`` reads a CPU scalar operand of a binary op
    beside a device tensor: ``{(op, position, dtype name, source): (mode,
    recip)}`` with ``mode`` "opmath" (read at float32) or "cast"
    (rounded to the op's dtype first), ``recip`` whether a divisor is
    applied as its float32 reciprocal, and ``source`` "tensor" (a 0-d
    float32 host tensor), "number" (a Python float) or "device" (a 0-d
    float32 tensor on ``device``). None where no reading matches.
    Measured once a device type, on operands that tell the readings
    apart."""
    key = torch.device(device).type
    hit = _SEM.get(key)
    if hit is not None:
        return hit
    dev = torch.device(device)
    s_val = 0.30000001192092896
    table = {}
    for dt in (_BF16, _F32):
        x = _probe_x(dt).to(dev)
        xh = x.cpu()
        for op in _PROBE_OPS:
            for pos in ((2,) if op == "rsub" else (1, 2)):
                for src in ("tensor", "number", "device"):
                    if src == "number" and pos == 1:
                        continue
                    if src == "number":
                        s, s64 = s_val, torch.tensor(s_val,
                                                     dtype=torch.float64)
                    else:
                        s = torch.tensor(s_val, dtype=_F32,
                                         device=dev if src == "device"
                                         else "cpu")
                        s64 = s.cpu()
                    got = _aten_call(op, x, s, pos).cpu()
                    reads = {"opmath": s64.to(_F32),
                             "cast": s64.to(dt).to(_F32)}
                    found = None
                    for mode in ("cast", "opmath"):
                        for recip in ((False, True) if op == "div" and pos == 2
                                      else (False,)):
                            want = _candidate(op, pos, xh, reads[mode], recip,
                                              dt)
                            if torch.equal(want.view(-1), got.view(-1)) and \
                                    want.dtype == got.dtype:
                                found = (mode, recip)
                                break
                        if found:
                            break
                    table[(op, pos, _NAMES[dt], src)] = found
    _SEM[key] = table
    return table


# ---------------------------------------------------------------------
# the typed program
# ---------------------------------------------------------------------

class Prog:
    """One traced function lowered: ``ins`` the instructions in order,
    each ``(op, dst, *args)`` over value ids, ``types[id]`` each value's
    dtype name ("f32", "bf16", "bool", "i32", "i64"), ``outs`` the ids
    of its results (carry leaves, or output fields).

    Instructions: ``("in", d, kind, i)`` with kind "cell", "nbr",
    "carry", "mask", "offs" (component i), "ex" (a fleet slot's extra
    column i) or "hp" (host parameter i); ``("const", d, value)``;
    ``("cast", d, a)``; ``("bin", d, op, a, b)`` with op add, sub, mul,
    div, rdiv (a times b's float32 reciprocal), max, min, and, or, xor;
    ``("cmp", d, op, a, b)``; ``("un", d, op, a)`` with op neg, abs,
    sqrt, exp, log, not; ``("where", d, c, a, b)``. A "bin" or "un"
    computes in float32 on float operands (the operands already read
    into the op's dtype, or at float32) and rounds to its own type."""

    def __init__(self):
        self.ins = []
        self.types = []
        self.outs = []

    def emit(self, op, dtype, *args):
        """Append an instruction; the id of its result, of ``dtype``."""
        self.types.append(dtype)
        d = len(self.types) - 1
        self.ins.append((op, d) + args)
        return d

    def flops(self, weights=None):
        """Float operations of one pass through the program; with
        ``weights`` (op -> count) an op of it counts its weight."""
        n = 0
        for ins in self.ins:
            if ins[0] in ("bin", "un"):
                if self.types[ins[1]] in FLOATS:
                    n += (weights or {}).get(ins[2], 1)
            elif ins[0] == "cmp":
                n += self.types[ins[3]] in FLOATS
        return n


class _Val:
    """A traced value during lowering: ``dev`` its id in the device
    program, or ``host`` its host node (evaluated on the host), with
    dtype name, 0-d flag and source ("tensor" / "device"), or a Python
    number (``number``)."""

    __slots__ = ("dev", "host", "dtype", "zero_d", "src", "number")

    def __init__(self, dev=None, host=None, dtype=None, zero_d=False,
                 src=None, number=None):
        self.dev, self.host, self.dtype = dev, host, dtype
        self.zero_d, self.src, self.number = zero_d, src, number


def _dtype_name(t):
    name = _NAMES.get(t)
    if name is None:
        if t in _NARROW:
            raise Declined(f"a value of dtype {t} (ATen wraps it at its own "
                           f"width; the functor's integers are 32 or 64 "
                           f"bits)")
        raise Declined(f"a value of dtype {t}")
    return name


def _const_cast(value, src_dtype, dtype):
    """``value`` (a Python number, or a value of ``src_dtype``) converted
    to ``dtype`` as ATen converts it on the host."""
    t = torch.tensor(value, dtype=src_dtype)
    out = t.to(_TORCH[dtype])
    return out.item()


def _py_dtype(v):
    if isinstance(v, bool):
        return torch.bool
    if isinstance(v, int):
        return torch.int64
    return torch.float64


class _Lowering:
    """Lowers one traced graph into a :class:`Prog` for ``target``
    ("cuda" or "cpu"), with ``sem`` the target's and ``host_sem`` the
    host's scalar readings. ``hosts`` collects the host nodes whose
    values the device program reads (shared across the three
    functions)."""

    def __init__(self, gm, target, sem, host_sem, inputs, hosts, batched):
        self.gm, self.target, self.sem = gm, target, sem
        self.host_sem = host_sem
        self.inputs = inputs  # placeholder name -> (kind, i)
        self.hosts = hosts
        self.batched = batched
        self.p = Prog()
        self.env = {}

    # -- values -------------------------------------------------------

    def _check_shape(self, node, val):
        shape = tuple(val.shape)
        if shape not in ((), (L_TRACE,)) and not (self.batched
                                                   and shape == (1,)):
            raise Declined(f"a value of shape {list(shape)} "
                           f"({node.target})")

    def arg(self, a):
        if isinstance(a, torch.fx.Node):
            return self.env[a.name]
        if isinstance(a, (bool, int, float)):
            return _Val(dtype=None, zero_d=True, src="number", number=a)
        raise Declined(f"an argument {a!r}")

    def dev_id(self, v, dtype=None):
        """The device program's id of ``v``, cast to ``dtype`` (a name)
        where given."""
        if v.number is not None:
            return self.p.emit("const", dtype, _const_cast(
                v.number, _py_dtype(v.number), dtype))
        if v.src == "offs":
            raise Declined("offs read other than by select")
        if v.dev is None:
            # a host value the device program reads: a host parameter
            if v.host not in self.hosts:
                if len(self.hosts) >= MAX_HOST:
                    raise Declined(f"more than {MAX_HOST} host scalars")
                self.hosts.append(v.host)
            v.dev = self.p.emit("in", v.dtype, "hp", self.hosts.index(v.host))
        d = v.dev
        if dtype is not None and dtype != self.p.types[d]:
            d = self.p.emit("cast", dtype, d)
        return d

    def read(self, v, compute, mode):
        """Operand ``v`` read for an op computing in ``compute``: cast to
        it, or at float32 (``mode`` "opmath")."""
        if mode == "opmath" and compute in FLOATS:
            return self.dev_id(v, "f32")
        return self.dev_id(v, compute)

    def _is_cpu_scalar(self, v):
        if v.number is not None:
            return True
        if not v.zero_d:
            return False
        return self.target == "cpu" or v.dev is None

    def modes(self, op, a, b, compute):
        """Readings of the two operands of binary ``op`` computing in
        ``compute`` on the device: ``(mode_a, mode_b, recip)``."""
        sa, sb = self._is_cpu_scalar(a), self._is_cpu_scalar(b)
        if sa and sb:
            if compute == "bf16":
                raise Declined("a bfloat16 computation on 0-d values")
            side, table = 2, self.host_sem
        elif sa or sb:
            side, table = (1 if sa else 2), self.sem
        else:
            return "cast", "cast", False
        if compute not in FLOATS or op not in _PROBE_OPS:
            return "cast", "cast", False
        s = a if side == 1 else b
        src = "number" if s.number is not None else s.src
        reading = table.get((op, side, compute, src))
        if reading is None:
            raise Declined(f"the device's {op} with a {src} scalar at "
                           f"position {side} matches no known reading")
        mode, recip = reading
        return ((mode, "cast", recip) if side == 1
                else ("cast", mode, recip))

    # -- nodes --------------------------------------------------------

    def run(self):
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                self.placeholder(node)
            elif node.op == "get_attr":
                t = getattr(self.gm, node.target)
                if t.dim() != 0:
                    raise Declined("a tensor constant with cells")
                self.env[node.name] = _Val(host=node, dtype=_dtype_name(
                    t.dtype), zero_d=True, src="tensor")
            elif node.op == "call_function":
                self.call(node)
            elif node.op == "output":
                return node.args[0]
        raise Declined("a graph without an output")

    def placeholder(self, node):
        kind, i = self.inputs[node.name]
        val = node.meta["val"]
        dt = _dtype_name(val.dtype)
        if kind == "offs":
            # read only through select: a bare use declines
            self.env[node.name] = _Val(dtype=dt, src="offs")
        elif kind == "extra_host":
            self.env[node.name] = _Val(host=node, dtype=dt, zero_d=True,
                                       src="tensor")
        else:
            self.env[node.name] = _Val(dev=self.p.emit("in", dt, kind, i),
                                       dtype=dt, src="device")

    def call(self, node):
        t = node.target
        val = node.meta.get("val")
        if not isinstance(val, torch.Tensor):
            raise Declined(f"a non-tensor result ({t})")
        self._check_shape(node, val)
        dt = _dtype_name(val.dtype)
        if val.device.type == "cpu":
            # computed on the host by the plain path, from the extras
            # and constants alone: evaluated there at each launch
            if val.dim() != 0:
                raise Declined(f"a host tensor with cells ({t})")
            self.env[node.name] = _Val(host=node, dtype=dt, zero_d=True,
                                       src="tensor")
            return
        self.env[node.name] = _Val(dev=self.lower(node, t, dt), dtype=dt,
                                   zero_d=val.dim() == 0, src="device")

    def _outside(self, t):
        name = getattr(t, "__name__", str(t))
        if name.split(".")[0] in _ACROSS:
            raise Declined(f"reduces over or indexes across the cell axis "
                           f"(aten.{name})")
        raise Declined(f"op outside the set (aten.{name})")

    def lower(self, node, t, dt):
        args = node.args
        if t is aten.select.int:
            src = args[0]
            if (isinstance(src, torch.fx.Node)
                    and self.inputs.get(src.name, (None,))[0] == "offs"
                    and args[1] in (0, -1)):
                return self.p.emit("in", dt, "offs", int(args[2]) % 3)
            self._outside(t)
        if t in _IDENT:
            return self.dev_id(self.arg(args[0]), dt)
        if t is aten._to_copy.default:
            return self.dev_id(self.arg(args[0]), dt)
        if t in _FILL:
            return self.p.emit("const", dt, _const_cast(_FILL[t], torch.int64,
                                                        dt))
        if t in _FULL:
            v = args[_FULL[t]] if len(args) > _FULL[t] else \
                node.kwargs.get("fill_value")
            if not isinstance(v, (bool, int, float)):
                raise Declined(f"a fill of {v!r}")
            return self.p.emit("const", dt, _const_cast(v, _py_dtype(v), dt))
        if t in _BIN:
            if node.kwargs.get("alpha", 1) != 1 or len(args) > 2:
                raise Declined(f"an alpha other than 1 ({t})")
            if node.kwargs.get("rounding_mode") is not None:
                raise Declined(f"a rounding division ({t})")
            op = _BIN[t]
            a, b = self.arg(args[0]), self.arg(args[1])
            compute = dt
            if op in ("max", "min"):
                return self.p.emit("bin", dt, op, self.dev_id(a, compute),
                                   self.dev_id(b, compute))
            ma, mb, recip = self.modes(op, a, b, compute)
            ra, rb = self.read(a, compute, ma), self.read(b, compute, mb)
            if op == "rsub":
                return self.p.emit("bin", dt, "sub", rb, ra)
            if op == "div" and recip:
                return self.p.emit("bin", dt, "rdiv", ra, rb)
            return self.p.emit("bin", dt, op, ra, rb)
        if t in _CMP:
            a, b = self.arg(args[0]), self.arg(args[1])
            compute = _dtype_name(torch.result_type(
                self._proxy(node.args[0]), self._proxy(node.args[1])))
            ma, mb, _r = self.modes(_CMP[t], a, b, compute)
            return self.p.emit("cmp", dt, _CMP[t], self.read(a, compute, ma),
                               self.read(b, compute, mb))
        if t in _LOGIC:
            if dt != "bool":
                raise Declined(f"an integer bitwise op ({t})")
            a, b = self.arg(args[0]), self.arg(args[1])
            return self.p.emit("bin", dt, _LOGIC[t], self.dev_id(a, "bool"),
                               self.dev_id(b, "bool"))
        if t in _UN:
            op = _UN[t]
            if op == "not" and dt != "bool":
                raise Declined(f"an integer bitwise op ({t})")
            return self.p.emit("un", dt, op, self.dev_id(self.arg(args[0]),
                                                         dt))
        if t in _CLAMP:
            x = self.dev_id(self.arg(args[0]), dt)
            name = t.__name__
            lo = hi = None
            if name.startswith("clamp_min"):
                lo = args[1]
            elif name.startswith("clamp_max"):
                hi = args[1]
            else:
                lo = args[1] if len(args) > 1 else node.kwargs.get("min")
                hi = args[2] if len(args) > 2 else node.kwargs.get("max")
            if lo is not None:
                x = self.p.emit("bin", dt, "max", x,
                                self.dev_id(self.arg(lo), dt))
            if hi is not None:
                x = self.p.emit("bin", dt, "min", x,
                                self.dev_id(self.arg(hi), dt))
            return x
        if t is aten.where.self:
            c = self.dev_id(self.arg(args[0]), "bool")
            return self.p.emit("where", dt, c,
                               self.dev_id(self.arg(args[1]), dt),
                               self.dev_id(self.arg(args[2]), dt))
        self._outside(t)

    def _proxy(self, a):
        """A data-free stand-in of argument ``a`` for type promotion."""
        if isinstance(a, torch.fx.Node):
            v = a.meta["val"]
            return torch.empty(v.shape, dtype=v.dtype)
        return a


# ---------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------

# What make_fx raises on data-free meta tensors where Python reads a
# value (``bool``, ``float``, ``.item()``: aten._local_scalar_dense),
# copies one out (``.tolist()``) or asks for an output whose shape
# depends on the data (``nonzero``, a boolean mask index).
_DATA_DEPENDENT = ("_local_scalar_dense", "Cannot copy out of meta tensor",
                   "data-independent implementation does not exist")


def _data_dependent(e):
    return isinstance(e, RuntimeError) and any(m in str(e)
                                               for m in _DATA_DEPENDENT)


def _trace(fn, args):
    """``make_fx`` of ``fn`` over ``args`` (data-free meta tensors and
    host 0-d tensors). Data-dependent Python declines with its reason;
    every other error propagates."""
    try:
        return make_fx(fn, tracing_mode="real")(*args)
    except RuntimeError as e:
        if not _data_dependent(e):
            raise
        msg = str(e).strip().splitlines()[0]
        raise Declined(f"data-dependent Python ({type(e).__name__}: "
                       f"{msg[:100]})") from None


# the tiled routes' rule (gen_form): float instructions of a cell's
# slots from which a thread computes 2 cells (LONG_CELL) or 1
# (HEAVY_CELL), an operation the card computes by an approximation and
# its corrections counted at INSTR_WEIGHTS instructions (exp at the 8 of
# its SASS in a generated kernel; log, sqrt and division alike)
LONG_CELL = 512
HEAVY_CELL = 1024
INSTR_WEIGHTS = {"exp": 8, "log": 8, "sqrt": 8, "div": 8}
GEN_THREADS = 256  # threads of a tiled route's block (gen_tiles.cuh)
GEN_MAX_SMEM = 232448  # shared memory a block may have on sm_90


class GenForm(collections.namedtuple("GenForm",
                                     "cells min_blocks tx stage",
                                     defaults=(32, "regs"))):
    """The form of a tiled route's kernel (csrc/gen_tiles.cuh), written
    into a source's ``GenSlots``: ``cells`` a thread computes,
    consecutive along y (``kCellsY``); ``min_blocks`` an SM its launch
    bounds ask for (``kMinBlocks``); ``tx`` cells of a tile along x
    (``kTX``: 32, a warp, or 64, two; the block's 256 threads are
    ``256 / tx`` along y); ``stage`` how a plane is staged (``kAsync``):
    ``"regs"``, loaded into registers during the compute of the plane
    before it and stored after it, or ``"async"``, each float32
    element by a 4-byte ``cp.async`` straight into the ring (a bfloat16
    field keeps the register path: ``cp.async`` copies no 2 bytes)."""

    def tile(self):
        """The (x, y) tile in cells."""
        return self.tx, GEN_THREADS // self.tx * self.cells

    def smem(self, reach, n_staged):
        """Bytes of a block's ring: ``n_staged`` float32 fields in 2 rz
        + 2 planes of the tile with a halo of ``reach`` along x and
        y."""
        rx, ry, rz = reach
        tx, ty = self.tile()
        return 4 * (2 * rz + 2) * int(n_staged) * (tx + 2 * rx) * (ty + 2 * ry)


def gen_form(flux, table, nx=None):
    """The tiled route's form for ``flux`` over ``table`` on grids ``nx``
    cells wide (None: not known). Cells a thread (several share the
    neighbour values of the rows between them, one shared load each,
    and interleave their ordered chains): 4, or 2 where the flux stages
    more than two fields or its slots issue :data:`LONG_CELL` float
    instructions a cell or more (:data:`INSTR_WEIGHTS`), 1 from
    :data:`HEAVY_CELL` (the unrolled code of many slots); halved until
    the ring fits a block's shared memory (a table of a long reach).
    Launch bounds of two blocks an SM; tiles of 64 along x on grids at
    least 64 wide (a bucket slot's 64 cells of x one band), else 32;
    staged through registers, or by ``cp.async`` where the flux stages
    float32 and bfloat16 fields together. The readings behind the rule
    are in PERF.md's findings on the tiled routes (``python -m
    dccrg_tpu_torch.gen_tile_rule``)."""
    n = len(flux.staged())
    sizes = {flux.storage[flux.fields_in[q]].itemsize for q in flux.staged()}
    work = flux.slot.flops(INSTR_WEIGHTS) * len(table.cells)
    if work >= HEAVY_CELL:
        cells = 1
    else:
        cells = 2 if n > 2 or work >= LONG_CELL else 4
    tx = 64 if nx is not None and nx >= 64 else 32
    while cells > 1 and GenForm(cells, 2, tx).smem(table.reach, n) \
            > GEN_MAX_SMEM:
        cells //= 2
    return GenForm(cells, 2, tx, "async" if len(sizes) > 1 else "regs")


class SlotTable:
    """A neighbourhood's slot table as a generated flux reads it, fixed
    for a grid's life: each slot's cell offset (``cells``, from the
    plan's closed form) and its ``offs_const`` row (``const``), in
    ``offs_const`` order; ``reach`` the largest cell offset per axis.
    Two tables are the same table where ``key`` is."""

    def __init__(self, offs_cells, offs_const):
        self.cells = tuple(tuple(int(v) for v in o) for o in offs_cells)
        self.const = tuple(tuple(int(v) for v in o) for o in offs_const)
        if len(self.cells) != len(self.const):
            raise ValueError("a slot table needs one offs_const row a slot")
        self.reach = tuple(max((abs(o[d]) for o in self.cells), default=0)
                           for d in range(3))
        self.key = (self.cells, self.const)


class Flux:
    """A lowered kernel: its fields, the three programs, the host nodes
    and the functor's C++ text. ``key`` hashes the text."""

    def __init__(self, fields_in, fields_out, dtypes, n_extra, batched,
                 target, progs, hosts, graphs, nbr_used, offs_used):
        self.fields_in = tuple(fields_in)
        self.fields_out = tuple(fields_out)
        self.storage = dict(dtypes)  # field -> torch storage dtype
        self.n_extra = n_extra
        self.batched = batched
        self.target = target
        self.init, self.slot, self.finish = progs
        self.hosts = hosts
        self._graphs = graphs
        self.nbr_used = tuple(nbr_used)
        self.offs_used = offs_used
        self.n_carry = len(self.init.outs)
        self.text = self.functor()
        self.key = hashlib.sha256(self.text.encode()).hexdigest()[:16]

    def host_values(self, extras):
        """The host parameters of one launch: each host node evaluated
        by its aten op on the host, from the launch's float32 extras
        (0-d tensors), as the plain path evaluates it. A list of Python
        floats, one a host node."""
        out = []
        envs = {}
        for node in self.hosts:
            gm = node.graph.owning_module
            env = envs.setdefault(id(gm), {})
            out.append(float(self._host_eval(gm, node, env, extras)))
        return out

    def _host_eval(self, gm, node, env, extras):
        hit = env.get(node.name)
        if hit is not None:
            return hit
        if node.op == "placeholder":
            kind, i = self._graphs[id(gm)][node.name]
            v = torch.as_tensor(extras[i]).to(_F32).cpu()
        elif node.op == "get_attr":
            v = getattr(gm, node.target)
        else:
            def sub(a):
                if isinstance(a, torch.fx.Node):
                    return self._host_eval(gm, a, env, extras)
                if isinstance(a, (list, tuple)):
                    return type(a)(sub(x) for x in a)
                return a
            v = node.target(*sub(node.args), **{k: sub(x) for k, x in
                                                node.kwargs.items()})
        env[node.name] = v
        return v

    def flops_per_cell(self, n_slots):
        """Float operations a cell of one step over ``n_slots`` slots."""
        return (self.init.flops() + n_slots * self.slot.flops()
                + self.finish.flops())

    def itemsizes(self):
        """Bytes a cell reads (fields in) and writes (fields out)."""
        return (sum(self.storage[f].itemsize for f in self.fields_in),
                sum(self.storage[f].itemsize for f in self.fields_out))

    # -- C++ ----------------------------------------------------------

    def functor(self, name="GenFlux"):
        """The C++ text of the flux functor (``csrc/flux_rt.cuh``'s
        helpers; host and device)."""
        nin, nout = len(self.fields_in), len(self.fields_out)
        ncar = max(1, self.n_carry)
        L = [f"struct {name} {{",
             f"  static constexpr int kIn = {nin};",
             f"  static constexpr int kOut = {nout};",
             f"  static constexpr int kCarry = {ncar};",
             f"  static constexpr int kHost = {max(1, len(self.hosts))};",
             f"  static constexpr bool kOffs = "
             f"{'true' if self.offs_used else 'false'};",
             "  struct Params { float hp[kHost]; };",
             "  struct Carry { float r[kCarry]; };"]

        def loads(fn, which):
            body = []
            for q, f in enumerate(self.fields_in):
                if q in which:
                    body.append(f"    v[{q}] = flux_rt::ld_"
                                f"{_NAMES[self.storage[f]]}"
                                f"(in[{q}], i);")
            return ([f"  DCCRG_HD static void {fn}(const void* const* in, "
                     f"long long i, float (&v)[kIn]) {{"] + body + ["  }"])

        L += loads("load_cell", range(nin))
        L += loads("load_nbr", self.nbr_used)
        # the fields the tiled routes stage (those read at a neighbour;
        # field 0 where none is), as float32 values: one staged row's
        # loads, the cell's other fields, and the staged values put in
        # their places of a row
        staged = self.staged()
        L.append(f"  static constexpr int kStaged = {len(staged)};")
        L.append("  DCCRG_HD static void load_staged(const void* const* in, "
                 "long long i, float (&s)[kStaged]) {")
        for j, q in enumerate(staged):
            L.append(f"    s[{j}] = flux_rt::ld_"
                     f"{_NAMES[self.storage[self.fields_in[q]]]}"
                     f"(in[{q}], i);")
        L.append("  }")
        # staged field j's index into fields_in and whether it is stored
        # in 4 bytes (float32; bfloat16 otherwise): the async staging
        # copies those into the ring as they are
        def chain(vals):
            e = vals[-1]
            for j in range(len(vals) - 2, -1, -1):
                e = f"j == {j} ? {vals[j]} : {e}"
            return e

        L.append("  DCCRG_HD static constexpr int staged_field(int j) { "
                 f"return {chain([str(q) for q in staged])}; }}")
        L.append("  DCCRG_HD static constexpr bool staged_wide(int j) { "
                 "return " + chain(
                     ["true" if self.storage[self.fields_in[q]].itemsize == 4
                      else "false" for q in staged]) + "; }")
        L += loads("load_unstaged", [q for q in range(nin)
                                     if q not in staged])[:-1]
        L += ["    (void)in; (void)i; (void)v;", "  }"]
        L.append("  DCCRG_HD static void unstage(const float (&s)[kStaged], "
                 "float (&v)[kIn]) {")
        L += [f"    v[{q}] = s[{j}];" for j, q in enumerate(staged)]
        L.append("  }")
        L.append("  DCCRG_HD static void store(void* const* out, long long i, "
                 "const float (&v)[kOut]) {")
        for o, f in enumerate(self.fields_out):
            L.append(f"    flux_rt::st_{_NAMES[self.storage[f]]}(out[{o}], i, "
                     f"v[{o}]);")
        L.append("  }")
        L.append("  DCCRG_HD static void copy(const void* const* prev, "
                 "void* const* out, long long i) {")
        for o, f in enumerate(self.fields_out):
            ty = ("unsigned" if self.storage[f].itemsize == 4
                  else "unsigned short")
            L.append(f"    static_cast<{ty}*>(out[{o}])[i] = "
                     f"static_cast<const {ty}*>(prev[{o}])[i];")
        L.append("  }")
        sig = ("const float (&c)[kIn], const Params& k, const float* ex")
        L.append(f"  DCCRG_HD static void init(Carry& a, {sig}) {{")
        L += self._body(self.init, lambda o, e: f"a.r[{o}] = {e};")
        L.append("  }")
        L.append("  DCCRG_HD static void slot(Carry& a, const float (&c)[kIn], "
                 "const float (&n)[kIn], const int* o, bool m, "
                 "const Params& k, const float* ex) {")
        L += self._body(self.slot, lambda o, e: f"a.r[{o}] = {e};")
        L.append("  }")
        L.append(f"  DCCRG_HD static void finish(float (&out)[kOut], "
                 f"const Carry& a, {sig}) {{")
        L += self._body(self.finish, lambda o, e: f"out[{o}] = {e};")
        L.append("  }")
        L.append("};")
        return "\n".join(L) + "\n"

    def staged(self):
        """The fields the tiled routes stage, by index into
        ``fields_in``: those read at a neighbour, or field 0 where the
        slot function reads none."""
        return self.nbr_used or (0,)

    def slots_text(self, table, form=None):
        """The C++ text of ``table``'s slot sequence (``GenSlots``,
        csrc/gen_tiles.cuh): its reach per axis, the kernel's form
        (``form``, a :class:`GenForm`; :func:`gen_form`'s for a grid of
        unknown width by default)
        and every slot's call of the slot function unrolled in
        ``offs_const`` order, the cell offset and the ``offs_const``
        row literals, so that the compiler folds the selects on
        ``offs`` and on a mask that is a literal, and drops the
        neighbour reads whose values go unused."""
        form = form or gen_form(self, table)
        if form.tx not in (32, 64) or form.stage not in ("regs", "async") \
                or form.cells < 1 or form.min_blocks < 1:
            raise ValueError(f"no tiled route's form {form}")
        rx, ry, rz = table.reach
        L = ["struct GenSlots {",
             f"  static constexpr int kRx = {rx}, kRy = {ry}, kRz = {rz};",
             f"  static constexpr int kCellsY = {int(form.cells)};",
             f"  static constexpr int kMinBlocks = {int(form.min_blocks)};",
             f"  static constexpr int kTX = {int(form.tx)};",
             f"  static constexpr bool kAsync = "
             f"{'true' if form.stage == 'async' else 'false'};",
             "  // slot by slot, each of a thread's C cells (consecutive "
             "along y)",
             "  template <typename G, int C, typename Nb, typename Mk>",
             "  DCCRG_HD static void run(typename G::Carry (&a)[C],",
             "                           const float (&c)[C][G::kIn],",
             "                           const typename G::Params& k, "
             "const float* ex,",
             "                           const Nb& nb, const Mk& mk) {"]
        for j, (cell, oc) in enumerate(zip(table.cells, table.const)):
            at = f"{j}, {cell[0]}, {cell[1]}, {cell[2]}"
            L += [f"    {{ const int o[3] = {{{oc[0]}, {oc[1]}, {oc[2]}}};",
                  "#pragma unroll",
                  "      for (int y = 0; y < C; ++y) { float n[G::kIn]; "
                  f"nb.template get<{at}>(y, n);",
                  f"        G::slot(a[y], c[y], n, o, "
                  f"mk.template at<{at}>(y), k, ex); }} }}"]
        L += ["    (void)a; (void)c; (void)k; (void)ex; (void)nb; (void)mk;",
              "  }", "};"]
        return "\n".join(L) + "\n"

    def _body(self, prog, assign):
        ctype = {"f32": "float", "bf16": "float", "bool": "bool",
                 "i32": "int", "i64": "long long"}
        lines = []
        for ins in prog.ins:
            op, d = ins[0], ins[1]
            ty = prog.types[d]
            e = _expr(ins, prog.types)
            lines.append(f"    const {ctype[ty]} v{d} = {e};")
        # results after every read of the carry
        for o, d in enumerate(prog.outs):
            lines.append("    " + assign(o, f"v{d}"))
        lines.append("    (void)c; (void)k; (void)ex;")
        return lines


def _fbits(v):
    return struct.unpack("<I", struct.pack("<f", v))[0]


# integer arithmetic in the unsigned type of its width, so that it wraps
# as ATen's does (signed overflow is undefined in C++)
_U = {"i32": "(unsigned)", "i64": "(unsigned long long)"}


def _wrap(ty, e):
    return f"({'int' if ty == 'i32' else 'long long'})({e})"


def _expr(ins, types):
    """C++ expression of one instruction."""
    op, d = ins[0], ins[1]
    ty = types[d]

    def rnd(e):
        return f"flux_rt::rbf({e})" if ty == "bf16" else e

    if op == "in":
        kind, i = ins[2], ins[3]
        if kind == "cell":
            return f"c[{i}]"
        if kind == "nbr":
            return f"n[{i}]"
        if kind == "carry":
            return f"a.r[{i}]"
        if kind == "mask":
            return "m"
        if kind == "offs":
            return f"o[{i}]"
        src = f"ex[{i}]" if kind == "ex" else f"k.hp[{i}]"
        if ty in FLOATS:
            return src
        if ty == "bool":
            return f"({src} != 0.f)"
        return f"({'int' if ty == 'i32' else 'long long'})({src})"
    if op == "const":
        v = ins[2]
        if ty in FLOATS:
            return f"flux_rt::bits_f({_fbits(v)}u)"
        if ty == "bool":
            return "true" if v else "false"
        return f"{int(v)}" + ("LL" if ty == "i64" else "")
    if op == "cast":
        a = ins[2]
        st = types[a]
        if ty == st or (ty == "f32" and st == "bf16"):
            return f"v{a}"
        if ty == "bool":
            return f"(v{a} != 0)"
        if ty in FLOATS:
            if st == "bool":
                return rnd(f"(v{a} ? 1.f : 0.f)")
            return rnd(f"(float)v{a}")
        return f"({'int' if ty == 'i32' else 'long long'})v{a}"
    if op == "bin":
        o, a, b = ins[2], ins[3], ins[4]
        x, y = f"v{a}", f"v{b}"
        if o in ("and", "or", "xor"):
            return {"and": f"({x} && {y})", "or": f"({x} || {y})",
                    "xor": f"({x} != {y})"}[o]
        if o in ("max", "min"):
            if ty in FLOATS:
                return f"flux_rt::g{o}({x}, {y})"
            return f"({x} {'>' if o == 'max' else '<'} {y} ? {x} : {y})"
        if o == "rdiv":
            return rnd(f"({x} * (1.0f / {y}))")
        sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[o]
        if ty not in FLOATS:
            return _wrap(ty, f"{_U[ty]}({x}) {sym} {_U[ty]}({y})")
        return rnd(f"({x} {sym} {y})")
    if op == "cmp":
        o, a, b = ins[2], ins[3], ins[4]
        sym = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
               "ge": ">="}[o]
        return f"(v{a} {sym} v{b})"
    if op == "un":
        o, a = ins[2], ins[3]
        x = f"v{a}"
        if o == "not":
            return f"(!{x})"
        if o == "neg":
            return f"(-{x})" if ty in FLOATS else _wrap(ty, f"0 - {_U[ty]}({x})")
        if o == "abs":
            if ty in FLOATS:
                return f"fabsf({x})"
            return f"({x} < 0 ? {_wrap(ty, f'0 - {_U[ty]}({x})')} : {x})"
        return rnd(f"{o}f({x})")
    if op == "where":
        c, a, b = ins[2], ins[3], ins[4]
        return f"(v{c} ? v{a} : v{b})"
    raise ValueError(op)


# ---------------------------------------------------------------------
# lower
# ---------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def lower(kernel, fields_in, fields_out, dtypes, n_extra, target="cuda",
          batched=False):
    """The :class:`Flux` of ``kernel`` (a ``SlotwiseKernel``) over
    ``fields_in`` / ``fields_out`` with storage ``dtypes`` (name ->
    torch dtype) and ``n_extra`` float32 extras, for the plain path's
    arithmetic on ``target`` ("cuda" or "cpu"); ``batched``: a fleet
    bucket's form (extras as per-slot device columns). Returns a reason
    string where a stated rule declines the kernel (counted in
    :data:`declined`, logged once per kernel and reason)."""
    try:
        return _lower(kernel, tuple(fields_in), tuple(fields_out),
                      dict(dtypes), int(n_extra), target, bool(batched))
    except Declined as e:
        reason = str(e)
        declined[reason] += 1
        key = (id(kernel), reason)
        if key not in _logged:
            _logged.add(key)
            logger.warning("flux_gen declines %r: %s (the plain path "
                           "runs)", kernel, reason)
        return reason


def _lower(kernel, fields_in, fields_out, dtypes, n_extra, target, batched):
    if not fields_out or len(fields_in) > MAX_FIELDS or \
            len(fields_out) > MAX_FIELDS:
        raise Declined("more than 8 fields in or out, or none out")
    for f in set(fields_in) | set(fields_out):
        if dtypes.get(f) not in (_F32, _BF16):
            raise Declined(f"field {f!r} stored as {dtypes.get(f)}")
    sem = aten_semantics(target)
    host_sem = aten_semantics("cpu")
    Lt = L_TRACE
    nin = len(fields_in)
    cell = [_meta((Lt,), dtypes[f]) for f in fields_in]
    nbr = [_meta((Lt,), dtypes[f]) for f in fields_in]
    offs = _meta((3,), torch.int32)
    mask = _meta((Lt,), torch.bool)
    extras = ([_meta((1,), _F32) for _ in range(n_extra)] if batched
              else [torch.zeros((), dtype=_F32) for _ in range(n_extra)])
    ekind = "ex" if batched else "extra_host"

    # init: (cell fields..., extras...) -> carry leaves
    spec = {}

    def init_fn(*a):
        carry = kernel.init(dict(zip(fields_in, a[:nin])), *a[nin:])
        leaves, spec["carry"] = pytree.tree_flatten(carry)
        return leaves

    hosts = []
    graphs = {}

    def lower_graph(gm, inputs):
        graphs[id(gm)] = inputs
        low = _Lowering(gm, target, sem, host_sem, inputs, hosts, batched)
        outs = low.run()
        return low, outs

    gm_i = _trace(init_fn, cell + extras)
    names = [n.name for n in gm_i.graph.nodes if n.op == "placeholder"]
    inputs = {nm: ("cell", q) for q, nm in enumerate(names[:nin])}
    inputs.update({nm: (ekind, i) for i, nm in enumerate(names[nin:])})
    low_i, outs_i = lower_graph(gm_i, inputs)
    carry_vals = [n.meta["val"] if isinstance(n, torch.fx.Node) else None
                  for n in outs_i]
    if not carry_vals or any(
            not isinstance(v, torch.Tensor) or tuple(v.shape) != (Lt,)
            or v.device.type != "meta" or v.dtype not in (_F32, _BF16)
            for v in carry_vals):
        raise Declined("a carry leaf that is not a float32 or bfloat16 "
                       "tensor of the cells")
    if len(carry_vals) > MAX_CARRY:
        raise Declined(f"more than {MAX_CARRY} carry leaves")
    low_i.p.outs = [low_i.dev_id(low_i.env[n.name]) for n in outs_i]
    carry_spec = spec["carry"]
    carry_dt = [v.dtype for v in carry_vals]
    ncar = len(carry_vals)

    # slot: (carry leaves..., cell..., nbr..., offs, mask, extras...)
    def slot_fn(*a):
        carry = pytree.tree_unflatten(list(a[:ncar]), carry_spec)
        c = dict(zip(fields_in, a[ncar:ncar + nin]))
        nb = dict(zip(fields_in, a[ncar + nin:ncar + 2 * nin]))
        rest = a[ncar + 2 * nin:]
        out = kernel.slot(carry, c, nb, rest[0], rest[1], *rest[2:])
        leaves, sp = pytree.tree_flatten(out)
        if sp != carry_spec:
            raise Declined("the slot function changes the carry's form")
        return leaves

    carry_in = [_meta((Lt,), d) for d in carry_dt]
    gm_s = _trace(slot_fn, carry_in + cell + nbr + [offs, mask] + extras)
    names = [n.name for n in gm_s.graph.nodes if n.op == "placeholder"]
    inputs = {}
    for i, nm in enumerate(names[:ncar]):
        inputs[nm] = ("carry", i)
    for q, nm in enumerate(names[ncar:ncar + nin]):
        inputs[nm] = ("cell", q)
    for q, nm in enumerate(names[ncar + nin:ncar + 2 * nin]):
        inputs[nm] = ("nbr", q)
    inputs[names[ncar + 2 * nin]] = ("offs", 0)
    inputs[names[ncar + 2 * nin + 1]] = ("mask", 0)
    for i, nm in enumerate(names[ncar + 2 * nin + 2:]):
        inputs[nm] = (ekind, i)
    low_s, outs_s = lower_graph(gm_s, inputs)
    for n, d in zip(outs_s, carry_dt):
        v = n.meta["val"] if isinstance(n, torch.fx.Node) else None
        if not isinstance(v, torch.Tensor) or v.dtype != d or \
                tuple(v.shape) != (Lt,) or v.device.type != "meta":
            raise Declined("the slot function changes a carry leaf's dtype "
                           "or shape")
    low_s.p.outs = [low_s.dev_id(low_s.env[n.name]) for n in outs_s]
    nbr_used = sorted({i for op, d, *r in low_s.p.ins
                       if op == "in" and r[0] == "nbr" for i in [r[1]]})
    offs_used = any(op == "in" and r[0] == "offs"
                    for op, d, *r in low_s.p.ins)

    # finish: (carry leaves..., cell..., extras...) -> {out: [L]}
    def finish_fn(*a):
        carry = pytree.tree_unflatten(list(a[:ncar]), carry_spec)
        c = dict(zip(fields_in, a[ncar:ncar + nin]))
        res = kernel.finish(carry, c, *a[ncar + nin:])
        try:
            return [res[f] for f in fields_out]
        except (KeyError, TypeError, IndexError):
            raise Declined("the finish function does not return every "
                           "field out") from None

    gm_f = _trace(finish_fn, carry_in + cell + extras)
    names = [n.name for n in gm_f.graph.nodes if n.op == "placeholder"]
    inputs = {nm: ("carry", i) for i, nm in enumerate(names[:ncar])}
    inputs.update({nm: ("cell", q)
                   for q, nm in enumerate(names[ncar:ncar + nin])})
    inputs.update({nm: (ekind, i) for i, nm in enumerate(names[ncar + nin:])})
    low_f, outs_f = lower_graph(gm_f, inputs)
    for n in outs_f:
        v = n.meta["val"] if isinstance(n, torch.fx.Node) else None
        if not isinstance(v, torch.Tensor) or tuple(v.shape) != (Lt,) or \
                v.device.type != "meta":
            raise Declined("an output that is not a tensor of the cells")
    # each output rounded to its field's storage dtype, as the plain
    # path's .to(dtype) rounds it
    low_f.p.outs = [low_f.dev_id(low_f.env[n.name], _NAMES[dtypes[f]])
                    for n, f in zip(outs_f, fields_out)]
    return Flux(fields_in, fields_out, {f: dtypes[f] for f in
                                        set(fields_in) | set(fields_out)},
                n_extra, batched, target, (low_i.p, low_s.p, low_f.p), hosts,
                graphs, nbr_used, offs_used)


_HEAD = """\
// A flux functor generated by dccrg_tpu_torch/ops/flux_gen.py from a
// SlotwiseKernel's slot functions and the slot table of the grid it
// runs on (GenSlots), instantiated in the hand-written templates of
// csrc/gen_tiles.cuh, the tiled routes (dccrg_gen_tiles: kernel A;
// dccrg_gen_fleet_tiles: kernel A' for a fleet bucket's twin), and of
// csrc/bulk_direct.cuh over the table in device memory, the
// runtime-table routes (dccrg_gen_direct, dccrg_gen_fleet). Each entry
// point returns cudaGetLastError() of its launch.

#include "gen_tiles.cuh"

namespace {{

{functor}
{slots}
using F = direct::Generated<GenFlux>;

bool params(const float* hp, int n_hp, F::Params& k) {{
  if (n_hp < 0 || n_hp > F::kHost) return false;
  for (int i = 0; i < F::kHost; ++i) k.hp[i] = i < n_hp ? hp[i] : 0.f;
  return true;
}}

}}  // namespace

extern "C" const char* dccrg_gen_error_string(int code) {{
  return cudaGetErrorString((cudaError_t)code);
}}
"""

_DIRECT = """
extern "C" int dccrg_gen_direct(const void* const* in, void* const* out,
                                const int* geom, long long n0, long long L,
                                const void* slots, const void* offs,
                                int n_slots, const float* hp, int n_hp,
                                int device, void* stream) {
  direct::Ptrs p = {};
  for (int q = 0; q < F::kIn; ++q) p.in[q] = in[q];
  for (int o = 0; o < F::kOut; ++o) p.out[o] = out[o];
  F::Params k;
  if (!params(hp, n_hp, k)) return (int)cudaErrorInvalidValue;
  return direct::launch_direct<F>(p, geom, n0, L, slots, offs, n_slots, k,
                                  device, stream);
}
"""

_FLEET = """
extern "C" int dccrg_gen_fleet(const void* const* in, void* const* out,
                               const void* const* prev, const int* geom,
                               long long n0, long long L, long long R, int B,
                               int E, const void* slots, const void* offs,
                               int n_slots, const float* extras,
                               const int* budget, int step,
                               const int* in_sizes, const int* out_sizes,
                               const float* hp, int n_hp, int device,
                               void* stream) {
  direct::Ptrs p = {};
  for (int q = 0; q < F::kIn; ++q) p.in[q] = in[q];
  for (int o = 0; o < F::kOut; ++o) {
    p.out[o] = out[o];
    p.prev[o] = prev[o];
  }
  F::Params k;
  if (!params(hp, n_hp, k)) return (int)cudaErrorInvalidValue;
  return direct::launch_fleet<F>(p, geom, n0, L, R, B, E, slots, offs,
                                 n_slots, extras, budget, step, in_sizes,
                                 out_sizes, k, device, stream);
}
"""

_TILES = """
extern "C" int dccrg_gen_tiles(const void* const* in, void* const* out,
                               const int* geom, long long n0, long long L,
                               const float* hp, int n_hp, int device,
                               void* stream) {
  direct::Ptrs p = {};
  for (int q = 0; q < F::kIn; ++q) p.in[q] = in[q];
  for (int o = 0; o < F::kOut; ++o) p.out[o] = out[o];
  F::Params k;
  if (!params(hp, n_hp, k)) return (int)cudaErrorInvalidValue;
  return tiles::launch<GenFlux, GenSlots, false>(
      p, geom, n0, L, L, 1, 0, nullptr, nullptr, 0, nullptr, nullptr, k,
      device, stream);
}
"""

_FLEET_TILES = """
extern "C" int dccrg_gen_fleet_tiles(const void* const* in, void* const* out,
                                     const void* const* prev,
                                     const int* geom, long long n0,
                                     long long L, long long R, int B, int E,
                                     const float* extras, const int* budget,
                                     int step, const int* in_sizes,
                                     const int* out_sizes, const float* hp,
                                     int n_hp, int device, void* stream) {
  direct::Ptrs p = {};
  for (int q = 0; q < F::kIn; ++q) p.in[q] = in[q];
  for (int o = 0; o < F::kOut; ++o) {
    p.out[o] = out[o];
    p.prev[o] = prev[o];
  }
  F::Params k;
  if (!params(hp, n_hp, k)) return (int)cudaErrorInvalidValue;
  return tiles::launch<GenFlux, GenSlots, true>(
      p, geom, n0, L, R, B, E, extras, budget, step, in_sizes, out_sizes, k,
      device, stream);
}
"""


def source(flux, table, form=None):
    """The CUDA source of ``flux``'s kernels over the slot table
    ``table`` (a :class:`SlotTable`): its functor and the table's slot
    sequence (:meth:`Flux.slots_text`) in the templates of
    ``csrc/gen_tiles.cuh`` and ``csrc/bulk_direct.cuh``, with the C
    entry points ``dccrg_gen_tiles`` and ``dccrg_gen_direct`` (kernel
    A) or, for a fleet form (``flux.batched``), ``dccrg_gen_fleet_tiles``
    and ``dccrg_gen_fleet`` (kernel A'), and ``dccrg_gen_error_string``.
    One source a (flux, table, form); ``form`` (a :class:`GenForm`)
    sets the tiled route's form, :func:`gen_form`'s for a grid of
    unknown width by default."""
    head = _HEAD.format(functor=flux.text,
                        slots=flux.slots_text(table, form))
    return head + (_FLEET + _FLEET_TILES if flux.batched
                   else _DIRECT + _TILES)
