"""Reductions across the partitions of a grid, and the transport
between the ranks that hold them.

Counterpart of ``dccrg_tpu/comm.py``, the wrappers of the reference's
MPI support layer (dccrg_mpi_support.hpp). The reference calls XLA
collectives inside ``shard_map``; here a per-partition quantity is one
``[n, ...]`` tensor over the partitions this process holds, and each
collective is one reduction over its leading axis. On a grid placed on
the ranks of a ``torch.distributed`` group (``Grid.initialize`` with
``(rank, device)`` entries) the fold of the held partitions is followed
by one ``torch.distributed.all_reduce`` (``group=True``). The
in-program functions return the reduced value broadcast back to every
partition (what a collective leaves on each device); each ``host_*``
twin makes one pass and one host read.

- ``all_gather``  — All_Gather (dccrg_mpi_support.hpp:101-234)
- ``all_reduce``  — All_Reduce: sum, max or min (dccrg_mpi_support.hpp:240-269)
- ``all_finite``  — the watchdog's probe: one value, 1 iff every
  element of every array is finite
- ``field_sums``  — each partition's float32 sums, summed over the
  partitions (the integrity layer's conservation sums)
- ``some_reduce`` — Some_Reduce: each partition sums only its peer set
  (dccrg_mpi_support.hpp:285-380)

The host diagnostics every rank reads (the models' CFL steps, masses
and conserved sums, the dense mesh's dots) fold the held rows first and
then reduce over the group, so each rank reads the one process's value:

- ``grid_total`` / ``grid_field_totals`` — per-partition sums added in
  partition order, the other ranks' rows filled by one exact group sum;
- ``group_extreme`` — a min or max over the held values and the group;
- ``exact_sum`` — a float64 sum that is the same bits on any split into
  tensors, blocks or ranks (the dense mesh's reductions).

On a grid whose partitions span devices of this process (a field is a
``grid.Grouped``, one tensor per device) a per-partition quantity is
folded group by group in partition order (:func:`partition_sums`,
:func:`grid_total`), so a sum reads the bits the one-device grid reads.

The cross-device transport (the reference's ``ppermute`` between the
devices of one process): :func:`device_copy` copies a packed buffer
into a buffer allocated on the destination device, ordered after the
source card's stream, and counts its bytes under a ``device_*`` leg of
``dccrg_rank_bytes_total`` (transport ``device-copy``).

The cross-rank transport (the reference's ``ppermute`` / on-device
gather across processes, which XLA carries there):

- ``post_exchange`` / ``wait_exchange`` — one packed byte buffer to
  each peer rank by ``isend`` / ``irecv`` (the halo exchange);
- ``move_bytes`` — one ``all_to_all_single`` of byte buffers by
  destination rank (the row moves of a commit, a balance, a load).

Gloo moves host tensors only, so on the card each buffer crosses
through a pinned host buffer: the rows are selected on the card, copied
to the host, sent; received, copied to the card, landed. The group's
backend decides this (:func:`transport_name`); every exchange adds its
bytes to the ``dccrg_rank_bytes_total`` counter (labels ``leg`` and
``transport``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import telemetry


def _n(x) -> int:
    return int(x.shape[0])


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``[n_dev, ...]`` -> ``[n_dev, n_dev, ...]``: every partition's
    view of every partition's row."""
    return x.unsqueeze(0).expand((_n(x),) + tuple(x.shape))


def group_active() -> bool:
    """True when a default ``torch.distributed`` group of more than one
    rank is up."""
    dist = torch.distributed
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def transport_name() -> str:
    """How buffers cross ranks: ``"gloo-host"`` (host tensors; a card's
    rows staged through pinned host buffers) or the group's backend."""
    backend = torch.distributed.get_backend()
    return "gloo-host" if backend == "gloo" else str(backend)


def _group_reduce(r: torch.Tensor, op: str) -> torch.Tensor:
    """``r`` reduced elementwise over the ranks of the default group
    (gloo reduces host tensors: a card's value crosses the host)."""
    dist = torch.distributed
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    host = r.detach().to("cpu", copy=True).contiguous()
    dist.all_reduce(host, op=ops[op])
    return host.to(r.device)


def all_reduce(x: torch.Tensor, op: str = "sum",
               group: bool = False) -> torch.Tensor:
    """Elementwise reduction over the partition axis, broadcast back to
    every partition: ``[n, ...]`` in and out. With ``group`` (a grid
    whose partitions span ranks) the held partitions' fold is then
    reduced over the ranks of the default group."""
    if op == "sum":
        r = x.sum(dim=0, keepdim=True)
    elif op == "max":
        r = x.amax(dim=0, keepdim=True)
    elif op == "min":
        r = x.amin(dim=0, keepdim=True)
    else:
        raise ValueError(f"unknown reduction {op!r}")
    if group and group_active():
        r = _group_reduce(r, op)
    return r.expand(tuple(x.shape))


def _grouped(x) -> bool:
    from .grid import Grouped

    return isinstance(x, Grouped)


def fold_device(devices) -> torch.device:
    """Where the per-partition values of storage groups on ``devices``
    meet: the host when a group lives there (one copy from each card's
    group, and a host scalar reaches a card without waiting for its
    stream), else the first group's device."""
    return next((d for d in devices if torch.device(d).type == "cpu"),
                devices[0])


def grid_fold_device(grid) -> torch.device:
    """:func:`fold_device` of a grid's storage groups."""
    return fold_device([grp.device for grp in grid._groups])


def per_partition(x, fn) -> torch.Tensor:
    """``[n, ...]``: ``fn`` of each held partition's rows of ``x`` (an
    ``[n, ...]`` tensor, or a ``Grouped`` whose partitions span
    devices), applied to each storage group's ``[n_g, ...]`` tensor at
    once and gathered, in partition order, on :func:`fold_device`."""
    if not _grouped(x):
        return fn(x)
    dev = fold_device(x.devices)
    parts = [fn(t).to(dev) for t in x.groups]
    out = torch.empty((len(x),) + tuple(parts[0].shape[1:]),
                      dtype=parts[0].dtype, device=dev)
    for slot, (g, i) in enumerate(x.where):
        out[slot] = parts[g][i]
    return out


def partition_sums(x) -> torch.Tensor:
    """``[n]`` sums of each partition's rows of ``x``, each one row's
    reduction (``reshape(n, -1).sum(dim=1)``), the same bits whether
    the partitions share one tensor or lie in groups on distinct
    devices of the host."""
    return per_partition(x, lambda t: t.reshape(_n(t), -1).sum(dim=1))


def all_finite(xs, group: bool = False) -> torch.Tensor:
    """``[n_dev]`` int32, every entry 1 iff every element of every
    ``[n_dev, ...]`` array in ``xs`` is finite on every partition: each
    partition folds its own ``all(isfinite)`` over the list, then one
    min over the partitions."""
    xs = list(xs)
    ok = torch.stack([per_partition(
        x, lambda t: torch.isfinite(t).reshape(_n(t), -1).all(dim=1))
        for x in xs]).all(dim=0).to(torch.int32)
    return all_reduce(ok, "min", group)


def field_sums(xs, group: bool = False) -> torch.Tensor:
    """``[n_dev, len(xs)]`` float32: each partition's sum of each array,
    cast to float32, then summed over the partitions, so every
    partition reads the same value."""
    parts = torch.stack([partition_sums(x).to(torch.float32)
                         for x in xs], dim=1)
    return all_reduce(parts, "sum", group)


def gather_objects(obj, nbytes: int = 0) -> list:
    """Every rank's ``obj``, in rank order, by one
    ``all_gather_object`` over the default group (``[obj]`` without
    one); ``nbytes``, the payload this rank sends, counts to the
    ``gather`` leg."""
    if not group_active():
        return [obj]
    parts = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(parts, obj)
    _count("gather", nbytes)
    return parts


def gather_rows(pos, vals: dict, n: int) -> dict:
    """``{name: [n, ...] host array}`` merged from every rank's rows:
    this rank holds ``vals[name]``, the rows at positions ``pos`` of
    ``n``; the other positions come from the other ranks."""
    parts = gather_objects((pos, vals), sum(v.nbytes for v in vals.values()))
    out = {}
    for name, v in vals.items():
        out[name] = np.zeros((n,) + v.shape[1:], dtype=v.dtype)
        for p, got in parts:
            out[name][p] = got[name]
    return out


def gather_partitions(x: torch.Tensor, held, n_dev: int) -> torch.Tensor:
    """``[n_dev, ...]``: every partition's row, from each rank's rows of
    the partitions it holds (``x`` ``[len(held), ...]``, ``held`` their
    global indices)."""
    held = np.asarray(held, dtype=np.int64)
    if len(held) == n_dev or not group_active():
        return x
    host = x.detach().cpu()
    out = torch.empty((n_dev,) + tuple(x.shape[1:]), dtype=x.dtype)
    for h, v in gather_objects((held, host),
                               host.numel() * host.element_size()):
        if len(h):
            out[torch.as_tensor(h)] = v
    return out.to(x.device)


def some_reduce(x: torch.Tensor, peer_mask, held=None) -> torch.Tensor:
    """Sum of ``x`` (``[n, ...]``) over each partition's peer set:
    ``peer_mask[q, p]`` true when partition q takes partition p's
    contribution. The result differs per partition. ``held`` (the
    global indices of ``x``'s rows, on a grid whose partitions span
    ranks) gathers the other ranks' rows first."""
    pm = np.asarray(peer_mask, dtype=bool)
    if held is not None:
        held = np.asarray(held, dtype=np.int64)
        full = gather_partitions(x, held, pm.shape[0])
        w = torch.as_tensor(pm[held], device=x.device).to(x.dtype)
        return torch.tensordot(w, full, dims=1)
    w = torch.as_tensor(pm, device=x.device).to(x.dtype)
    return torch.tensordot(w, x, dims=1)


def grid_total(grid, parts: torch.Tensor) -> torch.Tensor:
    """The sum over every partition of ``grid`` of ``parts``, one row
    per held partition (``[n_held, ...]``), added in partition order:
    each rank places its rows at their partitions' positions of an
    ``[n_dev, ...]`` zero tensor, one group ``all_reduce`` fills the
    rest exactly (a value plus zeros), and the partitions are summed
    as one process sums them. So every rank reads the one process's
    value bit for bit."""
    held = grid._held
    if len(held) == grid.n_dev:
        return parts.sum(dim=0)
    full = parts.new_zeros((grid.n_dev,) + tuple(parts.shape[1:]))
    full[torch.as_tensor(held, device=parts.device)] = parts
    if grid._rank_held and group_active():
        full = _group_reduce(full, "sum")
    return full.sum(dim=0)


def grid_field_totals(grid, names) -> dict:
    """``{name: float64 sum of the field over every cell of grid}``:
    each held partition's sum of its owned rows, then
    :func:`grid_total`, so every rank of a grid placed on a process
    group reads the one process's value bit for bit."""
    nl = np.asarray(grid.plan.n_local)
    dev = grid_fold_device(grid)
    parts = torch.stack([
        torch.stack([grid.data[n][i, :int(nl[p])].to(torch.float64).sum()
                     .to(dev) for n in names])
        for i, p in enumerate(grid._held)])
    return dict(zip(names, grid_total(grid, parts).cpu().tolist()))


def group_extreme(x, op: str, group: bool) -> torch.Tensor:
    """The ``op`` (``"min"`` or ``"max"``) of every element of ``x`` (a
    tensor, or a ``Grouped`` whose groups' extremes meet on
    :func:`fold_device`), then over the ranks of the default group when
    ``group``: exact, so every rank reads the same value whatever the
    split."""
    def ext(t):
        return t.amin() if op == "min" else t.amax()

    if _grouped(x):
        dev = fold_device(x.devices)
        r = ext(torch.stack([ext(t).to(dev) for t in x.groups]))
    else:
        r = ext(x)
    return all_reduce(r[None], op, group)[0]


def exact_sum(tensors, count: int, group: bool = False) -> float:
    """The float64 sum of every element of ``tensors`` (and of the other
    ranks' when ``group``), independent of how the elements are split
    into tensors, blocks or ranks and of the order of addition.

    Each element is cut into two parts on fixed binary grids chosen
    from the largest magnitude (a group max) and ``count``, an upper
    bound on the number of elements over every rank; on such a grid
    every partial sum is exact, so the two fold sums, and their group
    sum, are the same bits in any order (the pre-rounding of
    reproducible summation, Demmel and Nguyen). What the second fold
    drops is below ``max|x| * count**3 * 2**-101``: far below a float32
    sum's rounding. Non-finite values give the plain sum."""
    import math

    xs = [t.reshape(-1).to(torch.float64) for t in tensors if t.numel()]
    dev = xs[0].device if xs else torch.device("cpu")
    # every rank makes the same two reductions, whatever it holds
    peak = torch.zeros(1, dtype=torch.float64, device=dev)
    for x in xs:  # (the tensors may lie on distinct devices)
        peak = torch.maximum(peak, x.abs().amax()[None].to(dev))
    m = float(all_reduce(peak, "max", group)[0])
    k = max(int(count), 1).bit_length() + 2
    e1 = (math.frexp(m)[1] + k) if m > 0 else 0
    folds = torch.zeros(2, dtype=torch.float64, device=dev)
    if not math.isfinite(m) or not -960 < e1 < 1000:
        for x in xs:
            folds[0] += x.sum().to(dev)
    elif m > 0:
        s1, s2 = math.ldexp(1.0, e1), math.ldexp(1.0, e1 - 52 + k)
        for x in xs:
            q1 = (x + s1) - s1
            q2 = ((x - q1) + s2) - s2
            folds += torch.stack([q1.sum(), q2.sum()]).to(dev)
    folds = all_reduce(folds[None], "sum", group)[0].cpu()
    return float(folds[0]) + float(folds[1])


def pull_replicated(t) -> np.ndarray:
    """Host copy of a replicated result (every partition, and every
    rank after a group reduction, holds the same value)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _on(devices, x):
    """``(x as a tensor on the partitions' device, held, group)``;
    ``devices`` is the grid's partition list, or the grid itself (its
    held partitions, reduced over the ranks it spans). The leading axis
    must be the partition count (held partitions for a grid)."""
    held = group = None
    if hasattr(devices, "_held"):
        grid = devices
        held, group = grid._held, grid._rank_held
        devs = [grid_fold_device(grid)] * len(held)
    else:
        devs = list(devices)
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x, device=devs[0])
    if t.shape[0] != len(devs):
        raise ValueError(f"leading axis {t.shape[0]} != {len(devs)} "
                         "partitions")
    return t, held, bool(group)


def host_all_gather(devices, x) -> np.ndarray:
    """:func:`all_gather` of ``[n_dev, ...]`` rows on ``devices`` (the
    grid's partition list); returns ``[n_dev, n_dev, ...]``."""
    t, held, group = _on(devices, x)
    if group:
        t = gather_partitions(t, held, devices.n_dev)
    return pull_replicated(all_gather(t))


def host_all_reduce(devices, x, op: str = "sum") -> np.ndarray:
    """Reduce ``[n_dev, ...]`` rows over the partitions; one row."""
    t, _held, group = _on(devices, x)
    return pull_replicated(all_reduce(t, op, group)[0])


def host_some_reduce(devices, x, peer_mask) -> np.ndarray:
    """Per-partition peer-set sum of ``[n_dev, ...]`` rows (a grid's
    held rows under a split over ranks)."""
    t, held, group = _on(devices, x)
    return pull_replicated(some_reduce(t, peer_mask,
                                       held if group else None))


# ---------------------------------------------------------------------
# the cross-rank transport
# ---------------------------------------------------------------------

def _count(leg: str, n: int) -> None:
    telemetry.inc("dccrg_rank_bytes_total", int(n), leg=leg,
                  transport=transport_name())


def pack(tensors) -> torch.Tensor:
    """One flat ``uint8`` buffer of the tensors' bytes, in order, on
    their device (empty tensors allowed)."""
    parts = [t.contiguous().reshape(-1).view(torch.uint8) if t.numel()
             else t.new_empty(0, dtype=torch.uint8) for t in tensors]
    if not parts:
        return torch.empty(0, dtype=torch.uint8)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unpack(buf: torch.Tensor, specs) -> list:
    """The tensors :func:`pack` packed: ``specs`` is ``(shape, dtype)``
    per tensor, in order."""
    out, at = [], 0
    for shape, dtype in specs:
        n = int(np.prod(shape, dtype=np.int64)) * \
            torch.empty((), dtype=dtype).element_size()
        out.append(buf[at:at + n].clone().view(dtype).reshape(shape))
        at += n
    if at != buf.numel():
        raise ValueError(f"unpacked {at} of {buf.numel()} bytes")
    return out


def device_copy(src: torch.Tensor, device, leg: str = "device_halo"
                ) -> torch.Tensor:
    """``src`` copied with ``copy_`` into a buffer allocated on
    ``device``: the transport between the devices of one process (never
    ``.to()``, which may hand back ``src`` itself when the labels
    compare equal). A card's source is read after the work its stream
    has queued (an event the destination waits on); a copy into host
    memory lands in a pinned buffer and is synchronised before it is
    returned, so the host may read it. Counts the bytes under ``leg``
    (``dccrg_rank_bytes_total``, transport ``device-copy``). A failed
    copy raises."""
    dst = torch.device(device)
    with telemetry.span("comm.device_copy", {"leg": leg}):
        # (a copy between two cards is written and untried: it waits for
        # a machine with a second card, ROADMAP.md item 5b.1d, blocked)
        if src.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(src.device))
            if dst.type == "cuda":
                out = torch.empty(tuple(src.shape), dtype=src.dtype,
                                  device=dst)
                stream = torch.cuda.current_stream(dst)
                stream.wait_event(ev)
                with torch.cuda.stream(stream):
                    out.copy_(src, non_blocking=True)
                src.record_stream(stream)
            else:
                out = torch.empty(tuple(src.shape), dtype=src.dtype,
                                  pin_memory=True)
                out.copy_(src, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(src.device))
                done.synchronize()
        else:
            out = torch.empty(tuple(src.shape), dtype=src.dtype, device=dst)
            out.copy_(src)
    telemetry.inc("dccrg_rank_bytes_total",
                  int(src.numel()) * src.element_size(), leg=leg,
                  transport="device-copy")
    return out


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A send buffer as a host tensor: pinned and filled by one copy
    from the card, or the tensor itself on the CPU."""
    if t.device.type == "cpu":
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _host_buffer(n: int, device) -> torch.Tensor:
    return torch.empty(n, dtype=torch.uint8,
                       pin_memory=torch.device(device).type == "cuda")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class Posted:
    """An exchange in flight: the ``isend`` / ``irecv`` works and the
    host buffers the receives land in."""

    def __init__(self, works, recvs, keep, device):
        self.works = works
        self.recvs = recvs
        self.keep = keep  # send buffers alive until the works finish
        self.device = device


def post_exchange(sends: dict, recv_sizes: dict, device,
                  leg: str = "halo") -> Posted:
    """Start one exchange: ``sends[r]`` (a ``uint8`` buffer on
    ``device``) goes to rank ``r`` by ``isend``; a buffer of
    ``recv_sizes[r]`` bytes from each rank ``r`` is posted by ``irecv``.
    Every rank posts in ascending peer order with the sizes its
    replicated plan gives, so each send meets its receive."""
    dist = torch.distributed
    with telemetry.span("comm.exchange.post",
                        {"transport": transport_name(), "leg": leg}):
        hosts = {r: _to_host(b) for r, b in sends.items() if b.numel()}
        if hosts:
            _sync(device)
        works, recvs = [], {}
        for r in sorted(recv_sizes):
            if recv_sizes[r]:
                buf = _host_buffer(int(recv_sizes[r]), device)
                recvs[r] = buf
                works.append(dist.irecv(buf, src=int(r)))
        for r in sorted(hosts):
            works.append(dist.isend(hosts[r], dst=int(r)))
            _count(leg, hosts[r].numel())
    return Posted(works, recvs, hosts, device)


def wait_exchange(posted: Posted) -> dict:
    """Finish an exchange: ``{rank: uint8 buffer on the device}`` of
    what each peer sent."""
    with telemetry.span("comm.exchange.wait",
                        {"transport": transport_name()}):
        for w in posted.works:
            w.wait()
        dev = torch.device(posted.device)
        out = {r: (b if dev.type == "cpu" else b.to(dev, non_blocking=True))
               for r, b in posted.recvs.items()}
    posted.keep = None
    return out


def move_bytes(sends: dict, recv_sizes: dict, device,
               leg: str = "rows") -> dict:
    """One ``all_to_all_single`` over the default group: ``sends[r]``
    (``uint8`` on ``device``) to rank ``r``, ``recv_sizes[r]`` bytes
    from rank ``r``. Collective: every rank calls it, with the sizes its
    replicated plans give. Returns ``{rank: uint8 buffer on device}``."""
    dist = torch.distributed
    n = dist.get_world_size()
    me = dist.get_rank()
    with telemetry.span("comm.move_rows",
                        {"transport": transport_name(), "leg": leg}):
        ins = [sends.get(r) if r != me else None for r in range(n)]
        in_sizes = [0 if b is None else int(b.numel()) for b in ins]
        out_sizes = [0 if r == me else int(recv_sizes.get(r, 0))
                     for r in range(n)]
        flat = pack([b for b in ins if b is not None])
        src = _to_host(flat)
        _sync(device)
        dst = _host_buffer(sum(out_sizes), device)
        dist.all_to_all_single(dst, src, output_split_sizes=out_sizes,
                               input_split_sizes=in_sizes)
        _count(leg, sum(in_sizes))
        dev = torch.device(device)
        if dev.type != "cpu":
            dst = dst.to(dev)
        out, at = {}, 0
        for r in range(n):
            if out_sizes[r]:
                out[r] = dst[at:at + out_sizes[r]]
            at += out_sizes[r]
    return out
