"""The three roofline inputs of one eager step, counted as it runs.

The torch counterpart of ``repro.launch.hlo_analysis``, which re-derives
them from XLA's compiled per-chip HLO text.  Here there is no compiled
program: the step runs eagerly (on the meta device under torch's fake
process group, for the dry run), and ``OpCounter``, a
``TorchDispatchMode``, sees every op each device would run:

  * **flops**: ``torch.utils.flop_counter``'s formula for every op it
    knows (matmuls, convolutions, attention), applied to the op's *local*
    shapes.  A DTensor op is let through to DTensor (the mode returns
    ``NotImplemented`` for it), which runs it on the local blocks, and
    those local ops are what is counted: the FLOPs of one device, not
    the global shapes' FLOPs (which a ``FlopCounterMode`` around DTensors
    reports).  The fake-tensor ops DTensor runs to infer global shapes
    are not counted.
  * **hbm bytes**: each op's tensor operands and outputs, local bytes,
    read once and written once.  In eager PyTorch each op is about one
    kernel, so this is the program's memory traffic to first order.
    Views cost nothing; a write into a slice (``copy_`` into a view) is
    charged the slice, not the buffer it lies in; an indexed write
    (``index_put_``, ``scatter``) is charged what it writes, not the
    whole destination.
  * **collectives**: each ``_c10d_functional`` op's tensor bytes times
    the reference's ring factors for its group size (N participants):
    all-gather out × (N−1)/N, reduce-scatter in × (N−1)/N, all-reduce
    2 × bytes × (N−1)/N, all-to-all bytes × (N−1)/N; counts by kind.

Every iteration of an eager loop is dispatched, so loops need no trip
counts.  A caller may still trace one of several identical iterations
and weight it (``weight``), as the reference weights a loop body by its
trip count: the dry run traces one microbatch of the train step.  All
quantities are per device (this process is one rank of the mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
}

_RING = {
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1) / n,  # applied to the FULL input
    "all-reduce": lambda n: 2 * (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
}

# ops that move no data: allocation without a write, bookkeeping, waits
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias",
         "wait_tensor", "_local_scalar_dense", "_to_copy_meta", "set_",
         "resize_", "_has_compatible_shallow_copy_type", "is_same_size"}
# indexed writes: the destination is charged only where written
_SCATTERS = {"index_put_", "index_put", "_index_put_impl_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "index_copy_",
             "index_copy", "index_add_", "index_add"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _group_size(func_name: str, args) -> int:
    if func_name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    import torch.distributed.distributed_c10d as c10d

    return int(c10d._resolve_process_group(args[-1]).size())


def _traffic(name, func, args, kwargs, out) -> int:
    """Bytes one op reads and writes (the module docstring's model)."""
    ins = list(_tensors((args, kwargs)))
    if name in _SCATTERS:  # the destination: charged as the values written
        vals = [t for t in ins[1:] if t.is_floating_point()]
        return sum(_bytes(t) for t in ins[1:]) + sum(_bytes(t)
                                                     for t in vals[-1:])
    if name == "copy_":  # a write of the source into dest (a slice)
        return _bytes(ins[0]) + _bytes(ins[1])
    if func._schema.is_mutable:  # in place: the first operand written back
        return sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in ins[:1])
    return sum(_bytes(t) for t in ins) + sum(_bytes(t)
                                             for t in _tensors(out))


@dataclasses.dataclass
class OpStats:
    flops: float  # per device
    hbm_bytes: float  # per device traffic model
    wire_bytes: float  # per device collective bytes (ring factors applied)
    collective_ops: Dict[str, int]
    ops: int  # local ops dispatched
    largest_group: int  # the largest collective group seen

    def as_dict(self):
        return dataclasses.asdict(self)


class OpCounter(TorchDispatchMode):
    """While entered, counts flops, HBM bytes and collective wire bytes of
    every local op (see the module docstring); ``stats()`` reads them."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0.0
        self.hbm = 0.0
        self.wire = 0.0
        self.coll: Dict[str, int] = {}
        self.ops = 0
        self.group = 1
        self.weight = 1.0  # what each op counts for (a loop's trip count)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        names = {t.__name__ for t in types}
        if "DTensor" in names:
            return NotImplemented  # let DTensor run its local ops here
        out = func(*args, **kwargs)
        if "FakeTensor" in names:  # DTensor inferring global shapes
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns == "_c10d_functional" and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            n = _group_size(name, args)
            nbytes = _bytes(out if kind == "all-gather" else args[0])
            self.coll[kind] = self.coll.get(kind, 0) + int(self.weight)
            self.group = max(self.group, n)
            if n > 1:
                self.wire += self.weight * nbytes * _RING[kind](n)
            return
        if ns in ("_c10d_functional", "c10d", "_dtensor") or name in _FREE:
            return
        self.ops += int(self.weight)
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += self.weight * float(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        if not _is_view(func):
            self.hbm += self.weight * _traffic(name, func, args, kwargs, out)

    def stats(self) -> OpStats:
        return OpStats(self.flops, self.hbm, self.wire, dict(self.coll),
                       self.ops, self.group)
