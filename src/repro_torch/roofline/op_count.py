"""Op counter: FLOPs, traffic and peak live bytes of one rank's step,
counted op by op as it runs (the port's counterpart of the reference's
`roofline/hlo_parse.py`, which reads them from compiled HLO; torch has
no HLO).

`OpCounter` is a `TorchDispatchMode`.  Over the ops that run under it
it counts:
  flops        the products only, as `hlo_parse._dot_flops` counts a
               dot: 2 x output elements x contracted size (mm, bmm,
               addmm, baddbmm and attention kernels, by
               `torch.utils.flop_counter`'s formulas)
  traffic      the output bytes of every op that writes memory (views
               write none; in-place ops write their output): the
               pre-fusion eager traffic the port really runs, where the
               reference counts post-fusion HLO
  peak bytes   live storage: the tracked arguments, plus every storage
               an op allocates, until it is freed (donated and in-place
               state is one storage, counted once)
Collectives (`c10d` ops) are not counted here: their bytes are
`utils.sharding.comm_log`'s.  It runs on any device; on meta tensors
(the dry run) nothing is computed and nothing is allocated.

Ops on DTensors (the mode sees them before the subclass runs them) are
counted at their local blocks' shapes; a collective that DTensor's own
sharding propagation would issue is not seen (the port's model code
computes on local blocks and calls `utils.sharding`'s counted
collectives).
"""
from __future__ import annotations

import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

_SKIP_NAMESPACES = ("c10d", "_c10d_functional", "_dtensor")


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, traffic bytes and live bytes of the ops run under it
    (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.traffic = 0.0
        self.live = 0
        self.peak = 0
        self._tracked: set = set()

    def track(self, tree) -> None:
        """Count the storages of the tensors in `tree` (the step's
        arguments) as live from now until they are freed."""
        for t in tree_flatten(tree)[0]:
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                self._alloc(t)

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._tracked:
            return
        n = st.nbytes()
        self._tracked.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._tracked.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in _SKIP_NAMESPACES:
            return out
        local_out = out
        if any(issubclass(t, DTensor) for t in types):
            # a DTensor op is counted at its local blocks' shapes
            args, kwargs, local_out = tree_map(_local, (args, kwargs, out))
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=local_out))
        rets = func._schema.returns
        outs = local_out if len(rets) > 1 else (local_out,)
        for ret, o in zip(rets, outs):
            alias = ret.alias_info
            if alias is not None and not alias.is_write:
                continue                  # a view: no bytes written
            for t in (o if isinstance(o, (tuple, list)) else (o,)):
                if isinstance(t, torch.Tensor):
                    self.traffic += _nbytes(t)
                    self._alloc(t)
        return out

    def summary(self) -> dict:
        return {"flops": self.flops, "traffic_bytes": self.traffic,
                "peak_bytes": self.peak}
