"""Step-cost walker: per-device FLOPs, memory traffic and collective bytes
of one train, prefill or decode step, traced on fake tensors.

It takes the place of the reference's ``tools/hlo_analysis.py``, which
parses the SPMD program XLA compiled for one device; the port has no such
program. Instead the step runs once under ``FakeTensorMode`` (shapes, no
storage) at its global shape, on the plain route (every kernel's wrapper
takes its CPU version, which computes the same function), under
``StepCostMode``, a ``TorchDispatchMode`` that sees every aten op:

  flops            the op's FLOPs by ``torch.utils.flop_counter``'s
                   formulas (the ones ``FlopCounterMode`` applies: matrix
                   products, convolutions, attention), divided by the
                   devices that split the op's work;
  bytes            each operand read once and each result written once,
                   each tensor divided by the devices it is split over, at
                   the boundaries XLA's fusion would leave, as the
                   reference's walker counts bytes at fusion boundaries:
                   pointwise ops (``torch.Tag.pointwise``, dtype casts,
                   fills) fuse, so their results stay in registers; a fused
                   op reads what lies in memory and writes where it updates
                   memory in place, and the op that consumes a fused result
                   reads it;
                   views and buffers made from a shape move nothing; a
                   layer's slice of a stacked gradient is written once,
                   where the eager backward writes a buffer of the whole
                   stack and adds the layers' buffers; a gather or an indexed write moves
                   its region (twice its result or its values), not the
                   whole table, as the reference's walker counts slices;
  collective_bytes ring-model bytes a device sends (the reference's:
                   all-reduce 2(n-1)/n * size, all-gather / reduce-scatter
                   (n-1)/n * size) for the transfers the placements imply:
                   a reduction wherever an op contracts or indexes over a
                   dimension its operands split (below), and FSDP's
                   parameter gathers, once a step and once more in a train
                   step's backward;
  temp_bytes       the peak of the bytes live in storages the step made,
                   per device. A buffer made from a shape alone (``empty``,
                   ``zeros``, ``new_zeros``) is split as its first in-place
                   write is (the logits that a loss chunk writes slab by
                   slab); one never written in place is a constant that a
                   compiler folds and counts nothing.

The eager step computes some products twice where XLA's common-
subexpression elimination computes them once: the blocked attention's
backward recomputes each block's scores in its dq pass and again in its
dk/dv pass, and a checkpointed loss chunk recomputes its logits. Each op
is therefore also numbered by value (the op and the value numbers of its
inputs), and ``global_unique_flops`` counts each distinct product once,
the count to hold against the reference's compiled program; ``flops`` and
``global_flops`` count what runs.

How work splits. Every tensor carries the set of mesh axes it is split
over. Parameters and optimizer moments take their ``NamedSharding``'s
axes, inputs and caches theirs, and ``models.blocks.shard_batch`` places
the residual stream (``distributed.sharding.use_mesh``'s listener). While
the loss and its gradients are computed, parameters count as gathered over
the data axes (FSDP is ZeRO-3); in the optimizer update they count as
sharded. An op's work is split over the union of its operands' axes, and
its results carry that union, except:

  * a matrix product (``mm``, ``addmm``) whose two operands share an axis
    contracts over it: its result is a partial sum that the axis reduces
    (tensor parallelism's row-parallel products over "model"; the weight
    gradients over the data axes, an all-reduce, or under FSDP a
    reduce-scatter whose result stays split over the data axes);
  * a gather from a table split over an axis its indices are not
    (``embed[tokens]`` over the vocabulary, the MoE combine over the
    experts) is completed by an all-reduce over that axis; an accumulating
    scatter into a table's rows (the embedding's gradient) by a reduction
    over the axes of its values and indices that its target lacks. A
    ``scatter_add`` along a row's own entries (a gather's gradient) stays
    on its device.

With ``seq_shard`` the residual stream is split over "model" along its
sequence (``model@seq`` here). A product whose other operand is split over
"model" along its features (a column-parallel weight, the vocabulary head)
first gathers the sequence: an all-gather over "model", as sequence
parallelism does before each tensor-parallel region.

A batched product (``bmm``) keeps a shared axis as a split of its batch
dimension (the attention's heads, the experts) where the batch divides by
the axis, and contracts over it otherwise (an ``einsum`` projection
lowered to a batch of one; eight experts on a model axis of 16, whose
weights split their width instead). Softmax and norm reductions
over a split dimension are left out (a few bytes a row). This is a model
of an SPMD partitioning, not XLA's partitioner: its choices are stated here
so that they can be read against the reference's compiled numbers.
"""

from __future__ import annotations

import itertools
import math
import weakref
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..distributed.sharding import NamedSharding, Spec, mesh_sizes

__all__ = ["StepCosts", "StepCostMode"]

aten = torch.ops.aten
_DEVICE = torch.ops.prim.device.default
_DATA = frozenset(("pod", "data"))
_NONE: FrozenSet[str] = frozenset()
_SEQ = "model@seq"              # "model" along a residual stream's sequence
_CONTRACT = {aten.mm: (0, 1), aten.addmm: (1, 2)}
_PRODUCT = {**_CONTRACT, aten.bmm: (0, 1), aten.baddbmm: (1, 2)}
_GATHER = {aten.index, aten.embedding, aten.index_select, aten.gather}
# scatters that add rows picked by index values (a table's rows): another
# device's tokens may add into the same row
_SCATTER = {aten.index_put, aten.index_put_, aten._index_put_impl_, aten.index_add,
            aten.index_add_, aten.embedding_dense_backward}
_ACCUMULATE_FLAG = {aten.index_put, aten.index_put_, aten._index_put_impl_}
_WRITE_REGION = _SCATTER | {aten.scatter, aten.scatter_, aten.scatter_add, aten.scatter_add_,
                            aten.slice_scatter, aten.select_scatter, aten.copy_}
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
             aten.new_empty_strided, aten._local_scalar_dense, aten.lift_fresh,
             aten.lift_fresh_copy, aten._unsafe_view}
# fused into their neighbours, as XLA fuses elementwise work: casts, fills
# and every op torch tags pointwise
_FUSED = {aten._to_copy, aten.fill_}
# the backward of taking a layer's slice of a stacked parameter: the eager
# step writes it into a zero buffer of the whole stack and adds the layers'
# buffers; counted as a scanned program moves it, the slice written once
_SLICE_GRAD = {aten.select_backward, aten.slice_backward}
# made from a shape (and, for new_*, a dtype and device): no split of their own
_FACTORY_OF = {aten.new_empty, aten.new_zeros, aten.new_ones, aten.new_full,
               aten.new_empty_strided}


@dataclass
class StepCosts:
    """Per-device totals of one step (the fields of the reference's
    ``HloCosts`` that the roofline reads, plus the trace's global totals)."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, float] = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)
    global_flops: float = 0.0       # the whole step, unsplit (FlopCounterMode's total)
    global_unique_flops: float = 0.0  # each distinct product once
    global_bytes: float = 0.0
    temp_bytes: float = 0.0
    n_ops: int = 0


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _ring(kind: str, n: int, size: float) -> float:
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * size
    return (n - 1) / n * size


class StepCostMode(TorchDispatchMode):
    """Counts one step's per-device costs; see the module docstring."""

    def __init__(self, mesh, fsdp: bool):
        super().__init__()
        self.sizes = mesh_sizes(mesh)
        self.fsdp = fsdp
        self.gathered = True            # parameters gathered over data (forward, backward)
        self._tags = WeakIdKeyDictionary()
        self._param_tags = WeakIdKeyDictionary()
        self._live: Dict[int, float] = {}
        self._storages = WeakIdKeyDictionary()
        self._pending: Dict[int, torch.Tensor] = {}   # storages made from a shape, unwritten
        self._fused = WeakIdKeyDictionary()            # results that stay in registers
        self._live_bytes = 0.0
        self.costs = StepCosts()
        self._values = WeakIdKeyDictionary()   # tensor -> value number
        self._numbers = itertools.count()
        self._keys: Dict[tuple, int] = {}       # (op, inputs' values) -> its first result's

    # ------------------------------------------------------------ placement
    def _div(self, axes: Iterable[str]) -> int:
        return math.prod(self.sizes["model" if a == _SEQ else a] for a in axes)

    def place(self, t: torch.Tensor, sharding: NamedSharding, param: bool = False) -> None:
        """Give a step input its placement (``param``: a parameter leaf)."""
        axes = frozenset(a for a in sharding.axes() if self.sizes[a] > 1)
        (self._param_tags if param else self._tags)[t] = axes

    def on_place(self, x: torch.Tensor, spec: Spec) -> None:
        """``sharding.use_mesh`` listener: an activation placed by
        ``shard_batch`` is split over exactly the spec's axes ("model" past
        the batch dimension is the sequence's)."""
        axes = set(NamedSharding(None, spec[:1]).axes())
        if "model" in NamedSharding(None, spec[1:]).axes():
            axes.add(_SEQ)
        self._tags[x] = frozenset(axes)

    def tag(self, t: torch.Tensor) -> FrozenSet[str]:
        if t in self._param_tags:
            full = self._param_tags[t]
            return full - _DATA if self.gathered else full
        return self._tags.get(t, _NONE)

    def per_device(self, t: torch.Tensor) -> float:
        return _nbytes(t) / self._div(self.tag(t))

    # ---------------------------------------------------------- collectives
    def collective(self, kind: str, axes: FrozenSet[str], size: float) -> None:
        n = self._div(axes)
        if n <= 1:
            return
        wire = _ring(kind, n, size)
        self.costs.collective_bytes += wire
        self.costs.collectives[kind] = self.costs.collectives.get(kind, 0.0) + wire

    def param_gathers(self, params: Iterable[torch.Tensor], times: int) -> None:
        """FSDP's all-gathers over the data axes of each parameter leaf,
        ``times`` a step."""
        for p in params:
            full = self._param_tags.get(p, _NONE)
            data = full & _DATA
            if data:
                size = _nbytes(p) / self._div(full - _DATA)
                for _ in range(times):
                    self.collective("all-gather", data, size)

    def _value(self, t: torch.Tensor) -> int:
        v = self._values.get(t)
        if v is None:
            v = self._values[t] = next(self._numbers)
        return v

    # -------------------------------------------------------------- memory
    def _track(self, o: torch.Tensor, pending: bool) -> None:
        st = o.untyped_storage()
        if st in self._storages:
            return
        key = id(st)
        self._storages[st] = key
        self._live[key] = 0.0
        weakref.finalize(st, self._free, key)
        if pending:
            self._pending[key] = weakref.ref(o)
        else:
            self._resize(key, _nbytes(o) / self._div(self.tag(o)))

    def _resize(self, key: int, per_device: float) -> None:
        self._live_bytes += per_device - self._live[key]
        self._live[key] = per_device
        self.costs.temp_bytes = max(self.costs.temp_bytes, self._live_bytes)

    def _free(self, key: int) -> None:
        self._pending.pop(key, None)
        self._live_bytes -= self._live.pop(key, 0.0)

    def _written(self, t: torch.Tensor, tags: FrozenSet[str]) -> None:
        """An in-place write with ``tags`` into ``t``: the tags reach every
        base ``t`` is a view of, and a pending buffer takes its split."""
        while t is not None:
            self._tags[t] = self.tag(t) | tags
            key = self._storages.get(t.untyped_storage())
            if key is not None and key in self._pending:
                base = self._pending[key]()
                if base is not None and base is t:
                    del self._pending[key]
                    self._resize(key, _nbytes(t) / self._div(self.tag(t)))
            t = t._base

    # --------------------------------------------------------------- bytes
    def _moved(self, func, packet, ins, outs, out_tag) -> tuple:
        """(per-device, global) bytes an op moves. A fused op's result stays
        in registers: it reads what is in memory (operands no fused op
        made) and writes only where it updates memory in place; the op that
        consumes a fused result reads it."""
        def read(ts):
            return (sum(self.per_device(t) for t in ts if t not in self._fused),
                    sum(_nbytes(t) for t in ts if t not in self._fused))

        inplace = [o for o in outs if any(o is t for t in ins)]
        if _fuses(func, packet):
            r, g = read(ins)
            return (r + sum(self.per_device(o) for o in inplace if o not in self._fused),
                    g + sum(_nbytes(o) for o in inplace if o not in self._fused))
        if packet in _SLICE_GRAD:
            return 2.0 * self.per_device(ins[0]), 2.0 * _nbytes(ins[0])
        if packet in _GATHER:
            r, g = read(ins[1:])
            return (r + sum(2.0 * _nbytes(o) / self._div(out_tag) for o in outs),
                    g + sum(2.0 * _nbytes(o) for o in outs))
        if packet in _WRITE_REGION:
            r, g = read(ins[1:])
            return (r + sum(self.per_device(t) for t in ins[1:]),
                    g + sum(_nbytes(t) for t in ins[1:]))
        r, g = read(ins)
        r += sum(self.per_device(o) for o in inplace)
        g += sum(_nbytes(o) for o in inplace)
        fresh = [o for o in outs if all(o is not t for t in ins)]
        return (r + sum(_nbytes(o) / self._div(out_tag) for o in fresh),
                g + sum(_nbytes(o) for o in fresh))

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _DEVICE:
            return out
        packet = func._overloadpacket
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        factory = packet in _FACTORY_OF or not ins
        seen = {}
        if packet in _PRODUCT:
            for i, j in (_PRODUCT[packet], _PRODUCT[packet][::-1]):
                ta, tb = self.tag(args[i]), self.tag(args[j])
                if _SEQ in ta and "model" in tb:      # gather the sequence first
                    seen[id(args[i])] = ta - {_SEQ}
                    self.collective("all-gather", frozenset({"model"}),
                                    _nbytes(args[i]) / self._div(ta - {_SEQ}))
        tags = [seen.get(id(t), self.tag(t)) for t in ins]
        work = _NONE if packet in _FACTORY_OF else frozenset().union(*tags)
        reduced = _NONE
        if packet in _PRODUCT:
            a, b = (args[i] for i in _PRODUCT[packet])
            reduced = seen.get(id(a), self.tag(a)) & seen.get(id(b), self.tag(b))
            if packet not in _CONTRACT:            # bmm: a batch too small for an axis
                reduced = frozenset(x for x in reduced if a.shape[0] % self._div((x,)))
        elif packet in _GATHER:
            reduced = self.tag(ins[0]) - frozenset().union(*(self.tag(t) for t in ins[1:]))
        elif packet in _SCATTER and (packet not in _ACCUMULATE_FLAG
                                     or _accumulates(args, kwargs)):
            target = self.tag(ins[0]) if packet is not aten.embedding_dense_backward else _NONE
            reduced = work - target
        out_tag = work - reduced
        scattered = bool(reduced) and self.fsdp and reduced <= _DATA
        if scattered:                 # a reduce-scatter leaves each device its shard
            out_tag = work

        key = (func, tuple(("t", self._value(a)) if isinstance(a, torch.Tensor) else _hashable(a)
                           for a in tree_leaves((args, kwargs))))
        first = key not in self._keys
        if first:
            self._keys[key] = next(self._numbers)
        c = self.costs
        c.n_ops += 1
        div = self._div(work)
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.global_flops += f
            c.global_unique_flops += f if first else 0.0
            c.flops += f / div
        if not (factory or func.is_view or packet in _NO_BYTES):
            moved, glob = self._moved(func, packet, ins, outs, out_tag)
            c.bytes += moved
            c.global_bytes += glob
        fused = _fuses(func, packet)
        for i, o in enumerate(outs):
            if any(o is t for t in ins):          # written in place: a new value
                self._written(o, out_tag)
                self._values[o] = next(self._numbers)
                continue
            self._tags[o] = out_tag
            if fused or packet in _SLICE_GRAD or (func.is_view
                                                  and any(t in self._fused for t in ins)):
                self._fused[o] = True
            self._values[o] = hash((self._keys[key], i))
            if not func.is_view and packet is not aten._local_scalar_dense:
                self._track(o, pending=factory)
        if reduced:
            kind = "reduce-scatter" if scattered else "all-reduce"
            for o in outs:
                self.collective(kind, reduced, _nbytes(o) / self._div(work - reduced))
        return out


def _fuses(func, packet) -> bool:
    return packet in _FUSED or torch.Tag.pointwise in func.tags


def _hashable(a):
    try:
        hash(a)
        return a
    except TypeError:
        return repr(a)


def _accumulates(args, kwargs) -> bool:
    if "accumulate" in kwargs:
        return bool(kwargs["accumulate"])
    return len(args) > 3 and bool(args[3])
