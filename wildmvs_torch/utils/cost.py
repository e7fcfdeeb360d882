"""The cost of one eager forward: the flops and bytes of what it runs.

Counterpart of XLA's `cost_analysis()` of the compiled forward, which
bench.py reads as `flops` and `bytes accessed` (bench.py:194-211). Eager
PyTorch has no compiled program to analyse, so `CostCounter` counts what
the forward dispatches:

  flops   per aten op, by the formulas of `torch.utils.flop_counter`
          (convolutions and transposed convolutions as 2 * MACs, matrix
          products); an op it has no formula for (elementwise, reductions,
          gathers) counts none. XLA also counts elementwise flops, so the
          two agree on conv-dominated networks and XLA's is the larger.
  bytes   per aten op, the bytes of its distinct tensor inputs and outputs
          (an expanded input counts the elements it holds). This is what
          the eager implementation moves, op by op, not an algorithmic
          minimum: an intermediate is written by one op and read by the
          next, and the L2 cache may serve either. View ops and allocations
          (`empty`, `empty_strided`) move nothing and count none.
  kernels each launch of a port kernel (ops/sweep_kernels.py) is a ctypes
          call that no dispatch mode sees: its wrapper hands its inputs
          to an `on_launch` hook, and the bytes and f32 operations of the
          launch are counted on them (`sweep_kernels.WORK`, the rule of the
          kernels' bounds). The bytes are added to the aten bytes; the
          operations are kept apart (`kernel_operations`), since they run
          on the CUDA cores in f32 while the aten flops of a bf16 network
          are tensor-core convolutions. Their output allocations are
          dispatched and counted as aten ops.

Counting is a dispatch mode over the whole forward: it adds Python work to
every op and a pass over every sample to each kernel launch. Run it over
one extra, untimed forward.
"""
from __future__ import annotations

import collections
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..ops import sweep_kernels

_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default}


def _tensors(tree):
    """The tensors in nested lists, tuples and dicts of arguments."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements a strided tensor holds: an expanded
    (stride-0) dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


class _Dispatch(TorchDispatchMode):
    """The dispatch mode of a CostCounter: counts each aten op into it."""

    def __init__(self, counter: "CostCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in flop_registry:
            # a composite op (conv3d, linear) counts as the ops it runs
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        c = self.counter
        if c._paused:
            return out
        c.op_calls[str(func.overloadpacket)] += 1
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            c.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view and func not in _ALLOCATIONS:
            seen = set()
            for t in _tensors((args, kwargs, out)):
                if t.layout != torch.strided:
                    continue
                key = (t.untyped_storage().data_ptr(), t.storage_offset(),
                       tuple(t.shape), t.stride(), t.dtype)
                if key not in seen:
                    seen.add(key)
                    c.bytes += tensor_bytes(t)
        return out


class CostCounter:
    """Counts the flops and bytes of the ops and kernel launches run inside
    it (module docstring).

        with torch.inference_mode(), CostCounter() as cost:
            model(*args)
        cost.flops, cost.kernel_operations, cost.bytes, cost.kernels

    Attributes:
      flops: aten flops (convolutions and matrix products).
      kernel_operations: the kernels' f32 operations.
      bytes: aten bytes plus the kernels' bytes.
      op_calls: Counter of aten op calls by name.
      kernels: (kernel name, sweep_kernels.KernelWork) of each launch.
    """

    def __init__(self):
        self.flops = 0
        self.kernel_operations = 0
        self.bytes = 0
        self.op_calls = collections.Counter()
        self.kernels = []
        self._paused = 0
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(sweep_kernels.on_launch(self._kernel))
        self._stack.enter_context(_Dispatch(self))
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def _kernel(self, name: str, inputs, out) -> None:
        self._paused += 1            # the count's own ops are not the model's
        try:
            w = sweep_kernels.WORK[name](*inputs)
        finally:
            self._paused -= 1
        self.kernels.append((name, w))
        self.kernel_operations += w.operations
        self.bytes += w.bytes
