"""Per-rank cost counting of a step as it runs (the counterpart of
``repro/dist/hlo_costs.py``).

The reference compiles each step and parses the optimized HLO.  The port
has no HLO: it counts the rank's program while it runs, on any device, the
"meta" device included (no memory, no card), under ``OpCounter``, a
``TorchDispatchMode`` over the aten operations.

Cost model per operation:

* flops: ``torch.utils.flop_counter``'s registered formulas, which follow
  the reference's rule (a product ``dot`` = 2 * out_elems * contraction;
  elementwise operations are not counted);
* bytes: operand bytes + output bytes of every operation that is not a view
  or a bare allocation.  Eager PyTorch fuses nothing: every operation
  reads its operands from and writes its output to device memory.  So this
  count is each operation's, where the reference's excludes the interiors
  of XLA's fusions; it is the eager program's traffic, larger than a
  fused program's;
* the hand-written kernels (K1, K2, K2's latent form, K3, K3-bwd, K4,
  K4-bwd, K5, K6): each entry records its own FLOPs and bytes through one
  hook (``counted``), from the formulas of its tuner family in
  ``repro_torch.kernels.tune.roofline`` (K3-bwd and K4-bwd, which have no
  family, from the bounds of PERF.md, put into functions there).  While an
  entry runs, the counter counts only that record, not the aten operations
  of its wrapper or of its plain version: the kernel on the card, its plain
  version on the CPU and its meta branch count the same;
* collectives (``repro_torch.dist.collectives`` reports each one):
  operand bytes, plus a ring-model wire estimate per kind with the
  reference's factors (``WIRE_FACTOR``, copied from ``hlo_costs.py``), n the
  group's size; also by mesh axis, since the card's links differ by axis.

Loops: the port has no while loop.  Layer stacks and scans run unrolled in
Python, so every count is trip-count-exact by construction and
``n_whiles`` stays 0.

Memory (``memory_analysis``): the counter follows every storage the step
allocates until it is freed (the meta device's storages too), so it gives
the peak of live bytes during the step beside the arguments' bytes (the
state the step is given), the output's, and the arguments the step writes
in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# bytes that cross a link per participating device, ring algorithm, as a
# multiple of the payload (n = replica-group size): ``hlo_costs.py``'s
WIRE_FACTOR = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "ragged-all-to-all": lambda n: (n - 1) / n,
    "collective-broadcast": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}

# allocations that read and write nothing
_FREE_OPS = frozenset({"aten::empty", "aten::empty_strided", "aten::empty_like",
                       "aten::new_empty", "aten::new_empty_strided", "aten::lift_fresh"})

# a kernel record: (kernel name, flops, bytes)
KernelRecord = Tuple[str, float, float]


@dataclasses.dataclass
class OpCostSummary:
    """The counterpart of ``HloCostSummary``, plus the kernels' records (by
    name: launches, flops, bytes), the wire bytes by mesh axis, and the
    memory analysis of the counted call."""

    flops: int = 0
    bytes_accessed: int = 0
    n_whiles: int = 0
    collective_operand_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    per_kind_operand: Dict[str, float] = dataclasses.field(default_factory=dict)
    per_kind_wire: Dict[str, float] = dataclasses.field(default_factory=dict)
    per_axis_wire: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    memory: Dict[str, int] = dataclasses.field(default_factory=dict)
    # label -> [flops, bytes], summed over the operations of that label
    rows: Dict[str, List[int]] = dataclasses.field(default_factory=dict, repr=False)


_ACTIVE: List["OpCounter"] = []


def active() -> Optional["OpCounter"]:
    """The innermost running counter, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _tensors(obj) -> Iterable[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def tensor_bytes(obj) -> int:
    """The bytes of every tensor in ``obj`` (nested lists, tuples, dicts)."""
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _label(func, out) -> str:
    shapes = ", ".join("x".join(map(str, t.shape)) for t in _tensors(out))
    return f"{func._schema.name} [{shapes}]"


class OpCounter(TorchDispatchMode):
    """Counts the aten operations, kernel records and collectives of what
    runs inside it (``with OpCounter() as c: ...``; then ``c.summary``).
    ``arguments`` (tensors, any nesting) are the state the counted call is
    given: their bytes are ``argument_size_in_bytes``, and those the call
    writes in place are ``alias_size_in_bytes``."""

    def __init__(self, arguments=None):
        super().__init__()
        self.summary = OpCostSummary()
        self._hidden = 0
        self._args = {}
        for t in _tensors(arguments):
            self._args[_storage_key(t)] = t.untyped_storage().nbytes()
        self._written = set()
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def hidden(self):
        """Operations inside are not counted (a kernel's wrapper, a
        collective's stand-in); their allocations are still followed."""
        self._hidden += 1
        try:
            yield
        finally:
            self._hidden -= 1

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _follow(self, out) -> None:
        for t in _tensors(out):
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._live or key in self._args:
                continue
            size = storage.nbytes()
            self._live[key] = size
            self.live_bytes += size
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(storage, self._free, key)

    def _note_writes(self, func, args, kwargs) -> None:
        schema = func._schema
        if not schema.is_mutable or not self._args:
            return
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            value = args[i] if i < len(args) else kwargs.get(a.name)
            for t in _tensors(value):
                key = _storage_key(t)
                if key in self._args:
                    self._written.add(key)

    def add(self, label: str, flops: int, nbytes: int) -> None:
        s = self.summary
        s.flops += int(flops)
        s.bytes_accessed += int(nbytes)
        if flops or nbytes:
            row = s.rows.setdefault(label, [0, 0])
            row[0] += int(flops)
            row[1] += int(nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._follow(out)
        self._note_writes(func, args, kwargs)
        if self._hidden or func.is_view or func._schema.name in _FREE_OPS:
            return out
        flops = 0
        formula = _FLOP_FORMULAS().get(func._overloadpacket)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
        self.add(_label(func, out), flops,
                 tensor_bytes(args) + tensor_bytes(kwargs) + tensor_bytes(out))
        return out

    # ------------------------------------------------------------------
    def kernel(self, records: Sequence[KernelRecord]) -> None:
        """Record kernel launches (each record one launch)."""
        for name, flops, nbytes in records:
            k = self.summary.kernels.setdefault(name, {"launches": 0, "flops": 0, "bytes": 0})
            k["launches"] += 1
            k["flops"] += int(round(flops))
            k["bytes"] += int(round(nbytes))
            self.add(f"kernel {name}", int(round(flops)), int(round(nbytes)))

    def collective(self, kind: str, n: int, axis: str, operand: int, output: int) -> None:
        """Record one collective of ``kind`` over a group of ``n`` ranks on
        mesh axis ``axis``: operand bytes, its wire bytes, and its operand
        and output bytes as memory traffic (as the reference counts a
        collective instruction's)."""
        s = self.summary
        payload = output if kind == "all-gather" else operand
        wire = payload * WIRE_FACTOR[kind](n) if n > 1 else 0.0
        s.collective_operand_bytes += operand
        s.collective_wire_bytes += wire
        s.per_kind_operand[kind] = s.per_kind_operand.get(kind, 0.0) + operand
        s.per_kind_wire[kind] = s.per_kind_wire.get(kind, 0.0) + wire
        s.per_axis_wire[axis] = s.per_axis_wire.get(axis, 0.0) + wire
        self.add(f"{kind} over {axis} ({n})", 0, operand + output)

    def memory_analysis(self, output=None) -> Dict[str, int]:
        """The reference's ``memory_analysis`` fields: the arguments' and the
        output's bytes, the arguments written in place, the peak of the
        bytes the call allocated and still held (``temp_size_in_bytes``:
        the peak of live storages minus the arguments), and -1 for the
        generated code, which has no counterpart."""
        return {"temp_size_in_bytes": int(self.peak_bytes),
                "argument_size_in_bytes": int(sum(self._args.values())),
                "output_size_in_bytes": int(tensor_bytes(output)),
                "alias_size_in_bytes": int(sum(self._args[k] for k in self._written)),
                "generated_code_size_in_bytes": -1}


@functools.lru_cache(maxsize=1)
def _FLOP_FORMULAS():
    from torch.utils.flop_counter import flop_registry

    return dict(flop_registry)


def counted(cost: Callable[..., Optional[Sequence[KernelRecord]]]):
    """Decorate a kernel entry: under a running counter, ``cost(*args,
    **kwargs)`` gives the launches the call makes (name, flops, bytes), which
    are recorded, and the entry's own operations are not counted (None: the
    call names a plain version, whose operations are counted as they run).
    Without a counter the entry runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            counter = active()
            if counter is None or counter._hidden:
                return fn(*args, **kwargs)
            records = cost(*args, **kwargs)
            if records is None:
                return fn(*args, **kwargs)
            counter.kernel(records)
            with counter.hidden():
                return fn(*args, **kwargs)

        return entry

    return wrap


@contextlib.contextmanager
def collective(kind: str, n: int, axis: str, operand: torch.Tensor,
               output: Optional[torch.Tensor] = None):
    """Around one collective's call: record it, and count none of the
    operations inside (the transport, or a stand-in group's placeholder)."""
    counter = active()
    if counter is None:
        yield
        return
    counter.collective(kind, n, axis, tensor_bytes(operand),
                       tensor_bytes(operand if output is None else output))
    with counter.hidden():
        yield


def count(fn: Callable, *args, arguments=None, **kwargs):
    """(``fn(*args, **kwargs)``, its ``OpCostSummary``), the summary's
    ``memory`` from ``arguments`` (default: ``args``)."""
    counter = OpCounter(args if arguments is None else arguments)
    with counter:
        out = fn(*args, **kwargs)
    counter.summary.memory = counter.memory_analysis(out)
    return out, counter.summary


def analyze(fn: Callable, *args, **kwargs) -> OpCostSummary:
    """Whole-call costs (the counterpart of ``analyze_hlo``)."""
    return count(fn, *args, **kwargs)[1]


def top_contributors(summary: OpCostSummary, metric: str = "flops",
                     k: int = 10) -> List[Tuple[float, str, str]]:
    """Top-k operation labels by ``metric`` ("flops" | "bytes"), summed
    over the operations of each label.  Returns (value, label, "step")
    rows, as the reference's (value, label, computation)."""
    if metric not in ("flops", "bytes"):
        raise ValueError(f"metric must be 'flops' or 'bytes', got {metric!r}")
    idx = 0 if metric == "flops" else 1
    picked = [(float(v[idx]), label, "step") for label, v in summary.rows.items() if v[idx] > 0]
    picked.sort(key=lambda r: r[0], reverse=True)
    return picked[:k]
