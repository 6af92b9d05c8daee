"""Per-device cost accounting of one traced step from its aten ops: the
counterpart of ``repro/launch/hlo_analysis.py``, which reads the
post-SPMD HLO of a compiled step.

``OpAnalysis`` is a ``TorchDispatchMode``. Under DTensor it lets each op
desugar first (it returns ``NotImplemented`` for DTensor arguments, as
``MemTracker`` does) and records the local ops on this rank's shards,
with the collectives DTensor and ``parallel.shard_map`` issue. It
accumulates, in the fields of the reference's ``HloCosts``:

  * ``flops``                  matmul and convolution flops of the local
                               ops, by ``torch.utils.flop_counter``'s
                               formula registry (2 * M * N * K a product)
  * ``hbm_bytes``              operand plus result bytes of every op that
                               launches a kernel; views, allocations and
                               metadata cost 0. The port runs eagerly, so
                               unlike the reference's ``MAJOR_HBM_OPS`` no
                               elementwise op is taken as fused
  * ``collective_*``           counts, result bytes and ring-model wire
                               bytes by kind, with the reference's
                               formulas (``wire_bytes``); sites are named
                               by the calling frame in ``repro_torch``
  * ``attention_score_bytes``  result bytes of the plain attention's score
                               products (``models/layers.py``, MLA's
                               absorbed form, the hybrid's rolling window)
  * ``hbm_bytes_seq_loops``    bytes of the sLSTM's step loop
                               (``models/recurrent._slstm_scan``), forward
                               and backward

Left out against the reference: ``cpu_convert_bytes`` (a trace of the
card's step has no CPU legalisation of bf16 products) and loop
multipliers (eager execution unrolls every loop: each op is counted as
often as it runs).
"""
from __future__ import annotations

import dataclasses
import functools
import linecache
import sys
import weakref
from typing import Dict, List, Tuple

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode

#: source lines of the attention score products (their einsum outputs)
SCORE_MARKS = ('->bhgqk"', '->bhst"', '->bhgw"')

_NO_LAUNCH = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "lift_fresh", "detach", "alias",
              "_local_scalar_dense", "is_same_size", "sym_size",
              "sym_stride", "sym_numel", "sym_storage_offset",
              "wait_tensor", "set_"}

COLLECTIVES = {
    # torch.ops._c10d_functional (DTensor's redistributions)
    "all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-broadcast",
    # torch.ops.c10d (torch.distributed's calls: shard_map's bodies)
    "allreduce_": "all-reduce", "alltoall_base_": "all-to-all",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "broadcast_":
    "collective-broadcast",
}


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Per-device wire bytes of one collective under the reference's ring
    model (``hlo_analysis.analyze``): ``nbytes`` is the per-device result."""
    if kind == "all-reduce":
        return 2 * nbytes * (group - 1) / max(group, 1)
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return nbytes * (group - 1) / max(group, 1)
    return nbytes


@dataclasses.dataclass
class OpCosts:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_result_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    #: (kind, group size) -> count, as the reference's ops list
    collective_groups: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    dot_flops_detail: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    top_collective_sites: List[Tuple[float, str, str]] = dataclasses.field(
        default_factory=list)
    #: the largest collective result (bytes) issued from each site
    site_result_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    #: flops of products whose contracted dim is 1 (outer products): XLA
    #: rewrites such a dot into a multiply, so the reference counts none
    outer_flops: float = 0.0
    attention_score_bytes: float = 0.0
    hbm_bytes_seq_loops: float = 0.0
    #: ops that launch a kernel, and every op recorded
    launches: int = 0
    ops: int = 0
    #: the most bytes of local storage live at once: the tensors given to
    #: ``track`` and every storage an op made, each until it is freed
    peak_bytes: int = 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


def _group_size(args) -> int:
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    for a in args:
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except (RuntimeError, TypeError):
                continue
    raise ValueError("a collective without a process group")


def _site() -> Tuple[str, str]:
    """(``file:line function``, source line) of the innermost calling
    frame in ``repro_torch`` outside this module and ``parallel/``."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and "op_analysis" not in fn \
                and "parallel" not in fn:
            short = fn[fn.rindex("repro_torch"):]
            return (f"{short}:{f.f_lineno} {f.f_code.co_qualname}",
                    linecache.getline(fn, f.f_lineno))
        f = f.f_back
    return "?", ""


class OpAnalysis(TorchDispatchMode):
    """Record every aten op of the code run under it (see the module
    docstring); ``costs`` holds the totals."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.costs = OpCosts()
        self._flops = flop_registry
        self._seq_depth = 0
        self._patched = None
        self._live: Dict[int, int] = {}
        self._live_bytes = 0

    # -- live storage: one entry a storage, dropped when it is freed --

    def track(self, *tensors):
        """Count ``tensors``' storages as live (the step's arguments; a
        DTensor's local shard)."""
        for t in tensors:
            self._track(getattr(t, "_local_tensor", t))

    def _track(self, t):
        st = t.untyped_storage()
        key, nbytes = st._cdata, st.nbytes()
        was = self._live.get(key)
        if was is None:
            weakref.finalize(st, self._free, key)
        elif was == nbytes:
            return
        # a storage seen again at another size was resized in place
        self._live[key] = nbytes
        self._live_bytes += nbytes - (was or 0)
        self.costs.peak_bytes = max(self.costs.peak_bytes, self._live_bytes)

    def _free(self, key):
        self._live_bytes -= self._live.pop(key, 0)

    # -- the sLSTM loop: its forward ops while it runs, its backward ops
    # from its output's gradient to its input's. (Not by marking its
    # autograd nodes: a Python handle on each node of a 4,096-step chain
    # overflows the C++ stack when the graph is freed.) --

    def _scan_wrapper(self, scan):
        mode = self

        @functools.wraps(scan)
        def run(wx, *args):
            mode._seq_depth += 1
            try:
                out = scan(wx, *args)
            finally:
                mode._seq_depth -= 1
            hs = out[0]
            if hs.requires_grad and wx.requires_grad:
                hs.register_hook(mode._enter_backward)
                wx.register_hook(mode._leave_backward)
            return out
        return run

    def _enter_backward(self, grad):
        self._seq_depth += 1

    def _leave_backward(self, grad):
        self._seq_depth -= 1

    def __enter__(self):
        from repro_torch.models import recurrent as REC

        self._fake_on_entry = active_fake_mode()
        self._patched = REC._slstm_scan
        REC._slstm_scan = self._scan_wrapper(self._patched)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.models import recurrent as REC

        REC._slstm_scan = self._patched
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs ops on global shapes under
        # a fake mode of its own: only the local ops are this rank's
        if active_fake_mode() is self._fake_on_entry:
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out):
        c = self.costs
        c.ops += 1
        for t in _tensors(out):
            self._track(t)
        name = func._overloadpacket.__name__
        kind = COLLECTIVES.get(name)
        if kind is None and (name in _NO_LAUNCH or _is_view(func)
                             or name.startswith("sym_")):
            return
        c.launches += 1
        packet = func._overloadpacket
        if packet in self._flops:
            fl = float(self._flops[packet](*args, **kwargs, out_val=out))
            c.flops += fl
            c.dot_flops_detail[name] = c.dot_flops_detail.get(name, 0.0) + fl
            if name in ("bmm", "mm") and args[0].shape[-1] == 1:
                c.outer_flops += fl
            if name in ("bmm", "mm") and fl:
                site, line = _site()
                if any(m in line for m in SCORE_MARKS):
                    c.attention_score_bytes += _nbytes(out)
        if kind is not None:
            if func.namespace == "c10d":
                # in place on its tensor arguments: the result is the
                # output tensor (all-to-all's first, the rest's only one)
                nbytes = _nbytes(args[0])
            else:
                nbytes = _nbytes(out)
            group = _group_size(list(args) + list(kwargs.values()))
            wire = wire_bytes(kind, nbytes, group)
            c.collective_wire_bytes += wire
            c.collective_result_bytes[kind] = (
                c.collective_result_bytes.get(kind, 0.0) + nbytes)
            c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
            key = f"{kind} g{group}"
            c.collective_groups[key] = c.collective_groups.get(key, 0) + 1
            site, _ = _site()
            c.site_result_bytes[site] = max(
                c.site_result_bytes.get(site, 0.0), float(nbytes))
            c.top_collective_sites.append(
                (wire, kind, f"{site} :: {nbytes} B g{group}"))
            if len(c.top_collective_sites) > 4096:
                self._trim_sites()
        hb = float(_nbytes(args) + _nbytes(kwargs) + _nbytes(out))
        c.hbm_bytes += hb
        if self._seq_depth:
            c.hbm_bytes_seq_loops += hb

    def _trim_sites(self):
        self.costs.top_collective_sites = sorted(
            self.costs.top_collective_sites, reverse=True)[:20]

    def result(self) -> OpCosts:
        self._trim_sites()
        return self.costs


def analyze(fn, *args, **kwargs) -> Tuple[object, OpCosts]:
    """``fn(*args, **kwargs)`` under ``OpAnalysis``: (its result, costs)."""
    with OpAnalysis() as mode:
        out = fn(*args, **kwargs)
    return out, mode.result()
