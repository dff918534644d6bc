"""Roofline terms of a step on the card, and the counters behind them.

Counterpart of the reference package's ``launch/roofline.py``.  There
the FLOPs, bytes and collective bytes come from compiled HLO; here a
step runs (on fake tensors, in the dry run) under :class:`StepCounter`,
a dispatch mode that sees each rank's *local* operations: it lets
DTensor run first (returning ``NotImplemented`` for DTensor operands,
as ``torch.distributed.tensor.debug.CommDebugMode`` does), so the
matmuls it counts are the shards' and the collectives are the ones
DTensor's redistributions issue.  Every term is per device, as the
reference's are.

Hardware model: NVIDIA H100 SXM5 80 GB at 700 W, from NVIDIA's H100
data sheet: 989 TFLOP/s dense bf16 on the tensor cores (1,979 with
sparsity), 3.35 TB/s HBM3, and NVLink 4 at 900 GB/s a card, 450 GB/s
each way.  The link term divides a device's collective bytes by one
direction's 450 GB/s.  NVLink joins the 8 cards of one host; a 16-wide
mesh axis spans two such domains and crosses the slower network between
them, so the link term is a lower bound.

    compute    = FLOPs / PEAK_FLOPS
    memory     = bytes / HBM_BW
    collective = collective bytes / LINK_BW
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12       # dense bf16 FLOP/s (H100 SXM data sheet)
HBM_BW = 3.35e12          # bytes/s (H100 SXM data sheet)
LINK_BW = 450e9           # bytes/s, NVLink 4, one direction (data sheet)

#: ``_c10d_functional`` collectives by the reference's HLO names
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _tensors(tree) -> list:
    out = []
    for x in tree if isinstance(tree, (list, tuple)) else [tree]:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out += _tensors(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Per-device counts of the operations run under it.

    * ``flops``: the matmuls' and convolutions' FLOPs, by
      ``torch.utils.flop_counter``'s formulas, on local shapes;
    * ``bytes``: every non-view operation's input and output bytes (each
      operation on its own, unfused: an upper bound of what a fused
      program moves);
    * ``collectives``: the result bytes of every ``_c10d_functional``
      collective, by kind (:data:`COLLECTIVES`);
    * ``peak_bytes``: the most bytes held at once by tensors made under
      the counter (freed when the last reference goes).

    ``scaled(n)`` multiplies the FLOPs, bytes and collective bytes
    recorded inside it by ``n`` (the dry run's sampled loops,
    :mod:`repro_torch.models.loops`), not the memory: a sampled loop's
    one step holds what it holds.  The operations DTensor runs on whole
    shapes to propagate shardings are not counted: it runs them on fake
    tensors, which the shards never are (real tensors, or meta ones in
    the dry run).  Given ``device`` (the dry run's ``"meta"``), an
    operation whose results lie elsewhere -- DTensor planning a
    redistribution on the host -- is not counted either."""

    def __init__(self, device: str | None = None) -> None:
        super().__init__()
        self.device = device
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: dict[str, float] = {}
        self.live = 0.0
        self.peak_bytes = 0.0
        self.scale = 1

    def scaled(self, n: int):
        counter = self

        class _Scaled:
            def __enter__(self):
                self.prev = counter.scale
                counter.scale = counter.scale * n

            def __exit__(self, *exc):
                counter.scale = self.prev
                return False

        return _Scaled()

    def _free(self, nbytes: float) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs first, on shards
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor)
               for t in _tensors(list(args)) + _tensors(out)):
            return out      # DTensor's shape propagation, not a shard's op
        if self.device is not None and any(
                t.device.type != self.device for t in _tensors(out)):
            return out      # host-side bookkeeping beside the shards
        packet = func._overloadpacket
        ns = func.namespace
        if ns == "_c10d_functional" and packet.__name__ in COLLECTIVES:
            kind = COLLECTIVES[packet.__name__]
            self.collectives[kind] = self.collectives.get(kind, 0.0) + \
                self.scale * sum(_nbytes(t) for t in _tensors(out))
            return out
        if packet in self._formulas:
            self.flops += self.scale * self._formulas[packet](
                *args, **kwargs, out_val=out)
        if any(r.alias_info is not None for r in func._schema.returns):
            return out                  # a view (or in place): no bytes
        outs = _tensors(out)
        self.bytes += self.scale * (
            sum(_nbytes(t) for t in _tensors(list(args)
                                             + list(kwargs.values())))
            + sum(_nbytes(t) for t in outs))
        for t in outs:
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live)
        return out


def collective_bytes(fn, *args, **kwargs) -> dict[str, float]:
    """Result bytes of every collective ``fn(*args, **kwargs)`` issues,
    summed by kind, per device (the reference sums the result shapes of
    a compiled module's collectives)."""
    with StepCounter() as c:
        fn(*args, **kwargs)
    return dict(c.collectives)


@dataclass
class RooflineTerms:
    """All byte/FLOP inputs are PER-DEVICE quantities, as the
    reference's: :class:`StepCounter` counts each rank's local
    operations (a [512, 512] x [512, 512] matmul sharded over 4 ranks
    counts 2 * 512^3 / 4 FLOPs)."""

    flops: float
    bytes_hbm: float
    bytes_collective: float
    chips: int    # recorded for context; terms are already per-chip

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.bytes_collective / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_hbm": self.bytes_hbm,
            "bytes_collective": self.bytes_collective,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


def model_flops_train(n_params_active: float, tokens: float) -> float:
    """6·N·D for a train step (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_params_active * tokens


def model_flops_decode(n_params_active: float, tokens: float) -> float:
    return 2.0 * n_params_active * tokens
