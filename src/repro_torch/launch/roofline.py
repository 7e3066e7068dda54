"""Roofline analysis of one traced per-device step (the PyTorch
counterpart of ``repro.launch.roofline``).

Computes the three roofline terms per (arch x shape x mesh):

    compute    = FLOPs_per_device / peak_FLOP/s
                 (+ the brTPF kernels' INT32 operations / INT32 peak)
    memory     = bytes_per_device / HBM_bw
    collective = sum over mesh dims of that dim's collective bytes
                 / that dim's link bandwidth

The reference walks the compiled per-device XLA HLO. The port has no
HLO: it runs rank 0's step eagerly -- on fake tensors for a dry-run, or
for real on the card -- under :class:`CostCounter`, a
``TorchDispatchMode`` that sees every ATen op rank 0 executes, after
``DTensor`` has desugared the global program into local ops and
collectives:

* FLOPs per op from ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, attention), on the local shapes;
* bytes as the inputs plus outputs of every op that is not a view: in
  eager mode every op reads its inputs from HBM and writes its outputs
  back (nothing is fused, so this is what the port's program moves,
  not what a fusing compiler would);
* collective bytes (result bytes, as the reference counts them) and
  counts per kind (all-gather, all-reduce, reduce-scatter, all-to-all)
  from the ``_c10d_functional`` ops, each attributed to the mesh dim
  whose process group it ran on;
* the two brTPF kernels' INT32 operations by their bound formulas
  (``OPS_PER_CELL_UNGROUPED`` per row and pattern slot of the ungrouped
  bind-join, ``OPS_PER_ROW`` per row of the matcher), their bytes as
  for any op (inputs read once, outputs written once);
* the Mamba scan, which a trace on fake tensors runs as one op
  (``models.mamba``), by ``scan_cost``: its loop's FLOPs and bytes,
  step for step (its backward at twice that);
* the peak of the bytes held by storages the step allocated (what a
  compiler calls temporaries, outputs included), and inside the
  softmax backward the scratch CUDA's kernel allocates and frees before
  it returns, which no dispatched op shows (``_softmax_backward_scratch``),
  on whatever device the trace runs.

Hardware model: one NVIDIA H100 SXM at its published peaks (NVIDIA's
data sheet): 989.4 TFLOP/s dense BF16, 3.35 TB/s HBM3, 450 GB/s per
direction of NVLink (the ``model`` axis, one 8-GPU node), and 50 GB/s
per GPU of 400 Gb/s InfiniBand (the ``data`` and ``pod`` axes, across
nodes).
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import _sharding_prop
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# H100 SXM, NVIDIA data sheet: dense BF16 tensor-core FLOP/s, HBM3
# bytes/s, NVLink bytes/s each way per GPU, 400 Gb/s InfiniBand per GPU.
PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
IB_BW = 50e9
# Which link each mesh dim's collectives cross: the model axis stays in
# one NVLink node, the data and pod axes span nodes.
LINK_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}
# INT32 operations per second: 64 INT32 lanes per SM (half the 128
# FP32 lanes behind the 67 TFLOP/s FP32 figure) x 132 SMs x 1.98 GHz.
INT32_OPS = 132 * 64 * 1.98e9

# The brTPF kernels' work, as chip_smoke.py bounds them: 6 operations
# per (row, slot) cell of the ungrouped bind-join (3 component
# compares, 2 ANDs, 1 min into the first index) and 6 per row of the
# matcher (3 component and 3 repeated-variable compares).
OPS_PER_CELL_UNGROUPED = 6
OPS_PER_ROW = 6

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

# Ops that move no bytes: metadata, aliases and allocations.
_FREE = {"detach", "alias", "lift_fresh", "_unsafe_view", "empty",
         "empty_strided", "empty_like", "new_empty", "new_empty_strided",
         "_local_scalar_dense", "wait_tensor", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _kernel_ops(name: str, args) -> int:
    """INT32 operations of a brTPF kernel call (its bound formula)."""
    if name == "bindjoin":
        return OPS_PER_CELL_UNGROUPED * args[0].shape[0] * args[3].shape[0]
    if name == "tpf_match":
        return OPS_PER_ROW * args[0].shape[0]
    return 0


def _scan_cost(name: str, args) -> Optional[Tuple[float, float]]:
    """(FLOPs, bytes) of the Mamba scan op (``models.mamba.scan_cost``:
    what its loop's ops read and write); its backward is charged twice
    the forward, autograd's usual ratio (not counted op by op)."""
    if name not in ("selective_scan", "selective_scan_backward"):
        return None
    from ..models.mamba import scan_cost
    u, a = (args[0], args[4]) if name == "selective_scan" else \
        (args[2], args[6])
    flops, nbytes = scan_cost(tuple(u.shape), a.shape[1], u.element_size())
    k = 1.0 if name == "selective_scan" else 2.0
    return k * flops, k * nbytes


def _softmax_backward_scratch(args) -> int:
    """Bytes CUDA's ``_softmax_backward_data`` holds above its output
    while it runs: ``grad * output`` (``softmax_backward_cuda_out``),
    and a contiguous copy of that product and of ``output`` where they
    are not contiguous (``host_softmax_backward``); the product takes
    the gradient's layout."""
    grad, output = args[0], args[1]
    tmp = grad.numel() * torch.promote_types(grad.dtype,
                                             output.dtype).itemsize
    return (tmp * (1 if grad.is_contiguous() else 2)
            + (0 if output.is_contiguous() else _nbytes(output)))


class CostCounter(TorchDispatchMode):
    """Per-device cost of everything run under it (see the module
    docstring). ``groups`` maps a process group's name to its mesh dim
    (``group_names(mesh)``); a collective on another group counts under
    ``"other"``.

    DTensor ops are let through (``NotImplemented``) so that DTensor
    desugars them into local ops and collectives first, which this mode
    then sees; each collective is also charged to the DTensor op that
    issued it (``coll_by_op``): the ops whose operands DTensor had to
    gather or reduce, printed by the dry-run."""

    def __init__(self, groups: Optional[Dict[str, str]] = None) -> None:
        super().__init__()
        self.groups = dict(groups or {})
        self.flops = 0.0
        self.int_ops = 0.0
        self.bytes = 0.0
        self.coll_bytes: Dict[str, float] = defaultdict(float)
        self.coll_counts: Dict[str, int] = defaultdict(int)
        self.coll_by_op: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        self.by_op: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0, 0])
        self.live = 0
        self.peak = 0
        self._tracked: Dict[int, int] = {}
        self._outer = "(none)"
        self._meta = 0
        self._patched: Dict[str, object] = {}

    # -- memory ----------------------------------------------------------------

    def _free(self, key: int) -> None:
        self.live -= self._tracked.pop(key, 0)

    def _track(self, out: torch.Tensor, inputs) -> None:
        st = out.untyped_storage()
        key = id(st)
        if key in self._tracked or any(st is i.untyped_storage()
                                       for i in inputs):
            return
        n = st.nbytes()
        self._tracked[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def reset_peak(self) -> None:
        self.peak = self.live

    # -- dispatch --------------------------------------------------------------

    # DTensor propagates each op's sharding on global-shaped fake tensors
    # (its output metadata, a decomposition's strategy); under an active
    # FakeTensorMode (a dry-run) those ops reach this mode too. They are
    # no part of rank 0's program: while DTensor propagates, nothing is
    # counted.
    _PROPAGATORS = ("propagate_op_sharding_non_cached",
                    "_propagate_tensor_meta_non_cached")

    def __enter__(self):
        prop = _sharding_prop.ShardingPropagator
        self._patched = {n: getattr(prop, n) for n in self._PROPAGATORS
                         if hasattr(prop, n)}
        for name, orig in self._patched.items():
            setattr(prop, name, self._quiet(orig))
        return super().__enter__()

    def _quiet(self, orig):
        def propagate(prop_self, *args, **kwargs):
            self._meta += 1
            try:
                return orig(prop_self, *args, **kwargs)
            finally:
                self._meta -= 1

        return propagate

    def __exit__(self, *exc):
        for name, orig in self._patched.items():
            setattr(_sharding_prop.ShardingPropagator, name, orig)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator) or self._meta:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            self._outer = str(func.overloadpacket.__name__)
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        name = packet.__name__
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        row = self.by_op[f"{func.namespace}.{name}"]
        row[0] += 1
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            row[1] += f
        scan = None
        if func.namespace == "repro_torch":
            self.int_ops += _kernel_ops(name, args)
            scan = _scan_cost(name, args)
        if scan is not None:
            self.flops += scan[0]
            self.bytes += scan[1]
            row[1] += scan[0]
            row[2] += scan[1]
        elif not (func.is_view or name in _FREE
                  or func.namespace == "prim"):
            b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            self.bytes += b
            row[2] += b
        kind = _COLLECTIVES.get(name) if func.namespace == \
            "_c10d_functional" else None
        if kind is not None:
            group = next(a for a in reversed(args) if isinstance(a, str))
            dim = self.groups.get(group, "other")
            b = sum(_nbytes(t) for t in outs)
            self.coll_bytes[dim] += b
            self.coll_counts[kind] += 1
            self.coll_by_op[self._outer][kind] += b
        if not func.is_view:
            before = self.live
            for o in outs:
                self._track(o, ins)
            row[3] += self.live - before
        if name == "_softmax_backward_data":
            self.peak = max(self.peak,
                            self.live + _softmax_backward_scratch(args))
        return out

    # -- reports ---------------------------------------------------------------

    def explain(self, top: int = 12) -> str:
        """Perf-debug view: the top ops by bytes, with their calls, FLOPs
        and the bytes of new storages they allocated."""
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][2])
        out = [f"{'op':40s} {'calls':>8s} {'Tflop':>9s} {'GB':>10s} "
               f"{'alloc GB':>9s}"]
        for name, (calls, fl, by, al) in rows[:top]:
            out.append(f"{name[:40]:40s} {calls:8d} {fl / 1e12:9.3f} "
                       f"{by / 1e9:10.3f} {al / 1e9:9.3f}")
        return "\n".join(out)


def group_names(mesh) -> Dict[str, str]:
    """``{process group name: mesh dim name}`` of a ``DeviceMesh``."""
    return {mesh.get_group(d).group_name: d for d in mesh.mesh_dim_names}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_counts: Dict[str, int]
    model_flops: float           # 6*N*D (train) / 2*N*D (decode), global
    memory_per_device_gb: float  # arguments + the step's peak allocations
    # the port's additions: collective bytes per mesh dim (collective_s
    # charges each dim's own link), and the brTPF kernels' INT32 ops
    coll_bytes_by_dim: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    int_ops_per_chip: float = 0.0

    @property
    def compute_s(self) -> float:
        return (self.flops_per_chip / PEAK_FLOPS
                + self.int_ops_per_chip / INT32_OPS)

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return sum(b / LINK_BW.get(dim, IB_BW)
                   for dim, b in self.coll_bytes_by_dim.items())

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound time: how close the step is to the
        compute roofline for its *model* flops."""
        ideal = self.model_flops / self.chips / PEAK_FLOPS
        return ideal / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_counts": self.coll_counts,
            "model_flops": self.model_flops,
            "memory_per_device_gb": self.memory_per_device_gb,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "coll_bytes_by_dim": self.coll_bytes_by_dim,
            "int_ops_per_chip": self.int_ops_per_chip,
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic useful FLOPs per step: 6*N*D for training, 2*N*D per
    generated token for decode (N = active params)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def analyze(arch: str, shape_name: str, mesh_name: str, chips: int,
            counter: CostCounter, model_flops: float,
            memory_gb: float = 0.0) -> Roofline:
    """The roofline record of a step traced under ``counter``."""
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_chip=counter.flops, bytes_per_chip=counter.bytes,
        coll_bytes_per_chip=sum(counter.coll_bytes.values()),
        coll_counts=dict(counter.coll_counts),
        model_flops=model_flops, memory_per_device_gb=memory_gb,
        coll_bytes_by_dim=dict(counter.coll_bytes),
        int_ops_per_chip=counter.int_ops)
