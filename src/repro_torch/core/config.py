"""Server configuration: one frozen value object for every construction
path (the port's copy of ``repro.core.config``).

:class:`ServerConfig` carries every origin-server knob of
:class:`~repro_torch.core.server.BrTPFServer`. The port keeps the JAX
package's fields and defaults for the backends it serves, so that one
config value means the same server in both packages, and adds
``device``: the torch device the accelerated backends launch on. The
sharded backend's ``mesh`` becomes ``shards``, a number of logical
shards on that one device, and ``shard_axis`` is dropped (there is no
mesh axis to name).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

# Number of metadata + hypermedia-control triples per fragment page. A
# real TPF page carries void:triples counts, next/prev page links and the
# interface's hypermedia controls; the reference server emits ~8-30 such
# triples per page. The *value* only scales the constant page overhead --
# the paper's findings are about how the number of pages differs between
# TPF and brTPF -- so it is configurable.
DEFAULT_META_TRIPLES_PER_PAGE = 8
DEFAULT_PAGE_SIZE = 100
DEFAULT_MAX_MPR = 30

SELECTOR_BACKENDS = ("numpy", "kernel", "sharded")


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Origin-server configuration (paper section 4.1 + the accelerated
    backend).

    * ``page_size`` / ``max_mpr`` / ``meta_triples_per_page`` -- the
      paper's interface parameters (section 5.1).
    * ``selector_backend`` -- ``"numpy"`` (paper-faithful oracle),
      ``"kernel"`` (the hand-written CUDA bind-join kernels) or
      ``"sharded"`` (the store partitioned into logical shards on the
      device, windowed launches over all shards at once).
    * ``device`` -- torch device of the accelerated backends. ``None``
      means ``"cuda"``; constructing a kernel- or sharded-backend server
      then raises when no CUDA device is present. Pass ``"cpu"`` to run
      the kernels' plain PyTorch versions.
    * ``shards`` / ``shard_window`` -- sharded-backend geometry: the
      number of logical shards on ``device`` (the JAX package's
      ``mesh``) and the rows each shard
      streams per launch (``None`` means
      ``federation.DEFAULT_SHARD_WINDOW``). The JAX package's
      ``shard_axis`` has no counterpart: there is no mesh axis.
    * ``fast_path_rows`` -- small-work threshold below which the
      accelerated backends route to the numpy block evaluation (docs/pruning.md);
      0 disables the fast path.
    * ``fuse_patterns`` -- cross-pattern kernel fusion (docs/fusion.md):
      when a batch carries requests for >= 2 distinct triple patterns,
      the accelerated backends serve the whole heterogeneous batch with
      fused launches (one candidate stream, per-segment slot tables) instead
      of one grouped launch sequence per pattern. Fragments are
      byte-identical either way.
    * ``placement_policy`` -- sharded-backend data placement
      (docs/federation.md, "Placement"): ``"static"`` keeps the equal
      contiguous split; ``"heat"`` attaches a bounded
      :class:`~repro_torch.core.placement.HeatLog` (capacity
      ``heat_capacity``) to the selector so
      ``BrTPFServer.repartition()`` can cut workload-aware shard
      boundaries from observed traffic.
    * ``queue_depth`` -- admission control for the async batching front
      end (docs/serving.md): maximum pending (unflushed) requests;
      overflow raises
      :class:`~repro_torch.core.batching.QueueSaturated`. ``None`` keeps
      the unbounded queue.
    """

    page_size: int = DEFAULT_PAGE_SIZE
    max_mpr: int = DEFAULT_MAX_MPR
    meta_triples_per_page: int = DEFAULT_META_TRIPLES_PER_PAGE
    selector_backend: str = "numpy"
    device: Optional[str] = None
    shards: int = 1
    shard_window: Optional[int] = None
    fast_path_rows: int = 0
    fuse_patterns: bool = True
    placement_policy: str = "static"
    heat_capacity: int = 4096
    queue_depth: Optional[int] = None

    def __post_init__(self) -> None:
        if self.selector_backend not in SELECTOR_BACKENDS:
            raise ValueError(
                f"unknown selector_backend {self.selector_backend!r}")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.max_mpr < 1:
            raise ValueError("max_mpr must be >= 1")
        if self.shards < 1:
            raise ValueError("shards must be >= 1")
        if self.placement_policy not in ("static", "heat"):
            raise ValueError(
                f"unknown placement_policy {self.placement_policy!r}")
        if self.heat_capacity < 1:
            raise ValueError("heat_capacity must be >= 1")
        if self.queue_depth is not None and self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1 (or None)")

    def replace(self, **changes: Any) -> "ServerConfig":
        return dataclasses.replace(self, **changes)

    def to_wire(self) -> dict:
        """JSON-safe view. ``device`` is host-local, like the JAX
        package's ``mesh``, and goes on the wire as ``None``: a remote
        replica picks its own card. ``shards`` travels."""
        return {f.name: None if f.name == "device" else getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_wire(cls, obj: dict) -> "ServerConfig":
        """Inverse of :meth:`to_wire`; unknown keys are dropped, so a
        JAX package config body (``mesh``, ``shard_axis``) builds a port
        config with the shared fields equal."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in obj.items() if k in fields})
