"""Server configuration: one frozen value object for every construction
path (the port's copy of ``repro.core.config``).

:class:`ServerConfig` carries every origin-server knob of
:class:`~repro_torch.core.server.BrTPFServer`. The port keeps the JAX
package's fields and defaults for the backends it serves, so that one
config value means the same server in both packages, and adds
``device``: the torch device the kernel backend launches on.
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

SELECTOR_BACKENDS = ("numpy", "kernel")

# Backends of the JAX package that this package does not serve yet.
_NOT_PORTED = ("sharded",)


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Origin-server configuration (paper section 4.1 + the accelerated
    backend).

    * ``page_size`` / ``max_mpr`` / ``meta_triples_per_page`` -- the
      paper's interface parameters (section 5.1).
    * ``selector_backend`` -- ``"numpy"`` (paper-faithful oracle) or
      ``"kernel"`` (the hand-written CUDA bind-join kernels). The JAX
      package's ``"sharded"`` backend is not ported yet and raises.
    * ``device`` -- torch device of the kernel backend. ``None`` means
      ``"cuda"``; constructing a kernel-backend server then raises when
      no CUDA device is present. Pass ``"cpu"`` to run the kernels'
      plain PyTorch versions.
    * ``fast_path_rows`` -- small-work threshold below which the kernel
      backend routes to the numpy block evaluation (docs/pruning.md);
      0 disables the fast path.
    * ``fuse_patterns`` -- cross-pattern kernel fusion (docs/fusion.md):
      when a batch carries requests for >= 2 distinct triple patterns,
      the kernel backend serves the whole heterogeneous batch with fused
      launches (one candidate stream, per-segment slot tables) instead
      of one grouped launch sequence per pattern. Fragments are
      byte-identical either way.
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
    fast_path_rows: int = 0
    fuse_patterns: bool = True
    queue_depth: Optional[int] = None

    def __post_init__(self) -> None:
        if self.selector_backend in _NOT_PORTED:
            raise NotImplementedError(
                f"selector_backend {self.selector_backend!r} is not yet "
                "ported to repro_torch")
        if self.selector_backend not in SELECTOR_BACKENDS:
            raise ValueError(
                f"unknown selector_backend {self.selector_backend!r}")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.max_mpr < 1:
            raise ValueError("max_mpr must be >= 1")
        if self.queue_depth is not None and self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1 (or None)")

    def replace(self, **changes: Any) -> "ServerConfig":
        return dataclasses.replace(self, **changes)
