"""brTPF core, ported to PyTorch: the paper's contribution as a
composable library.

Layers: dictionary-encoded RDF (``rdf``), HDT-style store (``store``),
selector functions per Definitions 1-2 (``selectors``), the combined
TPF/brTPF server (``server``) with its kernel-backed selector
(``kernel_selectors``), the two client algorithms (``client``), the
async batching front end (``batching``), LRU cache simulation
(``cache``), the unified page-granular fragment store under every cache
layer (``fragments``), request accounting (``metrics``), the brtpf/v1
wire schema (``wire``), the trace-replay simulator (``sim``), and the
sharded backend (``federation``, with workload-aware ``placement``).
"""
from .batching import (AsyncBrTPFServer, BatchStats, DeadlineExceeded,
                       QueueSaturated, drive_streams, serve_concurrent)
from .bgp import BGP, bgp_from_arrays, evaluate_bgp_reference, parse_bgp
from .cache import LRUCache, request_key
from .client import (AsyncBrTPFClient, BrTPFClient, ExecutionResult,
                     TPFClient, plan_join_order)
from .config import ServerConfig
from .fragments import (ClientFragmentCache, FragmentStore, fragment_key)
from .metrics import Counters, latency_summary, metrics_snapshot
from .rdf import (TermDictionary, TriplePattern, UNBOUND, compatible,
                  decode_var, dedup_mappings, encode_var, is_var,
                  mapping_from_triple, merge, project_mappings)
from .selectors import (Fragment, brtpf_cardinality, brtpf_select,
                        brtpf_select_with_cnt, instantiate_patterns,
                        tpf_select)
from .server import (BrTPFServer, MaxMprExceeded, Request,
                     DEFAULT_MAX_MPR, DEFAULT_PAGE_SIZE)
from .store import (CandidateRange, SpanGroup, SubRanges, TripleStore,
                    merge_spans, store_from_ntriples)
from .wire import (WIRE_VERSION, WireError, fragment_from_wire,
                   fragment_to_wire, request_from_wire, request_to_wire)

# KernelSelector/LaunchRecord and FederatedStore/ShardedSelector are
# imported from repro_torch.core.kernel_selectors and
# repro_torch.core.federation directly, as in the JAX package; server.py
# imports them lazily for selector_backend="kernel" / "sharded".
__all__ = [
    "AsyncBrTPFClient", "AsyncBrTPFServer", "BatchStats",
    "BGP", "BrTPFClient", "BrTPFServer", "CandidateRange",
    "DeadlineExceeded", "QueueSaturated",
    "ClientFragmentCache", "Counters",
    "ExecutionResult",
    "Fragment", "FragmentStore", "LRUCache",
    "MaxMprExceeded", "Request", "TPFClient",
    "fragment_key", "metrics_snapshot", "latency_summary", "ServerConfig",
    "WIRE_VERSION", "WireError", "fragment_from_wire", "fragment_to_wire",
    "request_from_wire", "request_to_wire",
    "drive_streams", "plan_join_order", "serve_concurrent",
    "TermDictionary", "TriplePattern", "TripleStore", "UNBOUND",
    "bgp_from_arrays", "brtpf_cardinality", "brtpf_select",
    "brtpf_select_with_cnt", "compatible",
    "decode_var", "dedup_mappings", "encode_var", "evaluate_bgp_reference",
    "instantiate_patterns", "is_var", "mapping_from_triple", "merge",
    "merge_spans", "parse_bgp", "project_mappings", "request_key",
    "store_from_ntriples", "tpf_select",
    "SpanGroup", "SubRanges",
    "DEFAULT_MAX_MPR", "DEFAULT_PAGE_SIZE",
]
