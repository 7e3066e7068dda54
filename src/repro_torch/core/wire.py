"""Versioned wire schema for the brTPF serving edge (``brtpf/v1``).

The port's copy of ``repro.core.wire``, byte for byte on the wire: a body
written by either package is read by the other and gives the same bytes
back. ``Request`` and ``Fragment`` are numpy-bearing value objects; this
module defines the one JSON envelope both sides of the wire speak:

* every envelope carries ``{"v": "brtpf/v1", "kind": ...}``;
* a ``request`` envelope is the request URL's content -- the triple
  pattern as a 3-list of ints (constants >= 0, variables < 0 per
  ``core/rdf.py``), the Omega *sequence* as a list of int lists (order
  preserved -- Definition 2 insists Omega is a sequence, and the page
  contents depend on it), and the page number;
* a ``fragment`` envelope carries the page's data triples, the
  fragment-level ``cnt`` estimate, and the paging / metadata-control
  fields (``meta_triples`` preserved so dataRecv accounting is identical
  over the wire);
* a ``metrics`` envelope wraps
  :func:`repro_torch.core.metrics.metrics_snapshot`;
* an ``error`` envelope maps server-side failures onto HTTP statuses
  (``MaxMprExceeded`` -> 414, exactly like the paper's URL-length bound).

The HTTP transport (``repro_torch.serving.http``) and the in-process
loopback transport (``repro_torch.serving.transport.LoopbackTransport``) both
round-trip through THESE functions, so transport parity is asserted on
the same envelope -- not on two parallel encoders.

Decoding is strict: a missing/foreign version tag or a malformed body
raises :class:`WireError` (HTTP 400), never a silent best-effort parse.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np

from .rdf import TriplePattern

WIRE_VERSION = "brtpf/v1"

KIND_REQUEST = "request"
KIND_FRAGMENT = "fragment"
KIND_METRICS = "metrics"
KIND_ERROR = "error"


class WireError(ValueError):
    """Malformed or version-incompatible wire envelope (HTTP 400)."""


def envelope(kind: str, **fields) -> dict:
    return {"v": WIRE_VERSION, "kind": kind, **fields}


def check_envelope(obj, kind: str) -> dict:
    if not isinstance(obj, dict):
        raise WireError(f"envelope must be a JSON object, got "
                        f"{type(obj).__name__}")
    v = obj.get("v")
    if v != WIRE_VERSION:
        raise WireError(f"unsupported wire version {v!r} "
                        f"(this server speaks {WIRE_VERSION})")
    k = obj.get("kind")
    if k != kind:
        raise WireError(f"expected a {kind!r} envelope, got {k!r}")
    return obj


def _int_list(values, what: str) -> list:
    try:
        return [int(x) for x in values]
    except (TypeError, ValueError) as exc:
        raise WireError(f"{what} must be a list of ints: {exc}") from None


# ---------------------------------------------------------------------------
# Request
# ---------------------------------------------------------------------------


def request_to_wire(req) -> dict:
    """Encode a :class:`~repro_torch.core.server.Request` (brtpf/v1)."""
    omega = None
    omega_vars = None
    if req.omega is not None:
        om = np.asarray(req.omega)
        omega = [[int(x) for x in row] for row in om.tolist()]
        omega_vars = int(om.shape[1]) if om.ndim == 2 else 0
    out = envelope(
        KIND_REQUEST,
        pattern=[int(c) for c in req.pattern.as_tuple()],
        omega=omega,
        omega_vars=omega_vars,
        page=int(req.page),
    )
    # count probes (docs/fusion.md): emitted only when set, so v1 bodies
    # from pre-fusion clients stay byte-identical
    if getattr(req, "count_only", False):
        out["count_only"] = True
    # remaining deadline budget (docs/resilience.md): same
    # emit-only-when-set rule, so deadline-less clients keep producing
    # byte-identical request bodies
    if getattr(req, "timeout_ms", None) is not None:
        out["timeout_ms"] = float(req.timeout_ms)
    return out


def request_from_wire(obj):
    """Decode a ``request`` envelope; inverse of :func:`request_to_wire`."""
    from .server import Request  # no cycle: server never imports wire
    obj = check_envelope(obj, KIND_REQUEST)
    pattern = obj.get("pattern")
    if not isinstance(pattern, (list, tuple)) or len(pattern) != 3:
        raise WireError("'pattern' must be a 3-list [s, p, o]")
    tp = TriplePattern(*_int_list(pattern, "'pattern'"))
    omega = None
    if obj.get("omega") is not None:
        rows = obj["omega"]
        if not isinstance(rows, (list, tuple)):
            raise WireError("'omega' must be a list of mapping rows")
        nv = obj.get("omega_vars")
        if nv is None:
            nv = len(rows[0]) if rows else 0
        flat = [_int_list(row, "omega row") for row in rows]
        if any(len(r) != nv for r in flat):
            raise WireError(f"omega rows must all have {nv} columns")
        omega = np.asarray(flat, dtype=np.int32).reshape(len(flat), int(nv))
    page = obj.get("page", 0)
    if not isinstance(page, int) or page < 0:
        raise WireError("'page' must be a non-negative int")
    count_only = obj.get("count_only", False)
    if not isinstance(count_only, bool):
        raise WireError("'count_only' must be a bool")
    timeout_ms = obj.get("timeout_ms")
    if timeout_ms is not None:
        if (isinstance(timeout_ms, bool)
                or not isinstance(timeout_ms, (int, float))
                or not timeout_ms > 0):
            raise WireError("'timeout_ms' must be a positive number")
        timeout_ms = float(timeout_ms)
    return Request(pattern=tp, omega=omega, page=page,
                   count_only=count_only, timeout_ms=timeout_ms)


# ---------------------------------------------------------------------------
# Fragment
# ---------------------------------------------------------------------------


def fragment_to_wire(frag) -> dict:
    """Encode a :class:`~repro_torch.core.selectors.Fragment` page (brtpf/v1).

    ``meta_triples`` (the page's metadata/control triple count) and
    ``cnt`` ride along so the client-side dataRecv / cardinality
    accounting over the wire matches the in-process numbers exactly.
    """
    data = np.asarray(frag.data)
    return envelope(
        KIND_FRAGMENT,
        data=[[int(x) for x in row] for row in data.tolist()],
        cnt=int(frag.cnt),
        page=int(frag.page),
        page_size=int(frag.page_size),
        has_next=bool(frag.has_next),
        meta_triples=int(frag.meta_triples),
    )


def fragment_from_wire(obj):
    """Decode a ``fragment`` envelope; inverse of :func:`fragment_to_wire`."""
    from .selectors import Fragment  # no cycle: selectors never imports wire
    obj = check_envelope(obj, KIND_FRAGMENT)
    rows = obj.get("data")
    if not isinstance(rows, (list, tuple)):
        raise WireError("'data' must be a list of triples")
    flat = [_int_list(row, "data triple") for row in rows]
    if any(len(r) != 3 for r in flat):
        raise WireError("data triples must have 3 components")
    data = np.asarray(flat, dtype=np.int32).reshape(len(flat), 3)
    try:
        return Fragment(
            data=data,
            cnt=int(obj["cnt"]),
            page=int(obj["page"]),
            page_size=int(obj["page_size"]),
            has_next=bool(obj["has_next"]),
            meta_triples=int(obj["meta_triples"]),
        )
    except KeyError as exc:
        raise WireError(f"fragment envelope missing field {exc}") from None


# ---------------------------------------------------------------------------
# Errors / serialization helpers
# ---------------------------------------------------------------------------


# Machine-readable error codes (docs/serving.md has the full table of
# status <-> code <-> retryability). Strings, not ints: a code names the
# CONDITION (so clients can branch without parsing messages), while the
# status stays the HTTP mapping.
ERROR_CODES = (
    "BAD_REQUEST",         # 400 -- malformed brtpf/v1 envelope
    "NOT_FOUND",           # 404 -- unknown route
    "METHOD_NOT_ALLOWED",  # 405 -- wrong verb on a known route
    "MAX_MPR_EXCEEDED",    # 414 -- |Omega| > maxMpR (paper's URL bound)
    "QUEUE_SATURATED",     # 503 -- admission control; retryable
    "DEADLINE_EXCEEDED",   # 504 -- deadline budget exhausted; retryable
    "INTERNAL",            # 500 -- unclassified server failure
)


def error_to_wire(status: int, message: str, retryable: bool = False,
                  code: Optional[str] = None,
                  retry_after_ms: Optional[float] = None) -> dict:
    out = envelope(KIND_ERROR, status=int(status), error=str(message))
    if retryable:
        # advisory: the condition is transient (e.g. 503 admission
        # control -- the batching queue drains within one window) and
        # the client should retry after backoff. Omitted when False so
        # pre-existing error envelopes stay byte-identical.
        out["retryable"] = True
    if code is not None:
        if code not in ERROR_CODES:
            raise ValueError(f"unknown wire error code {code!r}")
        out["code"] = code
    if retry_after_ms is not None:
        # RETRY_AFTER hint (docs/resilience.md): a floor for the
        # client's backoff, e.g. one batching window on 503. Like
        # retryable/code it is emitted only when set.
        out["retry_after_ms"] = float(retry_after_ms)
    return out


def error_from_wire(obj) -> dict:
    """Decode an ``error`` envelope (strict; the round-trip inverse of
    :func:`error_to_wire`). Returns a normalized dict with ``status``,
    ``error``, ``retryable`` (defaulted False), ``code`` and
    ``retry_after_ms`` (defaulted None) -- what a transport needs to
    build a :class:`~repro_torch.serving.transport.TransportError`."""
    obj = check_envelope(obj, KIND_ERROR)
    status = obj.get("status")
    if isinstance(status, bool) or not isinstance(status, int):
        raise WireError("'status' must be an int")
    message = obj.get("error")
    if not isinstance(message, str):
        raise WireError("'error' must be a string")
    retryable = obj.get("retryable", False)
    if not isinstance(retryable, bool):
        raise WireError("'retryable' must be a bool")
    code = obj.get("code")
    if code is not None and code not in ERROR_CODES:
        raise WireError(f"unknown wire error code {code!r}")
    retry_after_ms = obj.get("retry_after_ms")
    if retry_after_ms is not None:
        if (isinstance(retry_after_ms, bool)
                or not isinstance(retry_after_ms, (int, float))
                or not retry_after_ms >= 0):
            raise WireError("'retry_after_ms' must be a non-negative "
                            "number")
        retry_after_ms = float(retry_after_ms)
    return {"status": status, "error": message, "retryable": retryable,
            "code": code, "retry_after_ms": retry_after_ms}


def dumps(obj: dict) -> bytes:
    """Canonical envelope serialization (compact separators -- the byte
    payload is what the network-load benchmarks weigh)."""
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")


def loads(raw: bytes) -> dict:
    try:
        obj = json.loads(raw.decode("utf-8") if isinstance(raw, bytes)
                         else raw)
    except (ValueError, UnicodeDecodeError) as exc:
        raise WireError(f"invalid JSON body: {exc}") from None
    if not isinstance(obj, dict):
        raise WireError("wire payload must be a JSON object")
    return obj
