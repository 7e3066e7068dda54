"""Serving: the brTPF HTTP edge of the port (no LM engine yet).

* ``repro_torch.serving.http`` -- ASGI app over the async brTPF front
  end (GET/POST /fragment, GET /metrics), ``TestClient``, ``run_app``.
* ``repro_torch.serving.transport`` -- client-side transports speaking
  the brtpf/v1 wire schema (in-process loopback and ASGI/HTTP).
* ``repro_torch.serving.router`` -- front-end router fanning requests
  across N server replicas, with per-replica circuit breakers and
  health-gated failover (docs/resilience.md).
* ``repro_torch.serving.resilience`` -- client-side retry/backoff,
  hedged requests and deadline budgets over any transport.
* ``repro_torch.serving.faults`` -- deterministic seeded fault injection
  (delay / error / drop / stall / crash) for chaos runs.

Each is the port of the module of the same name in ``repro.serving``
and speaks the same bytes on the wire.
"""
