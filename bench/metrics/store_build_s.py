"""Selectors and store: seconds of the port's store build in the run's
set-up, the host ``TripleStore`` and the device ``FederatedStore`` (where
the backend builds one) summed, from the build record
``repro_torch.core.metrics.STORE_BUILD``. The log states the split by
phase and the key layout's field widths. None where the port keeps no
such record."""
import sys


def read(run):
    try:
        from repro_torch.core.metrics import STORE_BUILD
    except ImportError:
        return None
    if not STORE_BUILD.host:
        return None
    parts = {"host": STORE_BUILD.host, "device": STORE_BUILD.device}
    split = "; ".join(
        f"{part} {sum(phases.values()):.3f} s ("
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()) + ")"
        for part, phases in parts.items() if phases)
    widths = ", ".join(f"{name} {'+'.join(map(str, w))}"
                       for name, w in STORE_BUILD.widths.items())
    print(f"bench: store build: {split}; key fields (bits): {widths}",
          file=sys.stderr, flush=True)
    return sum(sum(phases.values()) for phases in parts.values())
