"""The float32 error of the chunked WKV against the stepwise state, in the
JAX package and in the port, on the CPU.

Two levels, each at rwkv6-7b's head size (64) and chunk (16), from the
same numpy inputs on both sides:

* the WKV alone: ``wkv_chunked`` against the sequential ``wkv_reference``
  (B = 1, H = 2; r, k, v, u normal, log-decays ``-|normal| - 0.01`` from
  ``default_rng(0)``), the largest error over the largest output;
* the model: an rwkv6-7b config cut in width and depth (``--d-model``,
  ``--layers``, the reference's parameters from ``init(PRNGKey(0))``
  copied into the port), prefill of a prompt and ``--decode`` stepwise
  decode steps against the chunked forward over the whole sequence, the
  largest logit error over the largest logit: what ``chip_smoke.py``'s
  phase 11 holds to 1e-4 at full width.

    PYTHONPATH=src python scripts/rwkv_margin.py [--prompts 64 512 4096]
"""
import argparse
import dataclasses
import functools
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import all_archs as ref_archs  # noqa: E402
from repro.models import rwkv as RR  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import all_archs  # noqa: E402
from repro_torch.models import rwkv as TR  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

HEAD, CHUNK = 64, 16


def wkv_inputs(s, heads=2):
    rng = np.random.default_rng(0)
    r, k, v, lw = (rng.normal(size=(1, s, heads, HEAD)).astype(np.float32)
                   for _ in range(4))
    u = rng.normal(size=(heads, HEAD)).astype(np.float32)
    return r, k, v, -np.abs(lw) - 0.01, u


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def wkv_errors(s):
    args = wkv_inputs(s)
    j = [jnp.asarray(a) for a in args]
    t = [torch.from_numpy(a) for a in args]
    ref = rel(RR.wkv_chunked(*j, CHUNK)[0], RR.wkv_reference(*j)[0])
    port = rel(TR.wkv_chunked(*t, CHUNK)[0], TR.wkv_reference(*t)[0])
    return ref, port


def model_pair(d_model, layers):
    fields = dict(num_layers=layers, d_model=d_model, d_ff=4 * d_model,
                  vocab_size=1024, rwkv_head_dim=HEAD, chunk_size=CHUNK)
    ref_cfg = dataclasses.replace(ref_archs()["rwkv6-7b"], **fields)
    cfg = dataclasses.replace(all_archs()["rwkv6-7b"], **fields)
    ref = ref_build_model(ref_cfg)
    params = jax.jit(lambda key: ref.init(key)[0])(jax.random.PRNGKey(0))
    port = params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    return ref, params, port


def model_errors(ref, params, port, prompt, decode):
    """(reference, port): prefill + decode logits against the forward's
    logits at the same positions."""
    toks = np.random.default_rng(1).integers(
        1, port.cfg.vocab_size, (1, prompt + decode)).astype(np.int32)
    total = toks.shape[1]
    full = ref.forward(params, jnp.asarray(toks))[0][:, prompt - 1:]
    last, cache = jax.jit(functools.partial(ref.prefill, max_seq=total))(
        params, jnp.asarray(toks[:, :prompt]))
    step = jax.jit(ref.decode_step)
    path = [last[:, 0]]
    for pos in range(prompt, total):
        lg, cache = step(params, cache, jnp.asarray(toks[:, pos:pos + 1]),
                         jnp.int32(pos))
        path.append(lg[:, 0])
    ref_err = rel(jnp.stack(path, axis=1), full)

    t = torch.from_numpy(toks.astype(np.int64))
    with torch.no_grad():
        full = port(t)[0][:, prompt - 1:]
        last, cache = port.prefill(t[:, :prompt], max_seq=total)
        path = [last[:, 0]]
        for pos in range(prompt, total):
            lg, cache = port.decode_step(cache, t[:, pos:pos + 1], pos)
            path.append(lg[:, 0])
    port_err = rel(torch.stack(path, dim=1), full)
    return ref_err, port_err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--prompts", type=int, nargs="+",
                    default=[64, 512, 4096])
    ap.add_argument("--wkv-lengths", type=int, nargs="+",
                    default=[64, 512, 2048, 4096])
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--decode", type=int, default=8)
    args = ap.parse_args(argv)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    print(f"WKV alone, head {HEAD}, chunk {CHUNK}, B 1, H 2: "
          "max |chunked - sequential| / max |sequential|")
    for s in args.wkv_lengths:
        ref, port = wkv_errors(s)
        print(f"  S {s:5d}: JAX package {ref:.3e}, port {port:.3e}",
              flush=True)
    ref, params, port = model_pair(args.d_model, args.layers)
    print(f"model: rwkv6-7b at d_model {args.d_model}, {args.layers} "
          f"layers, head {HEAD}, chunk {CHUNK}, vocab 1024: prefill + "
          f"{args.decode} decode steps against the chunked forward, "
          "max |logit error| / max |logit|")
    for p in args.prompts:
        r, t = model_errors(ref, params, port, p, args.decode)
        print(f"  prompt {p:5d}: JAX package {r:.3e}, port {t:.3e}, "
              f"port / JAX {t / r:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
