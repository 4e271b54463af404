"""Serving launcher: continuous-batching engine + semantic-operator REPL
(port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
      --requests 8 --device cpu
  (without ``--device`` the same entry point runs on the GPU; with
  ``--full`` at the architecture's full width.)

Feeds a stream of synthetic requests through the engine and reports
throughput/latency; with --semantic it routes the requests through the
semantic-operator layer (LocalTorchProvider) instead of raw generate
calls.

Differences from the JAX package: ``--device`` (default: the GPU, as
every entry point of the port, ``repro_torch.device``); weights are the
port's draw from the engine's seed; ``run`` returns what it printed, as
a dict (the reference returns None).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.serving.engine import ServingEngine


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-context", type=int, default=256)
    ap.add_argument("--semantic", action="store_true",
                    help="drive via the semantic-operator layer")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))

    if args.semantic:
        from repro_torch.core import SemanticContext, llm_complete
        from repro_torch.core.provider import LocalTorchProvider
        ctx = SemanticContext(provider=LocalTorchProvider(
            args.arch, device=args.device))
        rows = [{"text": f"request {i} body " * 3}
                for i in range(args.requests)]
        t0 = time.monotonic()
        out = llm_complete(ctx, {"model": "local",
                                 "context_window": args.max_context,
                                 "max_output_tokens": 8},
                           {"prompt": "echo"}, rows)
        dt = time.monotonic() - t0
        batch_sizes = [r.batch_sizes for r in ctx.reports]
        print(f"semantic path: {len(out)} rows in {dt:.2f}s "
              f"({len(out)/dt:.1f} rows/s); "
              f"reports={batch_sizes}")
        return dict(rows=len(out), seconds=dt, batch_sizes=batch_sizes)

    eng = ServingEngine(cfg, n_slots=args.slots,
                        max_context=args.max_context, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    reqs = [eng.submit(list(rng.integers(0, cfg.vocab_size,
                                         args.prompt_len)),
                       max_new_tokens=args.max_new)
            for _ in range(args.requests)]
    eng.run_until_idle()
    dt = time.monotonic() - t0
    done = sum(r.finished for r in reqs)
    toks = sum(len(r.generated) for r in reqs)
    print(f"{done}/{len(reqs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, {eng.steps} engine steps)")
    return dict(done=done, requests=len(reqs), tokens=toks, seconds=dt,
                steps=eng.steps)


if __name__ == "__main__":
    run()
