"""Host microseconds a call of the decode-attention wrapper takes (bf16,
olmo-1b's decode shape), for the repro_torch package under SRC, and what
one ``torch.cuda.device`` guard costs, on one NVIDIA GPU.

    python3 tools/wrapper_host_cost.py SRC

SRC is the directory that holds ``repro_torch`` (this checkout's ``src``,
or another commit's unpacked with ``git archive``); run it on two trees
in turns (parent, change, change, parent) in one command to compare
them.  Prints one JSON line: five means of 2,000 calls each, and three
means of 20,000 guards."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    src = Path(sys.argv[1]).resolve()
    if not torch.cuda.is_available():
        print("wrapper_host_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels.decode_attention.ops import decode_attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    q = torch.randn((4, 1, 16, 128), generator=g, device=dev).to(bf)
    k = torch.randn((4, 2048, 16, 128), generator=g, device=dev).to(bf)
    v = k.clone()
    pos = torch.tensor([1900, 1024, 300, 37], dtype=torch.int32, device=dev)
    res = []
    with torch.no_grad():
        for _ in range(50):
            decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        for _ in range(5):
            t = time.perf_counter()
            for _ in range(2000):
                decode_attention(q, k, v, pos)
            res.append((time.perf_counter() - t) / 2000 * 1e6)
            torch.cuda.synchronize()
    guard = []
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(20000):
            with torch.cuda.device(dev):
                pass
        guard.append((time.perf_counter() - t) / 20000 * 1e6)
    print(json.dumps({"src": str(src), "decode_host_us_per_call": res,
                      "device_guard_us": guard}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
