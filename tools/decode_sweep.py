"""Where the bf16 decode-attention kernel's time goes, on one NVIDIA GPU.

    python3 tools/decode_sweep.py

Two tables, each row one JSON line with the kernel's device time
(``chip_smoke.device_times_ms``: the kernels one call launches, median of
20 calls, L2 flushed before each) and its error against the plain version:

  * ``sweep``: the keys per block (``ops.chunk_keys``, here overridden)
    from 64 to 512 at ``chip_smoke.py`` phase 2's decode shapes, beside
    the wrapper's own choice;
  * ``split``: recurrentgemma-9b's width (16 query heads over one KV head
    of 256, 4 rows) with every row holding exactly ``window`` valid keys,
    served by one block of 1, 2 or 3 tiles (what a tile adds) or by 2, 4
    or 11 blocks of 192 keys (what a partial of the fused merge adds).

Exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# (S, KH, hd, positions, window): phase 2's decode rows
SHAPES = (("olmo-1b", 2048, 16, 128, (1900, 1024, 300, 37), 0),
          ("olmo-1b short", 2048, 16, 128, (107, 87, 67, 47), 0),
          ("recurrentgemma-9b", 4096, 1, 256, (4000, 2500, 2100, 37), 2048))
CHUNKS = (64, 128, 192, 256, 512)
# (window, chunk): one block of 1-3 tiles, then 2, 4 and 11 blocks of 192
SPLITS = ((64, 64), (128, 128), (192, 192), (384, 192), (768, 192),
          (2048, 192))


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    dev = torch.device("cuda")
    print(C.card_line(), flush=True)
    flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)
    chosen = ops.chunk_keys

    def run(table, name, S, KH, hd, positions, window, chunk):
        g = torch.Generator(device=dev).manual_seed(C.SEED)
        B, H = len(positions), 16
        q = torch.randn((B, 1, H, hd), generator=g, device=dev).bfloat16()
        kc, vc = (torch.randn((B, S, KH, hd), generator=g,
                              device=dev).bfloat16() for _ in range(2))
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        wrapper_chunk = chosen(ops._grid_blocks(q.device, hd), B * KH,
                               min(S, window) if window else S, H // KH)
        ops.chunk_keys = lambda *_: chunk
        try:
            def kern():
                return ops.decode_attention(q, kc, vc, pos, window=window)
            err = C.max_err(kern(), decode_attention_ref(q, kc, vc, pos,
                                                         window=window))
            ms, _, _ = C.device_times_ms(kern, flush)
        finally:
            ops.chunk_keys = chosen
        print(json.dumps(dict(
            table=table, shape=name, hd=hd, kv_heads=KH, pos=list(positions),
            window=window, chunk=chunk, wrapper_chunk=wrapper_chunk,
            max_abs_err=err, device_ms=statistics.median(ms),
            device_ms_min=min(ms))), flush=True)

    for name, S, KH, hd, positions, window in SHAPES:
        for chunk in CHUNKS:
            run("sweep", name, S, KH, hd, positions, window, chunk)
    for window, chunk in SPLITS:
        run("split", "recurrentgemma-9b", 4096, 1, 256,
            (4000, 2500, 2100, 3000), window, chunk)
    return 0


if __name__ == "__main__":
    sys.exit(main())
