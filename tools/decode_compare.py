"""``chip_smoke.py`` phase 2's four decode-attention rows, on the
``repro_torch`` package of any tree, on one NVIDIA GPU.

    python3 tools/decode_compare.py [SRC]

SRC is the directory that holds ``repro_torch`` (default: this checkout's
``src``), e.g. the ``src`` of another commit unpacked with ``git archive``.
The script builds that tree's kernels and times its decode attention with
this tree's yardstick (``chip_smoke.check_decode_rows``: 50 interleaved
pairs with masked SDPA, and the device time of each), so two versions of
the kernel compare on one card when one command runs the script on both
trees in turns (parent, change, change, parent).  Exits non-zero when no
CUDA device is present or a row disagrees with its plain version.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    src = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "src"
    if not torch.cuda.is_available():
        print("decode_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(src.resolve()), str(ROOT)]
    import chip_smoke as C
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    C.log(phase="card", card=C.card_line(), src=str(src))
    C.log(phase="build", library=_build.build().name)
    flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)  # 128 MB
    for row in sum(C.check_decode_rows(dev, flush), []):
        C.check(row["ok"], f"decode_attention disagrees with its plain "
                f"version ({row['shape']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
