"""mixtral-8x7b [moe]: 32L, d=4096, 32H (kv=8), 8 experts top-2, SWA 4096.

Per-expert d_ff=14336; sliding-window attention.  [arXiv:2401.04088]

Copy of ``repro/configs/mixtral_8x7b.py`` without ``max_seq``, a field the
port's ``ModelConfig`` does not have.  The port runs its smoke config;
the full width (46.7 B parameters, 93.4 GB in bf16) does not fit one
80 GB card and waits for sharding over several (``ROADMAP.md``, A.12).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32_000, head_dim=128,
    pattern=("swa",), window_size=4096,
    num_experts=8, top_k=2, moe_d_ff=14336,
    rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    name="mixtral-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=256,
    moe_d_ff=96, window_size=8,
)
