"""gemma3-12b [dense]: 48L, d=3840, 16H (kv=8), d_ff=15360, V=262144.

5 local (window 1024, theta 10k) : 1 global (theta 1M) interleave; qk-norm;
128k context.  [hf:google/gemma-3-1b-pt scaled per assignment]

Copy of ``repro/configs/gemma3_12b.py`` without ``max_seq``, a field the
port's ``ModelConfig`` does not have (the engine's ``max_context`` bounds
a request).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    d_ff=15360, vocab_size=262_144, head_dim=256,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window_size=1024, rope_theta=1e6, rope_theta_local=10_000.0,
    qk_norm=True, embed_scale=True, tie_embeddings=True,
    act="gelu",
)

SMOKE = CONFIG.replace(
    name="gemma3-smoke", num_layers=6, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    window_size=8,
)
