"""granite-8b [dense]: 36L, d=4096, 32H (kv=8), d_ff=14336, V=49152.

Llama-architecture code model.  [arXiv:2405.04324]

Copy of ``repro/configs/granite_8b.py`` without ``max_seq``, a field the
port's ``ModelConfig`` does not have (the engine's ``max_context`` bounds
a request).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=49_152, head_dim=128,
)

SMOKE = CONFIG.replace(
    name="granite-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
)
