"""deepseek-moe-16b [moe]: 28L, d=2048, 16H (kv=16), fine-grained MoE.

64 routed experts top-6 + 2 shared experts, per-expert d_ff=1408.
[arXiv:2401.06066]

Copy of ``repro/configs/deepseek_moe_16b.py`` without ``max_seq``, a field
the port's ``ModelConfig`` does not have (the engine's ``max_context``
bounds a request).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102_400, head_dim=128,
    num_experts=64, top_k=6, num_shared_experts=2, moe_d_ff=1408,
)

SMOKE = CONFIG.replace(
    name="deepseek-moe-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=32, vocab_size=256,
    num_experts=8, top_k=2, num_shared_experts=1, moe_d_ff=32,
)
