"""recurrentgemma-9b [hybrid]: 38L, d=4096, 16H (kv=1), d_ff=12288, V=256000.

Griffin: RG-LRU recurrent blocks + local attention, 1 attn : 2 rec
(pattern rec,rec,local; window 2048).  [arXiv:2402.19427]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256_000, head_dim=256,
    pattern=("rec", "rec", "local"), window_size=2048,
    d_inner=4096, conv_width=4, rglru_blocks=16,
    act="gelu", glu=True, embed_scale=True, tie_embeddings=True,
    scan_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="recurrentgemma-smoke", num_layers=3, d_model=64, num_heads=4,
    num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
    d_inner=64, rglru_blocks=4, window_size=8,
)
