"""phi-3-vision-4.2b [vlm]: 32L, d=3072, 32H (kv=32), d_ff=8192, V=32064.

phi3-mini backbone + CLIP vision frontend STUBBED, as in the JAX package:
a batch's ``patches`` (B, 144, 3072), precomputed patch embeddings, are
prepended to the text tokens.  [hf:microsoft/Phi-3-vision-128k-instruct]

Copy of ``repro/configs/phi3_vision.py`` without ``max_seq``, a field the
port's ``ModelConfig`` does not have.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    frontend="vision", num_prefix_tokens=144,
)

SMOKE = CONFIG.replace(
    name="phi3v-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
    num_prefix_tokens=4,
)
