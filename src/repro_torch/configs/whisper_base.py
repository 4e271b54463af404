"""whisper-base [audio]: 6L enc + 6L dec, d=512, 8H, d_ff=2048, V=51865.

Enc-dec with the conv audio frontend stubbed, as in the JAX package: the
encoder takes precomputed log-mel frame embeddings (B, 1500, 512).
[arXiv:2212.04356]

Copy of ``repro/configs/whisper_base.py`` without ``max_seq``, a field the
port's ``ModelConfig`` does not have.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    norm="layernorm", glu=False, act="gelu", tie_embeddings=True,
    is_encoder_decoder=True, num_encoder_layers=6, encoder_seq=1500,
    frontend="audio",
)

SMOKE = CONFIG.replace(
    name="whisper-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
    num_encoder_layers=2, encoder_seq=16,
)
