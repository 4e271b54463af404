"""falcon-mamba-7b [ssm]: 64L pure Mamba-1, d=4096, ssm_state=16, V=65024.

Attention-free (d_ff=0): each layer is a single Mamba block.
d_inner = 2*d_model, dt_rank = d_model/16.  [arXiv:2410.05355]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=65_024, head_dim=64,
    pattern=("mamba",),
    d_inner=8192, ssm_state=16, conv_width=4, dt_rank=256,
    scan_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="falcon-mamba-smoke", num_layers=2, d_model=64,
    vocab_size=256, d_inner=128, ssm_state=4, dt_rank=8,
)
