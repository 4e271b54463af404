"""qwen1.5-32b [dense]: 64L, d=5120, 40H (kv=40), d_ff=27392, V=152064.

QKV bias.  40 heads are padded to 48 for 16-way head sharding (DESIGN §6).
[hf:Qwen/Qwen1.5-0.5B scaled per assignment]

Copy of ``repro/configs/qwen15_32b.py`` without ``max_seq``, a field the
port's ``ModelConfig`` does not have (the engine's ``max_context`` bounds
a request).  The port does not shard yet and so pads no head: it runs the
40 heads as they are (the JAX package's ``shard_multiple`` of 1 does the
same).  On one 80 GB card it is served on the ``kv_quant="int8"`` cache
(``ROADMAP.md``, queue A).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
    d_ff=27392, vocab_size=152_064, head_dim=128,
    qkv_bias=True,
)

SMOKE = CONFIG.replace(
    name="qwen-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
)
