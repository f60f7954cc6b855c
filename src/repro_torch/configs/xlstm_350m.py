"""xlstm-350m [arXiv:2405.04517] — sLSTM + mLSTM blocks (7:1), attention-free."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    citation="arXiv:2405.04517",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                   # xLSTM blocks carry their own up/down projections
    vocab_size=50304,
    layer_pattern=("mlstm",) * 7 + ("slstm",),
    mlstm_proj_factor=2.0,
    supports_long_context=True,   # O(1)-state recurrent decode
)
