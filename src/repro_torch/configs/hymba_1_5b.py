"""hymba-1.5b [hybrid] — parallel attention + mamba heads [arXiv:2411.13676].
Simplified per DESIGN.md: every layer fuses SWA attention and an SSM branch."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    sliding_window=1024,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    source="arXiv:2411.13676 (Hymba)",
)
