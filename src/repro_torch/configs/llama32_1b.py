"""llama32-1b — the paper's own simulation model: "a 1B LLaMA 3.2 model with
32-layer transformer decoders" (Sec. V-A, citing [14])."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama32-1b", family="dense",
    n_layers=32, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=64,
    rope_theta=500_000.0, tie_embeddings=True,
    source="paper Sec. V-A / arXiv:2405.16406 [14]",
)
