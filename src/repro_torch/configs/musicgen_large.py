"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284]. Frontend (EnCodec) is stubbed: input_specs() provides
precomputed frame embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048, head_dim=64,
    input_mode="embeds",
    source="arXiv:2306.05284 (MusicGen large)",
)
