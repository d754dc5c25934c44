"""internvl2-26b [vlm] — InternViT + InternLM2 [arXiv:2404.16821].
LM backbone (InternLM2-20B shape) only; ViT frontend stubbed: input_specs()
provides precomputed patch embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=92553, head_dim=128,
    input_mode="embeds",
    source="arXiv:2404.16821 (InternVL2-26B)",
)
