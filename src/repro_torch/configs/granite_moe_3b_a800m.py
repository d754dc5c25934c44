"""granite-moe-3b-a800m [moe] — 40 experts top-8 (assigned structured field;
the bracket note says 32 — we follow the structured field, see DESIGN.md)
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    n_experts=40, top_k=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (GraniteMoE)",
)
