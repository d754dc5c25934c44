"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8 + 1 shared
[arXiv:2501.kimi2]. Assigned spec uses GQA(kv=8) in place of MLA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    n_experts=384, top_k=8, n_shared_experts=1,
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2 (Kimi K2 paper-table)",
)
