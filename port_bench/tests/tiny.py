"""The cells at a size a CPU test run holds: the published shapes' kinds
(grouped-query heads of 128, QKV bias where the config has it, the LoRA
rank) at two layers, narrow widths and a small vocabulary."""
from __future__ import annotations

import time

from port_bench import harness, spec

MODEL = {"num_hidden_layers": 2, "hidden_size": 512, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 128, "intermediate_size": 256,
         "vocab_size": 500}
MIX = {"prefill_pool": {"prefill_chunk": 8, "max_len": 33,
                        "sample_requests": 2}}
JOB = {"split_finetune": {"mini_batch": 2, "seq_len": 16, "local_epochs": 2}}


def run(cell: str, seed: int = 2 ** 31 + 5, seconds: float = 0.5,
        trace: bool = False, bench=None, dtype: str = None,
        layers: int = None) -> harness.Run:
    bench = bench or spec.benchmark()
    driver = spec.read_json(spec.HERE / "traffic" / (
        spec.cell_entry(bench, cell)["traffic"] + ".json"))["driver"]
    model = dict(MODEL, **({"torch_dtype": dtype} if dtype else {}),
                 **({"num_hidden_layers": layers} if layers else {}))
    r = harness.make_run(bench, cell, seed, seconds, trace, "cpu",
                         time.perf_counter(), model_override=model,
                         mix_override=MIX.get(driver))
    r.cell.config = dict(r.cell.config, **JOB.get(driver, {}))
    return r
