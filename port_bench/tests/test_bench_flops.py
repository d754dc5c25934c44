"""The benchmark's operation counts against ``torch.utils.flop_counter``
on the port's own steps, traced on ``meta`` at the published widths (the
port's ``launch/analysis.analyze_step`` counts so): equal, apart from the
work the program does beyond the need, which the test names:

* attention over masked positions: the prefill's chunk attends over the
  whole cache lane, the training step's naive attention over the whole
  sequence (forward, and twice that backward);
* the head's columns of the padded vocabulary rows."""
import pytest
import torch

from port_bench import harness, spec
from port_bench.flops import prefill_pool as fp
from port_bench.flops import split_finetune as fs

BENCH = spec.benchmark()


def _counted(fn, *args) -> float:
    from repro_torch.launch.analysis import analyze_step
    roof, _, _ = analyze_step(fn, *args)
    return roof.flops


@pytest.mark.parametrize("t0", [0, 1024, 3072])
def test_prefill_chunk_count(t0):
    from repro_torch.models import model as M
    r = harness.make_run(BENCH, "prefill_pool.qwen2-7b", 1, 1, False, "cpu",
                         0.0)
    cfg, mix = r.cfg, r.cell.mix
    c, slots = int(mix["prefill_chunk"]), int(mix["max_len"])
    p = M.abstract_params(cfg)
    cache = M.init_cache(cfg, 1, slots, device="meta")
    toks = torch.zeros((1, c), dtype=torch.long, device="meta")
    lora = {"layers": {g: {k: {"a": v["a"], "b": v["b"]}
                           for k, v in grp.items()}
                       for g, grp in p["lora"]["layers"].items()}}
    got = _counted(lambda: M.prefill_chunk(p["frozen"], lora, cache, toks,
                                           t0, cfg))
    d = r.dims
    need = fp.chunk_ops(d, r.rank, t0, c, True)
    masked = fp.attention_ops(d, c * slots - fp.attention_pairs(
        t0, c, d.window)) * d.layers
    pad = 2.0 * d.d * (cfg.padded_vocab - d.vocab)
    assert got == need + masked + pad


@pytest.mark.parametrize("cell", ["split_finetune.qwen2-7b",
                                  "split_finetune.phi3-medium-14b"])
def test_split_epoch_count(cell):
    from repro_torch.core import splitting as S
    from repro_torch.models import model as M
    r = harness.make_run(BENCH, cell, 1, 1, False, "cpu", 0.0)
    cfg, conf = r.cfg, r.cell.config
    b, s = int(conf["mini_batch"]), int(conf["seq_len"])
    p = M.abstract_params(cfg)
    dev, srv = S.split_lora(p["lora"], cfg.n_layers // 2)
    toks = torch.zeros((b, s), dtype=torch.long, device="meta")
    got = _counted(lambda: S.split_grads(p["frozen"], dev, srv, toks, toks,
                                         cfg=cfg, cut=cfg.n_layers // 2))
    d = r.dims
    need = fs.matmul_ops(d, r.rank, b, s)
    masked = 3 * fp.attention_ops(d, s * s - fp.attention_pairs(
        0, s, d.window)) * b * d.layers
    pad = 2 * 2.0 * d.d * (cfg.padded_vocab - d.vocab) * b * s
    assert got == need + masked + pad


def test_lora_training_is_not_six_nd():
    """Frozen weights take no gradient: an epoch needs about 4 N D, where a
    step that trains every weight needs 6 N D."""
    r = harness.make_run(BENCH, "split_finetune.phi3-medium-14b", 1, 1,
                         False, "cpu", 0.0)
    cfg = r.cfg
    tokens = 2 * 512
    ratio = fs.epoch_ops(r.dims, r.rank, 2, 512) / (cfg.total_params()
                                                    * tokens)
    assert 3.9 < ratio < 4.3
