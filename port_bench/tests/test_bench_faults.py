"""A run with the timed path broken underneath comes out not correct under
the cell's own limits: for each fault the cell can have. The harness's look
for a card is skipped (the run is on the CPU at a tiny size); the rest of
the run is the benchmark's."""
import pytest

from port_bench import harness
from port_bench.tests import tiny


def _correct(cell):
    line, _ = harness.run_cell(tiny.run(cell))
    return line


@pytest.mark.parametrize("cell", ["prefill_pool.qwen2-7b"])
def test_prefill_sound_run_is_correct(cell):
    assert _correct(cell)["correct"]


@pytest.mark.parametrize("cell", ["prefill_pool.qwen2-7b"])
def test_prefill_token_altered(cell, monkeypatch):
    """The first token replaced where the engine emits it."""
    from repro_torch.serving import engine
    emit = engine.ServingEngine._emit

    def altered(self, slot, req, nxt, now):
        return emit(self, slot, req, (nxt + 1) % self.cfg.vocab_size, now)

    monkeypatch.setattr(engine.ServingEngine, "_emit", altered)
    line = _correct(cell)
    assert not line["correct"]
    assert line["checks"]["served_gap"]["value"] > \
        line["checks"]["served_gap"]["limit"]


@pytest.mark.parametrize("cell", ["prefill_pool.qwen2-7b"])
def test_prefill_state_unchanged(cell, monkeypatch):
    """A chunk that leaves the cache as it was (K / V never written)."""
    from repro_torch.models import model as M
    from repro_torch.models.common import tree_map
    run = M.prefill_chunk

    def stateless(frozen, lora, cache, *a, **k):
        return run(frozen, lora, tree_map(lambda c: c.clone(), cache), *a,
                   **k)

    monkeypatch.setattr(M, "prefill_chunk", stateless)
    line = _correct(cell)
    assert not line["correct"]
    assert line["checks"]["kv_rel_err"]["value"] > \
        line["checks"]["kv_rel_err"]["limit"]


@pytest.mark.parametrize("cell", ["split_finetune.phi3-medium-14b",
                                  "split_finetune.qwen2-7b"])
def test_train_sound_run_is_correct(cell):
    assert _correct(cell)["correct"]


@pytest.mark.parametrize("cell", ["split_finetune.phi3-medium-14b",
                                  "split_finetune.qwen2-7b"])
def test_train_state_unchanged(cell, monkeypatch):
    """A step that returns the adapters unchanged."""
    from repro_torch.core import protocol
    monkeypatch.setattr(protocol, "apply_updates", lambda p, u: p)
    line = _correct(cell)
    assert not line["correct"]
    assert line["checks"]["change_norm_gap"]["value"] >= 1.0 - 1e-6


@pytest.mark.parametrize("cell", ["split_finetune.phi3-medium-14b",
                                  "split_finetune.qwen2-7b"])
def test_train_half_batch(cell, monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from repro_torch.core import splitting
    step = splitting.SplitExecutor.step

    def half(self, frozen, lora, batch, cut):
        rows = len(batch["labels"]) // 2
        return step(self, frozen, lora, {k: v[:rows] for k, v in
                                         batch.items()}, cut)

    monkeypatch.setattr(splitting.SplitExecutor, "step", half)
    assert not _correct(cell)["correct"]
