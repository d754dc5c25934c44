"""Training step factory + a runnable CPU-scale training entry point.

``make_train_step`` builds the full fine-tune step (forward + LoRA-only
grads + optimizer update); it is also what a server would run as the
*server side* of the SL deployment at the CARD cut. Gradients come from
``torch.autograd.grad`` on fresh leaves made from the adapters, so the step
is a pure function of its inputs, as the reference's jitted step is.

    python -m repro_torch.launch.train --steps 200 [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import shardctx
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.launch import sharding as shd
from repro_torch.models import model as model_lib
from repro_torch.models.common import (Params, batch_to_device,
                                       resolve_device, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.optim import Optimizer, adamw, apply_updates, warmup_cosine


def value_and_grad(loss_fn: Callable[..., torch.Tensor], params: Params,
                   *args) -> Tuple[torch.Tensor, Params]:
    """(loss, d loss / d params) of ``loss_fn(params, *args)``, the
    gradients shaped like ``params`` (zeros where a leaf does not reach the
    loss, as JAX gives)."""
    train = tree_map(lambda x: x.detach().requires_grad_(), params)
    leaves = tree_leaves(train)
    with torch.enable_grad():
        loss = loss_fn(train, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    impl: str = "chunked", remat: bool = True,
                    cut: int = 0, unroll: bool = False,
                    microbatches: int = 1) -> Callable:
    """Returns train_step(frozen, lora, opt_state, batch) ->
    (loss, new_lora, new_opt_state). ``batch`` holds numpy arrays or
    tensors; they go to the parameters' device.

    ``cut > 0`` runs only the server-resident stage [cut, I) + head — the
    device side runs on the edge fleet, so the step reads the smashed data
    ``batch["smashed"]`` as its input.

    ``microbatches > 1`` splits the batch and accumulates the LoRA grads in
    f32, which divides peak activation memory by the microbatch count.

    Under ``shardctx.mesh_ctx`` of a ``LiveMesh`` of several ranks the step
    is tensor-parallel (``models.model``): ``frozen``, ``lora`` and
    ``opt_state`` are this rank's blocks (``sharding.shard_params`` of
    ``param_specs``), ``batch`` the global batch; each rank's gradients are
    summed over the axes its adapters are replicated over
    (``sharding.reduce_grads``), so every rank updates its blocks as one
    card would, and the loss is the whole batch's.
    """

    def loss_fn(lora, frozen, batch):
        if cut == 0:
            return model_lib.forward_loss(frozen, lora, batch, cfg,
                                          impl=impl, remat=remat,
                                          unroll=unroll)
        x, aux = model_lib.forward_hidden(
            frozen, lora, batch["smashed"], cfg, lo=cut, hi=cfg.n_layers,
            impl=impl, remat=remat, inputs_embedded=True, unroll=unroll)
        return model_lib.loss_from_hidden(frozen, x, batch["labels"], aux,
                                          cfg)

    def train_step(frozen: Params, lora: Params, opt_state, batch
                   ) -> Tuple[torch.Tensor, Params, Any]:
        batch = batch_to_device(batch, frozen["embed"].device)
        mesh = shardctx.live()
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, lora, frozen, batch)
        else:
            parts = {k: v.chunk(microbatches) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=frozen["embed"].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), lora)
            for i in range(microbatches):
                mb = {k: v[i] for k, v in parts.items()}
                l, g = value_and_grad(loss_fn, lora, frozen, mb)
                grads = tree_map(lambda a, b: a + b.to(torch.float32),
                                 grads, g)
                loss = loss + l
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        if mesh is not None:
            grads = shd.reduce_grads(grads, shd.lora_specs(cfg, lora, mesh),
                                     mesh)

        updates, new_state = optimizer.update(grads, opt_state, lora)
        new_lora = apply_updates(lora, updates)
        return loss, new_lora, new_state

    return train_step


# ---------------------------------------------------------------------------
# CPU-scale run: fine-tune a reduced model for a few hundred steps
# ---------------------------------------------------------------------------


def run_training(arch: str = "llama32-1b", steps: int = 200,
                 batch: int = 8, seq_len: int = 64, lr: float = 5e-3,
                 log_every: int = 20, seed: int = 0,
                 pretrain_steps: int = 60, device=None) -> Dict[str, Any]:
    """Full-parameter pre-training of the reduced model's backbone on one
    synthetic task, then LoRA fine-tuning on another (a domain shift).
    ``device=None`` is the GPU and raises without one."""
    from repro_torch.data import make_fleet_datasets

    device = resolve_device(device)
    cfg = get_config(arch).reduced()
    params = model_lib.init_params(seed, cfg, device)
    # pretraining task != fine-tuning task (domain shift for the LoRA phase)
    ds = make_fleet_datasets(cfg, 1, vocab=cfg.vocab_size, seed=seed)[0]
    ft_ds = make_fleet_datasets(cfg, 1, vocab=cfg.vocab_size,
                                seed=seed + 1000)[0]

    # brief full-param pretraining so the frozen backbone is a real
    # "pre-trained LLM" for the LoRA phase (paper Sec. II-A premise)
    opt_full = adamw(warmup_cosine(3e-3, 10, pretrain_steps))
    st = opt_full.init(params["frozen"])

    def pre_loss_fn(fr, batch_):
        return model_lib.forward_loss(fr, None, batch_, cfg, impl="naive",
                                      remat=False)

    frozen = params["frozen"]
    pre_loss = torch.full((), math.nan)
    for _ in range(pretrain_steps):
        b = batch_to_device(ds.minibatch(batch, seq_len), device)
        pre_loss, g = value_and_grad(pre_loss_fn, frozen, b)
        upd, st = opt_full.update(g, st, frozen)
        frozen = apply_updates(frozen, upd)

    optimizer = adamw(warmup_cosine(lr, 20, steps))
    opt_state = optimizer.init(params["lora"])
    step_fn = make_train_step(cfg, optimizer, impl="naive", remat=False)
    lora = params["lora"]
    losses: List[torch.Tensor] = []
    t0 = time.time()
    for i in range(steps):
        loss, lora, opt_state = step_fn(frozen, lora, opt_state,
                                        ft_ds.minibatch(batch, seq_len))
        losses.append(loss)          # stays on the device; no per-step sync
        if log_every and i % log_every == 0:
            # splint: ignore[trace-safety] -- log_every-gated progress sync
            print(f"step {i:4d} loss {float(loss):.4f}")
    values = torch.stack(losses).tolist() if losses else []
    return {"losses": values, "pretrain_loss": float(pre_loss),
            "steps_per_sec": steps / (time.time() - t0), "lora": lora,
            "frozen": frozen, "cfg": cfg}


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama32-1b")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; raises without one)")
    args = p.parse_args(argv)
    out = run_training(args.arch, args.steps, args.batch, args.seq_len,
                       args.lr, device=args.device)
    print(f"final loss {out['losses'][-1]:.4f} "
          f"({out['steps_per_sec']:.2f} steps/s)")


if __name__ == "__main__":
    main()
