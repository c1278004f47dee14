"""Data parallelism over a mesh's "data" axis for the diffusion stack.

The JAX package runs a diffusion step on batch-sharded arrays with the
parameters replicated, and XLA all-reduces what the step reduces over the
batch. The port holds one model per device (`sharding.replicate`) and runs
each block on its slot's model; what crosses blocks is reduced explicitly:

- `map_blocks` applies a per-block function (a UNet forward): nothing
  crosses blocks.
- `null_text_optimize_step` is `diffusion.inversion.null_text_optimize_step`
  over the batch. Its loss is the mean over the whole batch, so each block
  differentiates its own sum of squared errors divided by the whole batch's
  element count (a block's mean would scale its gradient by global/local,
  which Adam's eps does not fully hide), and the loss that the early stop
  tests is that sum all-reduced over the mesh. Adam is elementwise, so one
  optimiser per block is Adam over the whole embedding.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..diffusion import schedulers
from .sharding import ShardedTensor, Slot, all_slots, like


def map_blocks(fn: Callable, *xs: ShardedTensor) -> ShardedTensor:
    """fn(slot, *blocks) on each local block of the alike-sharded xs."""
    return like(xs[0], {s: fn(s, *(x.blocks[s] for x in xs)) for s in xs[0].blocks})


def _all_sum(x: ShardedTensor, parts: Dict[Slot, torch.Tensor]) -> float:
    """Sum of one scalar per block over the whole mesh (all-reduced)."""
    got = all_slots(x.mesh, x.rows, {s: p.detach().reshape(1) for s, p in parts.items()})
    dev = x.device
    return float(torch.cat([v.to(dev) for _, v in sorted(got.items())]).sum())


def null_text_optimize_step(models: Dict[Slot, object], sched: schedulers.DiffusionSchedule,
                            latent_cur: ShardedTensor, latent_prev: ShardedTensor, t: int,
                            uncond: ShardedTensor, cond: ShardedTensor,
                            guidance_scale: float, num_inner_steps: int, lr: float,
                            stop_eps: float) -> Tuple[ShardedTensor, ShardedTensor]:
    """One timestep of null-text optimisation, data-parallel over the batch:
    returns (uncond', latent') sharded as latent_cur. `models` holds each
    block slot's model (the same weights on each slot's device)."""
    slots = sorted(latent_cur.blocks)
    n_total = latent_cur.shape.numel()
    lc, lp = latent_cur.blocks, latent_prev.blocks
    with torch.no_grad():
        eps_cond = {s: models[s].unet_apply(lc[s], t, cond.blocks[s]) for s in slots}
    u = {s: uncond.blocks[s].detach().clone().requires_grad_(True) for s in slots}
    opts = {s: torch.optim.Adam([u[s]], lr=lr, betas=(0.9, 0.999), eps=1e-8) for s in slots}
    j, loss_prev = 0, 1e9
    with torch.enable_grad():
        while j < num_inner_steps and loss_prev >= stop_eps:
            losses = {}
            for s in slots:
                eps_u = models[s].unet_apply(lc[s], t, u[s])
                eps = eps_u + guidance_scale * (eps_cond[s] - eps_u)
                prev_rec = schedulers.ddim_step(sched, eps, t, lc[s])
                loss = torch.sum((prev_rec - lp[s]) ** 2) / n_total
                opts[s].zero_grad(set_to_none=True)
                loss.backward()
                losses[s] = loss
            for s in slots:
                opts[s].step()
            loss_prev = _all_sum(latent_cur, losses)
            j += 1
    nxt = {}
    with torch.no_grad():
        for s in slots:
            eps_u = models[s].unet_apply(lc[s], t, u[s])
            eps = eps_u + guidance_scale * (eps_cond[s] - eps_u)
            nxt[s] = schedulers.ddim_step(sched, eps, t, lc[s])
    return (like(latent_cur, {s: u[s].detach() for s in slots}),
            like(latent_cur, nxt))
