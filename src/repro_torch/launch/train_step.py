"""Train step: microbatched gradient accumulation + AdamW, the port of
``repro/launch/train_step.py``.

``microbatches=M`` runs M forward+backward passes, one per microbatch
(the batch's leading axis), accumulating fp32 gradients and dividing
them by M, as the reference's ``lax.scan``: activation memory scales
with the microbatch, at the cost of one fp32 accumulator the size of the
parameters. The parameters and the optimizer state are updated in place.
The step makes no host sync: its metrics are 0-d device tensors.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.api import ModelAPI
from repro_torch.optim.adamw import AdamW, AdamWState, param_leaves


def microbatch_policy(total_params: int, global_batch: int, dp: int) -> int:
    """Largest helpful M that keeps every microbatch >= 1 seq per slice."""
    want = 8 if total_params > 3e9 else 2
    while want > 1 and (global_batch % want or (global_batch // want) % dp):
        want //= 2
    return max(want, 1)


def make_train_step(api: ModelAPI, opt: AdamW,
                    microbatches: int = 1) -> Callable:
    """``step(params, opt_state, batch) -> metrics``: one optimizer step
    on ``params`` (the model's module) and ``opt_state``, both updated in
    place. With ``microbatches > 1`` every batch tensor carries a leading
    (M,) microbatch axis."""

    def single(params, opt_state: AdamWState, batch: dict):
        leaves = param_leaves(params)
        loss, aux = api.train_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        opt_metrics = opt.update(grads, opt_state, leaves)
        return {"loss": loss.detach(),
                **{k: v.detach() for k, v in aux.items()}, **opt_metrics}

    if microbatches <= 1:
        return single

    def accumulated(params, opt_state: AdamWState, batch: dict):
        """batch leaves carry a leading (M,) microbatch dim."""
        sizes = {k: v.shape[0] for k, v in batch.items()}
        if any(n != microbatches for n in sizes.values()):
            raise ValueError(f"{microbatches} microbatches, but the batch's "
                             f"leading axes are {sizes}")
        leaves = param_leaves(params)
        gacc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        losses = []
        for i in range(microbatches):
            loss, _aux = api.train_loss(params,
                                        {k: v[i] for k, v in batch.items()})
            for a, g in zip(gacc, torch.autograd.grad(loss, leaves)):
                a.add_(g.float())
            losses.append(loss.detach())
        for a in gacc:
            a.div_(microbatches)
        opt_metrics = opt.update(gacc, opt_state, leaves)
        return {"loss": torch.stack(losses).mean(), **opt_metrics}

    return accumulated
