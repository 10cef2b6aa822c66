"""The training step, plain PyTorch: the sharp loss on the batch mean of
E[F], its gradient through the Monte-Carlo objective and the model, the
global-norm clip and Adam, followed step by step from given weights.

* sharp loss ``log(1 + exp(−k(F − τ̄)))·(1 − F)`` on ``F = mean_b E[F]_b``;
* clip by global norm: ``g ← g·c/‖g‖`` where ``‖g‖ ≥ c``;
* Adam (β₁ 0.9, β₂ 0.999, ε 1e-8 added to ``√v̂``) at the schedule's rate:
  constant, or a linear warm-up from 0.05·lr over ``total // 20`` steps and
  a cosine decay to 0.1·lr at ``total``.

The Monte-Carlo part runs in one pass where the batch fits ``rows``, else
in blocks of rows: a first pass without a graph gives the mean and
``∂loss/∂F``, and each block is then differentiated alone, so that memory
stays within one block's graph.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import matmul_precision

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def sharp_loss(f: torch.Tensor, tau_bar: float, k: float) -> torch.Tensor:
    return F.softplus(-k * (f - tau_bar)) * (1.0 - f)


def learning_rate(train: dict, step: int) -> float:
    lr = train["learning_rate"]
    if train["lr_schedule"] == "constant":
        return lr
    total = train["lr_schedule_steps"]
    warmup = max(total // 20, 1)
    if step < warmup:
        return (0.05 * lr - lr) * (1.0 - step / warmup) + lr
    decay = total - warmup
    cosine = 0.5 * (1.0 + math.cos(math.pi * min(step - warmup, decay) / decay))
    return lr * (0.9 * cosine + 0.1)


def _mc_grad(pulses: torch.Tensor, mean_fid: Callable, rows: int, loss_of: Callable):
    """``(loss, ∂loss/∂pulses)`` for ``loss_of(mean_b mean_fid(rows b))``,
    ``rows`` targets at a time; ``mean_fid(pulses, sl)`` scores the rows
    ``sl`` of the batch."""
    B = pulses.shape[0]
    if rows >= B:
        p = pulses.detach().requires_grad_(True)
        loss = loss_of(mean_fid(p, slice(0, B)).mean())
        (g,) = torch.autograd.grad(loss, p)
        return loss.detach(), g
    blocks = [slice(i, min(i + rows, B)) for i in range(0, B, rows)]
    with torch.no_grad():
        f = torch.cat([mean_fid(pulses[sl], sl) for sl in blocks])
    mean = f.mean().requires_grad_(True)
    loss = loss_of(mean)
    (dmean,) = torch.autograd.grad(loss, mean)
    dpulses = torch.zeros_like(pulses)
    for sl in blocks:
        p = pulses[sl].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(mean_fid(p, sl).sum(), p)
        dpulses[sl] = g * (dmean / B)
    return loss.detach(), dpulses


def replay(weights: Dict[str, torch.Tensor], batches: Sequence[tuple], forward: Callable,
           draw: Callable, mean_fid: Callable, train: dict, generator: torch.Generator,
           precision: str = "f32", rows: int = 64, half_batch: bool = False) -> dict:
    """Follow ``len(batches)`` steps from ``weights``.

    ``batches[s] = (inputs, targets)``; ``draw(generator, B)`` draws the
    step's disorder before the forward pass, ``forward(params, inputs,
    generator)`` gives the pulses with dropout from ``generator``, and
    ``mean_fid(pulses, targets, errors)`` the per-target E[F].
    ``half_batch`` takes the loss over the first half of the targets only
    (a planted fault).  Returns the losses, each leaf's norm of the first
    step's gradient before (``grad_raw``) and after the clip (``grad``),
    and each leaf's norm of the change over all steps (``change``).
    """
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(x) for k, x in params.items()}
    out: Dict[str, object] = {"loss": []}
    with matmul_precision(precision):
        for step, (inputs, targets) in enumerate(batches):
            B = targets.shape[0]
            errors = draw(generator, B)
            pulses = forward(params, inputs, generator)
            used = B // 2 if half_batch else B
            loss, dpulses = _mc_grad(
                pulses[:used].detach(),
                lambda p, sl: mean_fid(p, targets[sl], tuple(e[sl] for e in errors)),
                rows, lambda f: sharp_loss(f, train["loss_tau_bar"], train["loss_k"]))
            full = torch.zeros_like(pulses)
            full[:used] = dpulses
            names = list(params)
            grads = dict(zip(names, torch.autograd.grad(pulses, [params[k] for k in names],
                                                        full)))
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            c = train["grad_clip"]
            clipped = {k: torch.where(norm < c, g, g / norm * c) for k, g in grads.items()}
            if step == 0:
                out["grad_raw"] = {k: float(torch.linalg.vector_norm(g))
                                   for k, g in grads.items()}
                out["grad"] = {k: float(torch.linalg.vector_norm(g))
                               for k, g in clipped.items()}
            lr, t = learning_rate(train, step), step + 1
            with torch.no_grad():
                for k, g in clipped.items():
                    m[k] = BETA1 * m[k] + (1 - BETA1) * g
                    v[k] = BETA2 * v[k] + (1 - BETA2) * g * g
                    update = (m[k] / (1 - BETA1 ** t)) / (
                        torch.sqrt(v[k] / (1 - BETA2 ** t)) + ADAM_EPS)
                    params[k] -= lr * update
            out["loss"].append(float(loss))
    with torch.no_grad():
        out["change"] = {k: float(torch.linalg.vector_norm(params[k] - weights[k]))
                         for k in params}
    return out


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """Each leaf's ``|‖got‖ − ‖want‖| / max(‖want‖, the median leaf's
    ‖want‖)`` over ``leaves``."""
    med = float(torch.tensor([want[k] for k in leaves]).median())
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in leaves}


def moving_leaves(grad_raw: Dict[str, float]) -> List[str]:
    """Leaves whose first gradient is at least a thousandth of the median
    leaf's in the reference: the others (a key bias under softmax) move
    under Adam by round-off alone."""
    med = float(torch.tensor(list(grad_raw.values())).median())
    return [k for k, g in grad_raw.items() if g >= 1e-3 * med]
