"""AdamW with global-norm clipping, and the warm-up + cosine LR schedule.

Counterpart of coda_neurips2023_tpu/optimizer.py: `make_lr_schedule`
(:23-77) and `build_optimizer` (:80-103).  The update is the JAX package's
optax chain, in its order:

  clip by global norm -> Adam -> decoupled weight decay -> x (-lr)

  * clip (optax clip_by_global_norm): g stays when ||g|| < max_norm, else
    becomes (g / ||g||) * max_norm.  (torch's clip_grad_norm_ adds 1e-6 to
    the norm, so it is not used.)
  * Adam (optax scale_by_adam, b1 0.9, b2 0.999, eps 1e-8): m = 0.1 g +
    0.9 m, v = 0.001 g^2 + 0.999 v, u = m_hat / (sqrt(v_hat) + eps) with the
    bias corrections of step t = 1, 2, ... (1 - decay^t, in float32 as optax
    forms them)
  * weight decay (optax add_decayed_weights): u + wd * p, on every
    parameter unless --filter_biases_wd, which keeps it to the parameters
    that are matrices in the flax tree (its ndim > 1 mask).
  * p += -lr * u, where lr is a runtime input of each step.

The state (m, v and the step count) lives in the optimizer, and
`state_dict` / `load_state_dict` carry it by parameter name, so a resumed run
goes on with the same moments and the same bias-correction step.  The
updates run as multi-tensor (`torch._foreach_*`) ops under no_grad, so a
step launches a few dozen kernels, not a few per parameter.
"""

from __future__ import annotations

import math
from typing import Iterable, List

import torch

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def make_lr_schedule(args, num_iters_per_epoch: int, host: bool = False):
    """Per-iteration LR: linear warm-up from warm_lr to base_lr over
    warm_lr_epochs (inclusive of its last step, as the reference's `<=`),
    then cosine from base_lr to final_lr over max_epoch.

    host=True gives a Python float function of the step; otherwise a
    function of the step returning a float32 tensor (the step may be a
    tensor, on any device).
    """
    max_iters = args.max_epoch * num_iters_per_epoch

    if host:
        def schedule(step):
            step = float(step)
            curr_epoch_f = step / num_iters_per_epoch
            if args.warm_lr_epochs > 0 and curr_epoch_f <= args.warm_lr_epochs:
                return args.warm_lr + curr_epoch_f / args.warm_lr_epochs * (
                    args.base_lr - args.warm_lr
                )
            if args.lr_scheduler != "cosine":
                return args.base_lr
            progress = step / max_iters
            return args.final_lr + 0.5 * (args.base_lr - args.final_lr) * (
                1 + math.cos(math.pi * progress)
            )

        return schedule

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        curr_epoch_f = step / num_iters_per_epoch
        warm = args.warm_lr + curr_epoch_f / max(args.warm_lr_epochs, 1e-9) * (
            args.base_lr - args.warm_lr
        )
        use_warm = (curr_epoch_f <= args.warm_lr_epochs) & (args.warm_lr_epochs > 0)
        if args.lr_scheduler != "cosine":
            return torch.where(use_warm, warm, torch.full_like(warm, args.base_lr))
        progress = step / max_iters
        cos = args.final_lr + 0.5 * (args.base_lr - args.final_lr) * (
            1 + torch.cos(math.pi * progress)
        )
        return torch.where(use_warm, warm, cos)

    return schedule


class AdamW:
    """The JAX package's optax chain over a list of parameters."""

    def __init__(self, params: Iterable[torch.nn.Parameter], weight_decay: float,
                 clip_gradient: float = 0.0, decay_mask: List[bool] = None, *,
                 names: List[str]):
        self.params = list(params)
        self.names = list(names)
        if len(self.names) != len(self.params):
            raise ValueError("names needs one entry per parameter")
        self.weight_decay = float(weight_decay)
        self.clip_gradient = float(clip_gradient or 0.0)
        mask = [True] * len(self.params) if decay_mask is None else list(decay_mask)
        if len(mask) != len(self.params):
            raise ValueError("decay_mask needs one entry per parameter")
        self.decay_mask = mask
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def state_dict(self) -> dict:
        """{"count": steps taken, "mu": {name: m}, "nu": {name: v}}; the
        tensors are the optimizer's own (copy them to keep them)."""
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a `state_dict` into this optimizer's moments, in place on
        their device; the names must be this optimizer's."""
        for key in ("mu", "nu"):
            if set(state[key]) != set(self.names):
                missing = sorted(set(self.names) - set(state[key]))
                unexpected = sorted(set(state[key]) - set(self.names))
                raise ValueError(f"optimizer state {key} does not match the parameters: "
                                 f"missing={missing[:8]} unexpected={unexpected[:8]}")
        for name, m, v in zip(self.names, self.mu, self.nu):
            m.copy_(state["mu"][name])
            v.copy_(state["nu"][name])
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr) -> torch.Tensor:
        """One update from the parameters' .grad (a missing grad counts as
        zeros) with learning rate `lr` (a float, or a 0-d tensor on the CPU or
        the parameters' device).  Returns the gradients' global norm before
        clipping."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.clip_gradient > 0:
            # (g / ||g||) * max_norm where it triggers, g / 1 * 1 elsewhere
            clipped = g_norm >= self.clip_gradient
            one = torch.ones_like(g_norm)
            grads = torch._foreach_div(grads, torch.where(clipped, g_norm, one))
            torch._foreach_mul_(grads, torch.where(clipped, self.clip_gradient * one, one))
        self.count += 1
        torch._foreach_mul_(self.mu, _B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - _B1)
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(self.nu, _B2)
        torch._foreach_add_(self.nu, sq, alpha=1.0 - _B2)
        # optax forms 1 - decay**t in float32 (a float pow of the float32
        # decay): 1 - f32(0.999) is 1.3e-5 away from 0.001, so it shows
        t = torch.tensor(float(self.count))
        c1, c2 = (float(1.0 - torch.pow(torch.tensor(b, dtype=torch.float32), t))
                  for b in (_B1, _B2))
        # in place from here: every out-of-place foreach op allocates one
        # tensor a parameter, which costs the host more than the update
        updates = torch._foreach_div(self.mu, c1)
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        torch._foreach_div_(updates, denom)
        if self.weight_decay:
            pairs = [(u, p) for u, p, m in zip(updates, self.params, self.decay_mask) if m]
            torch._foreach_add_([u for u, _ in pairs], [p for _, p in pairs],
                                alpha=self.weight_decay)
        if isinstance(lr, torch.Tensor) and lr.device.type == "cpu":
            lr = float(lr)  # a blocking copy to the card would wait for the backward
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(self.params, updates)
        return g_norm


def build_optimizer(args, model: torch.nn.Module, num_iters_per_epoch: int):
    """(AdamW over the model's parameters, the tensor LR schedule)."""
    named = list(model.named_parameters())
    mask = None
    if getattr(args, "filter_biases_wd", False):
        # flax holds the attention input biases as (heads, head_dim): matrices there
        mask = [p.dim() > 1 or name.endswith("in_proj_bias") for name, p in named]
    opt = AdamW((p for _, p in named), args.weight_decay,
                clip_gradient=getattr(args, "clip_gradient", 0.0), decay_mask=mask,
                names=[name for name, _ in named])
    return opt, make_lr_schedule(args, num_iters_per_epoch)
