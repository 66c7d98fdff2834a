"""The optimizer layer: one group's optax chain, written out in torch.

``cmf_tpu/training/experiment.py:89-131`` builds each optimizer as an optax
chain: ``clip_by_global_norm`` (with ``max_grad_norm``), then
``add_decayed_weights`` (with ``weight_decay``), then the rule
(``scale_by_adam``, ``scale_by_adamax``, or nothing for sgd), then
``scale_by_learning_rate`` over a constant or a cosine schedule. Under the
M-flow split the whole chain sits inside ``optax.masked``, once per group.
``GroupOptimizer`` is that chain over one group's parameters, to optax
0.2.6's formulas (not torch's):

* clip: ``g / ‖g‖ · max`` where ``‖g‖ ≥ max``, the norm over the group's
  own gradients (the clip is inside the mask);
* decay: ``g + wd · p`` (coupled L2), the group's parameters only;
* adam: ``μ ← (1-β₁)g + β₁μ``, ``ν ← (1-β₂)g² + β₂ν``, update
  ``μ̂ / (√ν̂ + ε)`` with ``μ̂ = μ / (1-β₁ᶜ)``, ``ν̂ = ν / (1-β₂ᶜ)``;
* adamax: ``ν ← max(|g| + ε, β₂ν)`` (ε inside the max, as optax has it),
  update ``μ̂ / ν``;
* sgd: the gradient itself, no momentum;
* learning rate: the update times ``-lr``, or ``-lr · ½(1 + cos(π·min(c,
  T)/T))`` with ``T = max_epochs × steps_per_epoch`` and ``c`` the group's
  own count from 0, so its first step takes the full rate.

One count a group serves the rule's bias correction (``c + 1``) and the
schedule (``c``): optax keeps two, which step together and are frozen
together. Everything lives on the parameters' device and is made at
construction, and a step reads nothing on the host, so a CUDA graph holds
it and reads the count (and with it the cosine rate) from the device on
every replay.

A group steps only its own parameters. ``optax.masked`` passes a
masked-out leaf's raw gradient through as its update; under M-flow that
gradient is exactly zero in both kinds of step (the other group's term is
off or detached), so leaving the leaf alone is the same update.
"""

import math

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RULES = ("adam", "adamax", "sgd")


class GroupOptimizer:
    def __init__(self, params, lr, rule="adam", schedule_steps=None, max_grad_norm=None, weight_decay=0.0):
        if rule not in RULES:
            raise AssertionError(f"Invalid optimizer {rule}")
        if schedule_steps is not None and not schedule_steps > 0:
            raise ValueError(f"The cosine schedule needs positive decay steps, got {schedule_steps}")
        self.params = list(params)
        self.lr = lr
        self.rule = rule
        self.schedule_steps = schedule_steps
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay
        device = self.params[0].device if self.params else torch.device("cpu")
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        moments = ("mu", "nu") if rule != "sgd" else ()
        self.state = {p: {k: torch.zeros_like(p, memory_format=torch.preserve_format) for k in moments}
                      for p in self.params}

    def tensors(self):
        """Every state tensor: the count, then each parameter's moments."""
        return [self.count] + [v for p in self.params for v in self.state[p].values()]

    def named_tensors(self, param_names):
        """(name, tensor) for every state tensor; ``param_names`` maps a
        parameter to its name in the density."""
        named = [("count", self.count)]
        for p in self.params:
            named += [(f"{param_names[p]}/{k}", v) for k, v in self.state[p].items()]
        return named

    def rate(self, count):
        """The learning rate at ``count`` (a device tensor), as optax's
        schedule computes it in float32."""
        if self.schedule_steps is None:
            return torch.full((), self.lr, device=count.device)
        c = torch.clamp(count.float(), max=float(self.schedule_steps))
        return self.lr * (0.5 * (1 + torch.cos(math.pi * c / self.schedule_steps)))

    def host_rate(self, i):
        """cmf_tpu's host mirror of the schedule at iteration ``i``, which
        its trainer writes as ``train/lr`` (experiment.py:99-103)."""
        if self.schedule_steps is None:
            return self.lr
        frac = min(i, self.schedule_steps) / self.schedule_steps
        return self.lr * 0.5 * (1 + np.cos(np.pi * frac))

    @torch.no_grad()
    def step(self):
        """One update of the group's parameters from their ``.grad``."""
        params = self.params
        updates = [p.grad for p in params]
        if self.max_grad_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(updates)))
            trigger = norm < self.max_grad_norm
            clipped = torch._foreach_mul(torch._foreach_div(updates, norm), self.max_grad_norm)
            updates = [torch.where(trigger, u, c) for u, c in zip(updates, clipped)]
        if self.weight_decay:
            updates = torch._foreach_add(updates, torch._foreach_mul(params, self.weight_decay))
        count_inc = self.count + 1
        if self.rule != "sgd":
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            new_mu = torch._foreach_add(torch._foreach_mul(updates, 1 - ADAM_B1), torch._foreach_mul(mu, ADAM_B1))
            mu_hat = torch._foreach_div(new_mu, 1 - torch.pow(ADAM_B1, count_inc))
            if self.rule == "adam":
                new_nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(updates, updates), 1 - ADAM_B2),
                                            torch._foreach_mul(nu, ADAM_B2))
                nu_hat = torch._foreach_div(new_nu, 1 - torch.pow(ADAM_B2, count_inc))
                updates = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), ADAM_EPS))
            else:
                new_nu = torch._foreach_maximum(torch._foreach_add(torch._foreach_abs(updates), ADAM_EPS),
                                                torch._foreach_mul(nu, ADAM_B2))
                updates = torch._foreach_div(mu_hat, new_nu)
            torch._foreach_copy_(mu, new_mu)
            torch._foreach_copy_(nu, new_nu)
        step_size = -self.rate(self.count)
        torch._foreach_add_(params, torch._foreach_mul(updates, step_size))
        self.count.copy_(count_inc)


def make_optimizer(config, params, steps_per_epoch=None):
    """One group's optimizer from the config (experiment.py:89-131):
    ``opt`` (adam, adamax, sgd), ``lr``, ``lr_schedule`` (``cosine``, else
    constant; the cosine's length is ``max_epochs × steps_per_epoch``),
    ``max_grad_norm`` and ``weight_decay``."""
    schedule_steps = None
    if config.get("lr_schedule", "none") == "cosine":
        if steps_per_epoch is None:
            raise ValueError("the cosine schedule needs steps_per_epoch")
        schedule_steps = config["max_epochs"] * steps_per_epoch
    return GroupOptimizer(
        params,
        lr=config["lr"],
        rule=config.get("opt", "adam"),
        schedule_steps=schedule_steps,
        max_grad_norm=config.get("max_grad_norm"),
        weight_decay=config.get("weight_decay", 0.0) or 0.0,
    )
