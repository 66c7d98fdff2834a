"""Training engine, the train-loop subset (``cmf_tpu/training/trainer.py``
in torch).

One step is ``-mean(elbo)``, ``backward``, then the optimizer, with the
per-epoch flags of the objective (trainer.py:128-176). A step whose loss or
gradient norm is not finite leaves the parameters and the optimizer state as
they were, and the epoch raises ``FloatingPointError`` at its end, as the JAX
package's frozen scan carry does (trainer.py:160-173, 296-302). Checking that
costs one host sync a step.

Waiting for a later slice, and refused by ``experiment.setup_experiment``
when a config asks for them: validation (FID-as-validation for tabular
non-square runs), early stopping, checkpoints and the writer. The per-epoch
test pass of a tabular non-square run without FID computes a constant zero
placeholder (experiment.py:213-215) whose only reader is the writer, which
``--nosave`` turns into a no-op; the port does not run it.
"""

import math
import time

import torch


def elbo_loss(density, x, flags, generator=None, **draws):
    """``-mean(elbo)`` of training batch ``x`` under an epoch's objective
    ``flags``. ``generator`` draws the dequantization noise and the
    Hutchinson probes; ``draws`` may pass them in instead
    (``dequantization_noise``, ``hutchinson_eps``)."""
    info = density.elbo(
        x,
        train=True,
        generator=generator,
        **draws,
        likelihood_wt=flags["likelihood_wt"],
        metric_wt=flags["metric_wt"],
        add_reconstruction=flags["add_reconstruction"],
        add_diagonal_metric_reg=flags["add_diagonal_metric_reg"],
        add_offdiagonal_metric_reg=flags["add_offdiagonal_metric_reg"],
        skip_likelihood=bool(flags["skip_likelihood"]),
    )
    return -info["elbo"].mean()


class Trainer:
    def __init__(self, density, objective, optimizer, train_loader, max_epochs, generator=None):
        self.density = density
        # Draws the dequantization noise and the Hutchinson probes; a
        # generator on the device the density lives on.
        self.generator = generator
        self.objective = objective
        self.optimizer = optimizer
        self.train_loader = train_loader
        self.max_epochs = max_epochs
        self.params = [p for p in density.parameters() if p.requires_grad]
        self.epoch = 0
        self.iteration = 0
        # One entry per step taken: (epoch, loss, grad_norm, skip_likelihood).
        self.history = []

    def step(self, x, flags):
        """One optimizer step; returns (loss, grad_norm) as floats."""
        self.optimizer.zero_grad(set_to_none=False)
        loss = elbo_loss(self.density, x, flags, self.generator)
        loss.backward()
        # A parameter the loss does not reach (the latent prior on a
        # warmup step) gets a zero gradient, as under jax.grad: Adam then
        # still decays its moments, where torch would skip the parameter.
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad) for p in self.params])
        )
        loss_v, norm_v = (float(v) for v in torch.stack([loss.detach(), grad_norm]).cpu())
        if math.isfinite(loss_v) and math.isfinite(norm_v):
            self.optimizer.step()
        return loss_v, norm_v

    def train(self):
        while self.epoch < self.max_epochs:
            self.epoch += 1
            self._train_epoch(self.epoch)

    def _train_epoch(self, epoch):
        flags = self.objective.for_epoch(epoch)
        if flags["skip_epoch"]:
            return
        if flags["optimizer_index"] != 0:
            raise NotImplementedError(
                "a second optimizer group (m-flow) waits for a later slice of the port"
            )
        start = time.perf_counter()
        losses = []
        for x in self.train_loader:
            loss, grad_norm = self.step(x, flags)
            losses.append(loss)
            self.history.append((epoch, loss, grad_norm, bool(flags["skip_likelihood"])))
        self.iteration += len(losses)
        print(
            f"epoch {epoch}: {len(losses)} steps, last loss {losses[-1]:.6g}, "
            f"likelihood_wt {flags['likelihood_wt']:.3g}, {time.perf_counter() - start:.3f} s",
            flush=True,
        )
        if not all(math.isfinite(v) for v in losses):
            raise FloatingPointError(f"NaN/Inf loss during epoch {epoch}")
