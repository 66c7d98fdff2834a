"""Per-epoch training objective schedules for non-square flows.

Contract: reference cmf/non_square_helpers.py:31-135 —
* likelihood warmup: weight = interp(epoch, [start, end], [0, 1]), with the
  m-flow epoch-doubling convention (num_objectives=2 ⇒ every two engine
  epochs are one logical epoch; likelihood only on odd engine epochs);
* add_reconstruction on epochs where epoch % num_objectives == 0;
* g_kk / g_ij variants scale likelihood_wt by elbo_regularization_param and
  metric_wt by metric_regularization_param, adding the metric term only on
  reconstruction epochs; mutual-exclusion asserts.

Epochs here are 1-based (matching the reference's ignite engine) — the
trainer passes engine-style epoch numbers.

The returned schedule emits, per epoch, a dict of *static* flags (compile-time
branch selectors) and *traced* weights (continuous, never recompile):
  {"skip": bool, "likelihood_wt": float, "metric_wt": float,
   "add_reconstruction": bool, "g_kk": bool, "g_ij": bool,
   "optimizer_index": int}
"""

import numpy as np


class NonSquareObjective:
    def __init__(self, config):
        self.m_flow = bool(config.get("m_flow", False))
        self.num_objectives = 2 if self.m_flow else 1
        self.g_kk = bool(config.get("g_kk_loss", False))
        self.g_ij = bool(config.get("g_ij_loss", False))
        if self.g_kk:
            assert not self.g_ij, (
                "Cannot have both diagonal and offdiagonal terms in l1"
            )
        if self.g_ij:
            assert config["latent_dimension"] != 1, "There is no offdiagonal for 1d latent"
        self.elbo_reg = float(config.get("elbo_regularization_param", 1))
        self.metric_reg = float(config.get("metric_regularization_param", 1))

        self.likelihood_warmup = bool(config.get("likelihood_warmup", False))
        if self.likelihood_warmup:
            self.warmup_bounds = [
                self.num_objectives * config["likelihood_warmup_start"],
                self.num_objectives * config["likelihood_warmup_end"],
            ]
            self.likelihood_introduction_epoch = self.warmup_bounds[0]
            self.early_stopping_start_epoch = self.warmup_bounds[1]
        else:
            self.warmup_bounds = None
            self.likelihood_introduction_epoch = 0
            self.early_stopping_start_epoch = 0

    def likelihood_weight(self, epoch):
        if self.likelihood_warmup:
            if (epoch + 1) % self.num_objectives == 0:
                return float(np.interp(epoch, self.warmup_bounds, [0.0, 1.0]))
            return 0.0
        return float((epoch + 1) % self.num_objectives == 0)

    def skip_epoch(self, epoch):
        """m-flow warmup skips the likelihood epochs entirely before
        introduction (trainer.py:196-201)."""
        return (
            epoch < self.likelihood_introduction_epoch
            and epoch % self.num_objectives != 0
        )

    def for_epoch(self, epoch):
        wt = self.likelihood_weight(epoch)
        add_recon = epoch % self.num_objectives == 0
        use_metric = (self.g_kk or self.g_ij) and add_recon
        return {
            "skip_epoch": self.skip_epoch(epoch),
            "skip_likelihood": np.isclose(wt, 0.0),
            "likelihood_wt": wt * self.elbo_reg if (self.g_kk or self.g_ij) else wt,
            "metric_wt": wt * self.metric_reg if use_metric else 0.0,
            "add_reconstruction": add_recon,
            "add_diagonal_metric_reg": self.g_kk and add_recon,
            "add_offdiagonal_metric_reg": self.g_ij and add_recon,
            "optimizer_index": epoch % self.num_objectives,
        }


class SquareObjective:
    """Plain -elbo objective for square flows (experiment.py:608-611)."""

    num_objectives = 1
    likelihood_introduction_epoch = 0
    early_stopping_start_epoch = 0

    def for_epoch(self, epoch):
        return {
            "skip_epoch": False,
            "skip_likelihood": False,
            "likelihood_wt": 1.0,
            "metric_wt": 0.0,
            "add_reconstruction": True,
            "add_diagonal_metric_reg": False,
            "add_offdiagonal_metric_reg": False,
            "optimizer_index": 0,
        }


def get_objective(config):
    if config.get("non_square", False):
        return NonSquareObjective(config)
    return SquareObjective()
