"""Probe, not a test: the first steps of glow's published optimizer (adamax,
lr 5e-4) on the synthetic cifar10 stand-in, in both packages, from the same
weights (the JAX package's init carried into the port by ``interop``) and
the same batches, at a cut width; the dequantization noise is each
package's own draw. Run from the repo root:

    CMF_TPU_SYNTHETIC_DATA=1 JAX_PLATFORMS=cpu python tests/_glow_rate_probe.py [hidden] [steps a scale] [batch] [lr]

It prints each package's loss and gradient norm a step: the second step's
loss jumps by orders of magnitude in both (at full width it leaves fp32's
range)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from cmf_tpu.config import expand_grid, get_config  # noqa: E402
from cmf_tpu.training import experiment as jax_experiment  # noqa: E402
from cmf_tpu_torch.interop import variables_from_jax  # noqa: E402
from cmf_tpu_torch.training import experiment  # noqa: E402


def main(hidden=64, steps=8, batch=16, lr=5e-4):
    config = expand_grid(get_config("cifar10", "glow", use_baseline=True))[0]
    config = {**config, "model": "glow", "dataset": "cifar10", "nosave": True, "synthetic_data": True,
              "max_dataset_size": 4 * batch, "max_epochs": 1, "seed": 0, "num_fid_samples": 100,
              "g_num_hidden_channels": hidden, "num_steps_per_scale": steps, "train_batch_size": batch, "lr": lr}
    jax_setup = jax_experiment.setup_experiment(config, write_to_disk=False)
    trainer = jax_setup["trainer"]
    flags = trainer.objective.for_epoch(1)
    batches = trainer.train_loader.epoch_batches()
    # Host copies: the epoch donates its inputs.
    variables = jax.tree.map(np.asarray, {"params": trainer.params, "state": trainer.model_state})
    out = trainer._get_epoch_fn(flags["optimizer_index"], flags)(
        trainer.params, trainer.model_state, trainer.opt_states[0], trainer.rng, batches,
        jnp.asarray(flags["likelihood_wt"], jnp.float32), jnp.asarray(flags["metric_wt"], jnp.float32))
    for i, (loss, norm) in enumerate(zip(np.asarray(out[4]), np.asarray(out[5]))):
        print(f"cmf_tpu       step {i + 1}: loss {loss:.6g}, grad norm {norm:.6g}")

    setup = experiment.setup_experiment(config, write_to_disk=False, device="cpu")
    variables_from_jax(setup["density"], variables)
    port = setup["trainer"]
    for i, x in enumerate(torch.tensor(np.asarray(b)) for b in batches):
        loss, norm = port.eager_step(x, flags)
        print(f"cmf_tpu_torch step {i + 1}: loss {float(loss):.6g}, grad norm {float(norm):.6g}")


if __name__ == "__main__":
    args = sys.argv[1:]
    main(*(int(a) for a in args[:3]), *(float(a) for a in args[3:4]))
