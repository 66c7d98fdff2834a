"""The port's optimizer layer (``cmf_tpu_torch/training/optim.py``) against
the JAX package's optax chains (``cmf_tpu/training/experiment.py``
``make_optimizer``): each rule, option and schedule over 5 steps from the
same parameters and gradients (numpy seeds), the parameters and the
optimizer state within 1e-6 relative; the same chain inside ``optax.masked``
against one group's optimizer; the cosine rate on the device and the
``train/lr`` host mirror; and the invalid settings that raise in both."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cmf_tpu.training.experiment import make_optimizer as jax_make_optimizer
from cmf_tpu_torch.interop import flatten_tree
from cmf_tpu_torch.training import make_optimizer

STEPS = 5
STEPS_PER_EPOCH = 1
RTOL = 1e-6
SHAPES = {"a": (3, 4), "b": (4,), "c": {"w": (2, 2, 3), "v": (1,)}}

CASES = {
    "adam": {},
    "adamax": {"opt": "adamax"},
    "sgd": {"opt": "sgd"},
    # T = 3 steps: the rate reaches 0 at step 4 and stays there.
    "cosine": {"lr_schedule": "cosine", "max_epochs": 3},
    "cosine-sgd": {"opt": "sgd", "lr_schedule": "cosine", "max_epochs": 3},
    # The gradients' global norm is 10.2-11.5: one clip acts, one does not.
    "clip-acts": {"max_grad_norm": 1.0},
    "clip-idle": {"max_grad_norm": 100.0},
    "weight-decay": {"weight_decay": 0.1},
    "adamax-decay": {"opt": "adamax", "weight_decay": 0.1},
    "all": {"opt": "adamax", "lr_schedule": "cosine", "max_epochs": 3, "max_grad_norm": 1.0, "weight_decay": 0.1},
}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.normal(size=shapes)).astype(np.float32)


def _config(case):
    return {"lr": 0.05, "max_epochs": 10, **CASES[case]}


def _run(config, mask=None):
    """(per-step JAX params, per-step port params, port optimizer, JAX
    state) over STEPS steps of the same gradients. With ``mask`` (a bool
    tree) the JAX chain is inside ``optax.masked`` and the port steps the
    masked-in leaves alone; the masked-out leaves' gradients are zero, as
    under the M-flow split."""
    rng = np.random.default_rng(0)
    params0 = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES, scale=2.0) for _ in range(STEPS)]
    flat_mask = flatten_tree(mask) if mask is not None else {k: True for k in flatten_tree(params0)}
    if mask is not None:
        grads = [jax.tree.map(lambda g, m: g if m else np.zeros_like(g), gs, mask) for gs in grads]

    opt, _ = jax_make_optimizer(config, STEPS_PER_EPOCH, mask=mask)
    params, state = jax.tree.map(jnp.asarray, params0), opt.init(params0)
    update = jax.jit(opt.update)
    want = []
    for g in grads:
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
        want.append(flatten_tree(jax.tree.map(np.asarray, params)))

    tensors = {k: torch.tensor(v, requires_grad=True) for k, v in flatten_tree(params0).items()}
    group = [tensors[k] for k in tensors if flat_mask[k]]
    port = make_optimizer(config, group, STEPS_PER_EPOCH)
    got = []
    for g in grads:
        for k, v in flatten_tree(g).items():
            tensors[k].grad = torch.tensor(v)
        port.step()
        got.append({k: v.detach().numpy().copy() for k, v in tensors.items()})
    return want, got, port, tensors, state


def _assert_close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=RTOL * np.abs(want[k]).max(),
                                   err_msg=f"{what} {k}")


def _adam_state(state):
    """The ScaleByAdamState (adam or adamax) in a JAX chain's state, else None."""
    for leaf in jax.tree.leaves(state, is_leaf=lambda s: hasattr(s, "mu")):
        if hasattr(leaf, "mu"):
            return leaf
    return None


@pytest.mark.parametrize("case", list(CASES))
def test_rule_matches_optax_over_five_steps(case):
    want, got, port, tensors, state = _run(_config(case))
    for s in range(STEPS):
        _assert_close(got[s], want[s], f"step {s + 1}")
    assert int(port.count) == STEPS
    adam = _adam_state(state)
    if adam is None:
        assert port.rule == "sgd" and all(not port.state[p] for p in port.params)
        return
    assert int(adam.count) == STEPS
    names = {id(t): k for k, t in tensors.items()}
    for part in ("mu", "nu"):
        moments = {names[id(p)]: port.state[p][part].numpy() for p in port.params}
        _assert_close(moments, flatten_tree(jax.tree.map(np.asarray, getattr(adam, part))), part)


@pytest.mark.parametrize("case", ["adam", "all"])
def test_group_matches_optax_masked(case):
    """One group's optimizer against the chain inside ``optax.masked``: the
    masked-in leaves follow optax; the masked-out ones, whose gradient is
    zero, keep their value bit for bit in both packages."""
    mask = {"a": True, "b": False, "c": {"w": False, "v": True}}
    want, got, _, _, _ = _run(_config(case), mask=mask)
    flat_mask = flatten_tree(mask)
    start = got[0]  # only for the keys' order
    for s in range(STEPS):
        _assert_close({k: got[s][k] for k in start if flat_mask[k]},
                      {k: want[s][k] for k in start if flat_mask[k]}, f"step {s + 1}")
        for k in start:
            if not flat_mask[k]:
                np.testing.assert_array_equal(got[s][k], want[s][k], err_msg=k)
                np.testing.assert_array_equal(got[s][k], got[0][k], err_msg=k)


def test_cosine_rate_on_the_device_and_on_the_host():
    """The rate a step reads from the group's count, across T and past it,
    against optax's schedule; ``host_rate`` against the JAX package's host
    mirror, which its trainer writes as ``train/lr``."""
    config = _config("cosine")
    port = make_optimizer(config, [torch.zeros(2, requires_grad=True)], STEPS_PER_EPOCH)
    _, jax_host = jax_make_optimizer(config, STEPS_PER_EPOCH)
    schedule = optax.cosine_decay_schedule(init_value=config["lr"], decay_steps=3)
    for c in range(6):
        port.count.fill_(c)
        np.testing.assert_allclose(float(port.rate(port.count)), float(schedule(c)), rtol=RTOL, atol=1e-12)
        assert port.host_rate(c) == jax_host(c)
    assert port.host_rate(0) == config["lr"] and port.host_rate(5) == 0.0
    constant = make_optimizer({"lr": 0.05}, [torch.zeros(2, requires_grad=True)])
    assert float(constant.rate(constant.count)) == np.float32(0.05) and constant.host_rate(9) == 0.05


def test_invalid_settings_raise_as_in_the_jax_package():
    params = [torch.zeros(2, requires_grad=True)]
    with pytest.raises(AssertionError, match="Invalid optimizer"):
        jax_make_optimizer({"lr": 0.1, "opt": "rmsprop"}, 1)
    with pytest.raises(AssertionError, match="Invalid optimizer"):
        make_optimizer({"lr": 0.1, "opt": "rmsprop"}, params)
    cosine = {"lr": 0.1, "lr_schedule": "cosine", "max_epochs": 0}
    with pytest.raises(ValueError, match="decay_steps"):
        jax_make_optimizer(cosine, 4)
    with pytest.raises(ValueError, match="decay steps"):
        make_optimizer(cosine, params, 4)
