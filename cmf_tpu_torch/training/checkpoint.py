"""A trainer's checkpoint (``cmf_tpu/training/checkpoint.py`` in torch).

A checkpoint holds the epoch and iteration, the density's parameters and
buffers, every optimizer's state (``opt_states``, keyed
``<group>/count`` and ``<group>/<parameter>/<moment>``: the group index
first, so the two optimizers of an M-flow run keep their own counts and
moments), the early-stopping bookkeeping and the state of the trainer's
generator, which draws the FID noise. Its tensors are copied to the host in
one packed transfer per dtype, so saving reads the card once or twice and a
checkpoint loads on any device.

Restoring copies into the tensors that exist. The trainer's CUDA graphs hold
the addresses of the parameters, the buffers and the optimizers' state, and
its non-finite freeze flattens them in a fixed order: ``load_state_dict`` of
a module would put new tensors in their place, and a replay would then train
the old ones.
"""

import torch


def to_host(tensors):
    """Host copies of ``tensors`` (a list), one device-to-host transfer per
    dtype."""
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idxs in by_dtype.values():
        packed = torch.cat([tensors[i].detach().reshape(-1) for i in idxs]).cpu()
        chunks = packed.split([tensors[i].numel() for i in idxs])
        for i, chunk in zip(idxs, chunks):
            out[i] = chunk.view(tensors[i].shape)
    return out


def _named_tensors(trainer):
    """(section, name, tensor) for every tensor a checkpoint holds."""
    named = [("params", n, p) for n, p in trainer.density.named_parameters()]
    named += [("model_state", n, b) for n, b in trainer.density.named_buffers()]
    param_names = {p: n for n, p in trainer.density.named_parameters()}
    for group, optimizer in enumerate(trainer.optimizers):
        named += [("opt_states", f"{group}/{n}", v) for n, v in optimizer.named_tensors(param_names)]
    return named


def make_checkpoint(trainer):
    named = _named_tensors(trainer)
    host = to_host([t for _, _, t in named])
    ckpt = {
        "epoch": int(trainer.epoch),
        "iteration": int(trainer.iteration),
        "params": {},
        "model_state": {},
        "opt_states": {},
        "best_valid_loss": float(trainer.best_valid_loss),
        "num_bad_valid_epochs": int(trainer.num_bad_valid_epochs),
        "rng": None if trainer.generator is None else trainer.generator.get_state(),
    }
    for (section, name, _), value in zip(named, host):
        ckpt[section][name] = value
    return ckpt


def restore_checkpoint(trainer, ckpt):
    """Copy ``ckpt`` into ``trainer``'s tensors in place; every tensor must
    be matched, in shape and dtype."""
    named = _named_tensors(trainer)
    for section in ("params", "model_state", "opt_states"):
        have = {n for s, n, _ in named if s == section}
        saved = set(ckpt[section])
        if have != saved:
            raise KeyError(
                f"checkpoint `{section}' differs: missing {sorted(have - saved)}, "
                f"unexpected {sorted(saved - have)}"
            )
    with torch.no_grad():
        for section, name, t in named:
            value = ckpt[section][name]
            if value.shape != t.shape or value.dtype != t.dtype:
                raise ValueError(
                    f"checkpoint `{section}/{name}': {value.dtype} {tuple(value.shape)} "
                    f"vs {t.dtype} {tuple(t.shape)}"
                )
            t.copy_(value)
    trainer.epoch = ckpt["epoch"]
    trainer.iteration = ckpt["iteration"]
    trainer.best_valid_loss = ckpt["best_valid_loss"]
    trainer.num_bad_valid_epochs = ckpt["num_bad_valid_epochs"]
    if trainer.generator is not None and ckpt["rng"] is not None:
        trainer.generator.set_state(ckpt["rng"])
