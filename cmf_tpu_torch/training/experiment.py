"""Experiment setup and the train, test, OOD and analysis entry points
(``cmf_tpu/training/experiment.py`` in torch).

Setup follows experiment.py:148-302: loaders, schema, density, objective,
optimizer, writer, the visualiser, the validation and test closures, the FID
function (on image data over the features of ``eval/inception.py``) and the
trainer. The optimizers are ``training/optim.py``'s optax chains: two under
the M-flow split (``non_square`` and ``m_flow``), one over the
reconstruction parameters and one over the latent prior's
(``nonsquare_param_groups``, experiment.py:49-87), else one over every
parameter (experiment.py:177-186).

The analyses of a finished run (experiment.py:433-544): ``load_run``, the
image metric analysis (``metric_test_plots``), the centering analysis
(``centering_test_plots``), the two-dim manifold grid
(``visualize_two_dim_manifold``), and ``describe_density`` /
``print_model``. Each restores the run's ``best_valid`` checkpoint, else
``latest``; those that draw need matplotlib, checked before any work.

A config that asks for something this slice does not carry raises
``NotImplementedError`` here, before any work: it is never quietly skipped.
"""

import json
import os
import subprocess
import warnings

import numpy as np
import torch

from .. import viz
from ..config import get_schema
from ..data import get_loaders
from ..data.image import DATASET_SHAPES as IMAGE_SHAPES
from ..data.tabular import DATASET_SHAPES as TABULAR_SHAPES
from ..densities import (
    BijectionDensity,
    DequantizationDensity,
    NonSquareTailDensity,
    PassthroughBeforeEvalDensity,
    SplitDensity,
)
from ..device import pin_fp32, resolve_device
from ..eval.fid import get_fid_function
from ..eval.inception import get_feature_fn
from ..eval.metrics import metrics
from ..models import get_density
from .objectives import get_objective
from .optim import make_optimizer
from .trainer import Trainer
from .writer import DummyWriter, Writer, check_checkpoint_backend

FID_DATASETS = list(IMAGE_SHAPES) + list(TABULAR_SHAPES)


def _later(what):
    return NotImplementedError(f"{what} waits for a later slice of the port")


COUPLER_NETS = ("mlp", "resnet", "glow-cnn", "constant", "identity")
_COUPLER_KEYS = ("coupler", "st_coupler", "p_coupler", "q_coupler")


def _coupler_nets(layer):
    """The net configs of every coupler of a schema layer."""
    for key in _COUPLER_KEYS:
        coupler = layer.get(key)
        if coupler is not None:
            names = ("shift_net", "log_scale_net") if coupler["independent_nets"] else ("shift_log_scale_net",)
            yield from (coupler[n] for n in names)


def check_schema(schema):
    """Raise naming the first layer option or coupler net of ``schema`` that
    waits for a later slice: an ``acl`` layer with u-channels, a net type
    outside ``COUPLER_NETS``, or batch-norm in a non-square model (a
    ``batch-norm`` layer, a ResNet coupler with ``batchnorm`` or a
    GlowCNN): its decode reads the statistics of the encoder's forward
    (``cmf_tpu/densities/nonsquare.py:104-114``), which waits with the rest
    of ROADMAP module 6."""
    types = {layer["type"] for layer in schema}
    non_square = "non-square-head" in types
    if non_square and "batch-norm" in types:
        raise _later("the non-square model with `batch-norm' layers (ROADMAP module 6)")
    for layer in schema:
        ty = layer["type"]
        if ty == "acl" and layer.get("num_u_channels", 0) > 0:
            raise _later("the `acl' layer with u-channels")
        for net in _coupler_nets(layer):
            if net["type"] not in COUPLER_NETS:
                raise _later(f"the `{net['type']}' coupler net")
            batch_norm = net["type"] == "glow-cnn" or (net["type"] == "resnet" and net.get("batchnorm", True))
            if non_square and batch_norm:
                raise _later(f"the non-square model with batch-norm `{net['type']}' couplers (ROADMAP module 6)")


def check_supported(config, write_to_disk=True):
    """Raise for every config entry that asks for what the port lacks."""
    check_schema(get_schema(config))
    if config.get("compute_dtype", "float32") != "float32":
        raise _later(f"compute_dtype `{config['compute_dtype']}' (ROADMAP module 7)")
    if write_to_disk and not config.get("nosave", False):
        check_checkpoint_backend(config.get("checkpoint_backend", "pickle"))
        viz.check_visualizer(config)


def nonsquare_param_groups(density):
    """(reconstruction params, likelihood params) of the M-flow split
    (experiment.py:49-87): the likelihood group is the prior of the
    ``NonSquareTailDensity``, reached through wrappers (``density``), splits
    (``density_1``) and everything else's ``prior``; the reconstruction
    group is every other parameter. Both in ``density.parameters()``
    order."""
    node = density
    while not isinstance(node, NonSquareTailDensity):
        if isinstance(node, DequantizationDensity):
            node = node.density
        elif isinstance(node, SplitDensity):
            node = node.density_1
        elif isinstance(node, BijectionDensity) or hasattr(node, "prior"):
            node = node.prior
        else:
            raise RuntimeError(f"Cannot walk density node {type(node).__name__}")
    likelihood = {id(p) for p in node.prior.parameters()}
    params = list(density.parameters())
    return ([p for p in params if id(p) not in likelihood], [p for p in params if id(p) in likelihood])


def make_optimizers(config, density, steps_per_epoch):
    """The run's optimizers (experiment.py:177-186): the reconstruction and
    the likelihood group under ``non_square`` and ``m_flow``, else one."""
    if config.get("non_square", False) and config.get("m_flow", False):
        groups = nonsquare_param_groups(density)
    else:
        groups = [list(density.parameters())]
    return [make_optimizer(config, params, steps_per_epoch) for params in groups]


def num_params(density):
    return int(sum(p.numel() for p in density.parameters()))


def _zero_losses(density, x, generator=None):
    """The validation loss of a FID dataset (experiment.py:213-215): zero a
    row, made on the host, so reading it reads nothing from the card."""
    return torch.zeros(x.shape[0])


def _zero_test_metrics(density, x, generator=None):
    return {"loss": torch.zeros(x.shape[0])}


def elbo_loss_fns(config):
    """The validation and test closures of a non-square run on data that is
    not a FID dataset (experiment.py:217-231): validation is −elbo of
    ``metrics`` over ``num_valid_elbo_samples``, the head's defaults kept
    (the reconstruction term in); the test is −elbo with no reconstruction
    term, no metric terms and the likelihood at weight 1."""
    num_valid = config["num_valid_elbo_samples"]

    def valid_loss_fn(density, x, generator=None):
        return -metrics(density, x, num_valid, generator=generator)["elbo"]

    def test_metrics_fn(density, x, generator=None):
        info = density.elbo(
            x, train=False, generator=generator, add_reconstruction=False,
            add_diagonal_metric_reg=False, add_offdiagonal_metric_reg=False, likelihood_wt=1.0,
        )
        return {"loss": -info["elbo"]}

    return valid_loss_fn, test_metrics_fn


def square_loss_fns(config):
    """The validation and test closures of a square flow
    (experiment.py:230-238): validation is −log-prob of ``metrics`` over
    ``num_valid_elbo_samples``, the test is ``metrics`` over
    ``num_test_elbo_samples``. On a FID dataset with ``use_fid`` the FID
    takes validation's place."""
    num_valid = config["num_valid_elbo_samples"]
    num_test = config["num_test_elbo_samples"]

    def valid_loss_fn(density, x, generator=None):
        return -metrics(density, x, num_valid, generator=generator)["log-prob"]

    def test_metrics_fn(density, x, generator=None):
        return metrics(density, x, num_test, generator=generator)

    return valid_loss_fn, test_metrics_fn


def _make_writer(config, resume_dir, write_to_disk):
    if write_to_disk and not config.get("nosave", False):
        if resume_dir is None:
            logdir = os.path.join(config.get("logdir_root", "runs"), config["dataset"])
            make_subdir = True
        else:
            logdir = resume_dir
            make_subdir = False
        return Writer(
            logdir=logdir,
            make_subdir=make_subdir,
            tag_group=config["dataset"],
            rundir_tail=config.get("rundir_tail", ""),
            checkpoint_backend=config.get("checkpoint_backend", "pickle"),
        )
    return DummyWriter(logdir=resume_dir)


def setup_experiment(config, resume_dir=None, testing=False, write_to_disk=True, device=None):
    """config → {"density", "trainer", "writer", "visualizer",
    "train_loader", "schema", "device", "config"}. ``device`` is ``None``
    for the card (raises without one) or ``"cpu"``. The weights come from a CPU generator seeded with
    ``config["seed"]``; the train loop's draws (dequantization, Hutchinson
    probes, FID noise) from a generator on ``device`` with the same seed.
    With ``resume_dir`` the writer writes into that run dir, and the
    trainer restores its checkpoints."""
    check_supported(config, write_to_disk=write_to_disk)
    device = resolve_device(device)
    pin_fp32()
    seed = config["seed"]
    train_loader, valid_loader, test_loader = get_loaders(
        config["dataset"],
        config,
        device,
        seed=seed,
        synthetic=config.get("synthetic_data"),
        data_root=config.get("data_root"),
    )
    schema = get_schema(config)
    generator = torch.Generator().manual_seed(seed)
    density = get_density(schema, x_shape=train_loader.x_shape, device=device, generator=generator)
    if isinstance(density, PassthroughBeforeEvalDensity):
        # The stored rows, drawn from the training set as the JAX package
        # draws them (experiment.py:163-170), anew on every setup.
        n = min(density.num_points, train_loader.num_examples)
        idx = np.random.default_rng(seed).permutation(train_loader.num_examples)[:n]
        density.attach_data(torch.as_tensor(train_loader.x[idx], device=device))
    writer = _make_writer(config, resume_dir, write_to_disk)
    visualizer = viz.get_visualizer(config, writer, train_data=train_loader.x)

    # Loss closures (experiment.py:211-238).
    if not config.get("non_square", False):
        valid_loss_fn, test_metrics_fn = square_loss_fns(config)
    elif config["dataset"] in FID_DATASETS:
        valid_loss_fn, test_metrics_fn = _zero_losses, _zero_test_metrics
    else:
        valid_loss_fn, test_metrics_fn = elbo_loss_fns(config)

    fid_function = None
    if config["dataset"] in FID_DATASETS and config.get("use_fid", False):
        loader = test_loader if config.get("use_test_fid", False) else train_loader
        feature_fn = None
        if config["dataset"] in IMAGE_SHAPES:
            feature_fn = get_feature_fn(config, device)
            if feature_fn.extractor_kind == "proxy" and config["early_stopping"] and not testing:
                # FID stands in for the validation loss (experiment.py:241-267).
                warnings.warn(
                    "FID-as-validation is using the random-conv PROXY "
                    "extractor: early stopping / best-checkpoint selection "
                    "will follow a relative tracking signal, not "
                    "published-comparable FID. Provide "
                    "CMF_TPU_INCEPTION_WEIGHTS (or torchvision weights) for "
                    "real-FID model selection.",
                    stacklevel=2,
                )
        fid_function = get_fid_function(config, loader, feature_fn)

    trainer = Trainer(
        density=density,
        objective=get_objective(config),
        optimizers=make_optimizers(config, density, max(len(train_loader), 1)),
        train_loader=train_loader,
        max_epochs=config["max_epochs"],
        generator=torch.Generator(device=device).manual_seed(seed),
        valid_loader=valid_loader,
        test_loader=test_loader,
        writer=writer,
        visualizer=visualizer,
        early_stopping=config["early_stopping"],
        max_bad_valid_epochs=config["max_bad_valid_epochs"],
        valid_frequency=2 if config.get("m_flow", False) else 1,
        epochs_per_test=config["epochs_per_test"],
        valid_loss_fn=valid_loss_fn,
        test_metrics_fn=test_metrics_fn,
        fid_function=fid_function,
        should_checkpoint_latest=config.get("should_checkpoint_latest", True),
        should_checkpoint_best_valid=config.get("should_checkpoint_best_valid", True),
        only_testing=testing,
        profile_dir=config.get("profile_dir"),
    )
    return {
        "density": density,
        "trainer": trainer,
        "writer": writer,
        "visualizer": visualizer,
        "train_loader": train_loader,
        "schema": schema,
        "device": device,
        "config": config,
    }


def _build_density(config, device):
    """``config``'s model on ``device`` (``None`` for the card, raising
    without one, or ``"cpu"``), its data shape from the loaders."""
    device = resolve_device(device)
    loaders = get_loaders(config["dataset"], config, device, seed=config["seed"],
                          synthetic=config.get("synthetic_data"), data_root=config.get("data_root"))
    return get_density(get_schema(config), x_shape=loaders[0].x_shape, device=device)


def print_num_params(config, device=None):
    """Print the parameter count of ``config``'s model (experiment.py:549-552)."""
    print(f"Number of parameters: {num_params(_build_density(config, device))}")


def describe_density(density, indent=0):
    """The density tree as the JAX package's ``describe_density`` writes it
    (experiment.py:516-536): each density's class name, its bijection with
    the bijection's parts, then its ``density``, ``density_1``,
    ``density_2`` and ``prior``, indented."""
    pad = "  " * indent
    lines = [f"{pad}{type(density).__name__}"]
    child = getattr(density, "bijection", None)
    if child is not None:
        lines.append(f"{pad}  (bijection): {type(child).__name__}")
        for b in getattr(child, "bijections", None) or []:
            lines.append(f"{pad}    - {type(b).__name__}")
    for attr in ("density", "density_1", "density_2", "prior"):
        child = getattr(density, attr, None)
        if child is not None and hasattr(child, "elbo"):
            lines.append(f"{pad}  ({attr}):")
            lines.append(describe_density(child, indent + 2))
    return "\n".join(lines)


def print_model(config, device=None):
    """Print ``config``'s density tree (experiment.py:539-541)."""
    print(describe_density(_build_density(config, device)))


def _write_run_metadata(writer, config, density):
    writer.write_json("config", {k: v for k, v in config.items()})
    writer.write_json("model", {"num_params": num_params(density), "schema": get_schema(config)})
    try:
        head = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=10
        ).stdout.strip()
        writer.write_textfile("git-head", head)
        diff = subprocess.run(["git", "diff"], capture_output=True, text=True, timeout=10).stdout
        writer.write_textfile("git-diff", diff)
    except Exception:
        pass


def train(config, resume_dir=None, device=None):
    setup = setup_experiment(config, resume_dir=resume_dir, device=device)
    if resume_dir is None:
        _write_run_metadata(setup["writer"], config, setup["density"])
    setup["trainer"].train()
    return setup


def test_and_visualize(config, resume_dir, overwrite=False, test_fid=False, device=None):
    """The test pass of a finished run (experiment.py:333-355): FID on
    50,000 samples, from the ``best_valid`` checkpoint, else ``latest``;
    skipped when ``metrics.json`` exists unless ``overwrite``; the results
    go to ``metrics.json``; then, for image data, the visualiser with the
    run dir as its folder. Returns the setup, with the results under
    ``"results"`` (only those, when skipped)."""
    config = {**config, "num_fid_samples": 50_000}
    if test_fid:
        config["use_test_fid"] = True

    metrics_path = os.path.join(resume_dir, "metrics.json")
    if os.path.exists(metrics_path) and not overwrite:
        print(f"`{metrics_path}' exists; skipping (pass overwrite to rerun)")
        with open(metrics_path) as f:
            return {"results": json.load(f)}

    # The JAX package draws into the run dir after a test of data that is
    # not tabular; a visualiser the port lacks, or matplotlib missing where
    # one draws, raises here, before any work.
    draws = config["dataset"] not in TABULAR_SHAPES
    if draws:
        viz.check_visualizer(config, write_folder=resume_dir)
    setup = setup_experiment(config, resume_dir=resume_dir, testing=True, write_to_disk=False, device=device)
    results = setup["trainer"].test()
    if draws:
        visualizer = viz.get_visualizer(config, DummyWriter(), train_data=setup["train_loader"].x,
                                        write_folder=resume_dir)
        with setup["trainer"].evaluating():
            visualizer.visualize(setup["density"], 0, write_folder=resume_dir)
    with open(metrics_path, "w") as f:
        json.dump(results, f, indent=4)
    setup["results"] = results
    return setup


OOD_MAPPING_TABLE = {
    "mnist": "fashion-mnist",
    "fashion-mnist": "mnist",
    "cifar10": "svhn",
    "svhn": "cifar10",
}


def generate_ood_metrics(config, resume_dir, device=None):
    """The OOD battery's four passes (experiment.py:358-400): the run's
    dataset and its OOD counterpart, each over its train and its test split,
    with the exact log-det and batches of 1000 forced. Each pass dumps
    ``ood_metrics_<split>_<in|out>.npy`` (likelihood, reconstruction error)
    into the run dir and a ``ood_metrics_<dataset>_train=<bool>.json``
    summary. The train loader drops its last partial batch, so a train split
    of fewer than 1000 rows gives no batch and the pass raises, as in the JAX
    package. Returns {(label, split): array}."""
    base = {
        **config,
        "log_jacobian_method": "cholesky",
        "train_batch_size": 1000,
        "valid_batch_size": 1000,
        "test_batch_size": 1000,
    }
    in_dataset = config["dataset"]
    out_dataset = OOD_MAPPING_TABLE[in_dataset]
    results = {}
    for dataset, label in [(in_dataset, "in"), (out_dataset, "out")]:
        for use_train, split in [(True, "train"), (False, "test")]:
            cfg = {**base, "dataset": dataset}
            setup = setup_experiment(cfg, resume_dir=resume_dir, testing=True, write_to_disk=False, device=device)
            trainer = setup["trainer"]
            loader = trainer.train_loader if use_train else trainer.test_loader
            writer = Writer(logdir=resume_dir, make_subdir=False, tee=False)
            trainer.writer = writer
            arr = trainer.test_ood(loader, f"ood_metrics_{split}_{label}")
            results[(label, split)] = arr
            writer.write_json(
                f"ood_metrics_{dataset}_train={use_train}",
                {
                    "likelihood_mean": float(np.nanmean(arr[:, 0])),
                    "reconstruction_error_mean": float(np.nanmean(arr[:, 1])),
                    "n": int(arr.shape[0]),
                },
            )
    return results


def best_stump_accuracy(feat_in, feat_out):
    """The best accuracy of a depth-1 stump (one threshold, either way
    round) that tells ``feat_in`` (label 0) from ``feat_out`` (label 1)."""
    values = np.concatenate([feat_in, feat_out])
    labels = np.concatenate([np.zeros(len(feat_in)), np.ones(len(feat_out))])
    order = np.argsort(values)
    labels = labels[order]
    n = len(labels)
    ones_left = np.cumsum(labels)
    total_ones = ones_left[-1]
    idx = np.arange(1, n + 1)
    acc_a = ((idx - ones_left) + (total_ones - ones_left)) / n
    acc_b = 1 - acc_a
    return float(max(acc_a.max(), acc_b.max()))


def ood_classification(resume_dir):
    """Depth-1 stumps on the likelihood and on the reconstruction error of
    the four dumps (experiment.py:403-431): {"<split>/<feature>": accuracy}."""
    results = {}
    for split in ("train", "test"):
        arr_in = np.load(os.path.join(resume_dir, f"ood_metrics_{split}_in.npy"))
        arr_out = np.load(os.path.join(resume_dir, f"ood_metrics_{split}_out.npy"))
        for j, feature in enumerate(("likelihood", "reconstruction-error")):
            acc = best_stump_accuracy(arr_in[:, j], arr_out[:, j])
            results[f"{split}/{feature}"] = acc
            print(f"OOD classification rate ({split}, {feature}): {acc:.4f}")
    return results


def load_run(resume_dir, device=None):
    """A finished run's config and model, restored from ``best_valid``,
    else ``latest`` (experiment.py:433-446): {"density", "config",
    "trainer"}."""
    with open(os.path.join(resume_dir, "config.json")) as f:
        config = json.load(f)
    setup = setup_experiment(config, resume_dir=resume_dir, testing=True, write_to_disk=False, device=device)
    return {"density": setup["density"], "config": config, "trainer": setup["trainer"]}


def _analyse(config, resume_dir, device):
    """The visualiser of ``config`` run once over the restored run, its
    figures and files into ``resume_dir`` (experiment.py:492-513); returns
    what it returns."""
    viz.check_visualizer(config, write_folder=resume_dir)
    setup = setup_experiment(config, resume_dir=resume_dir, testing=True, write_to_disk=False, device=device)
    visualizer = viz.get_visualizer(config, DummyWriter(), train_data=setup["train_loader"].x,
                                    write_folder=resume_dir)
    with setup["trainer"].evaluating():
        return visualizer.visualize(setup["density"], 0, write_folder=resume_dir)


def metric_test_plots(config, resume_dir, device=None):
    """The image metric analysis of a finished run (experiment.py:492-501):
    ``metric_analysis.pdf``, ``prominent_z.pdf``, the prominent-z grids under
    ``plotted_samples_prominent_d/`` and ``test_metric/{recon,fid}.json``
    in the run dir; returns ``viz.metric_analysis.image_metric_analysis``'s
    numbers."""
    return _analyse({**config, "test_metric": True, "use_fid": False}, resume_dir, device)


def centering_test_plots(config, resume_dir, device=None):
    """The centering analysis of a finished run (experiment.py:504-513):
    ``centering.pdf`` in the run dir; returns (inputs, recon, centred
    recon)."""
    return _analyse({**config, "test_center": True, "use_fid": False}, resume_dir, device)


TWO_DIM_GRID = (8, -3.0, 3.0)  # points a side, low, high


def two_dim_manifold_latents():
    """The 8×8 grid of latents over [-3, 3]², rows from z₂ = 3 down,
    columns from z₁ = -3 (experiment.py:459-467): (64, 2) float32."""
    n_grid, lo, hi = TWO_DIM_GRID
    xv, yv = np.meshgrid(np.linspace(lo, hi, n_grid), np.linspace(hi, lo, n_grid))
    return np.stack([xv.reshape(-1), yv.reshape(-1)], axis=1).astype(np.float32)


def two_dim_manifold_grid(density):
    """The grid's latents decoded under inference mode (the coupler
    kernel): (64, C, H, W) numpy."""
    latents = torch.as_tensor(two_dim_manifold_latents(), device=next(density.parameters()).device)
    with torch.inference_mode():
        return density.decode(latents).cpu().numpy()


def draw_two_dim_manifold(images, path):
    """The grid of ``two_dim_manifold_grid`` as one image over the latent
    square, saved to ``path`` (experiment.py:470-485)."""
    from ..viz.visualizer import _pyplot

    plt = _pyplot()
    n_grid, lo, hi = TWO_DIM_GRID
    c, h, w = images.shape[1:]
    grid_img = (np.clip(images, 0, 256) / 256.0).reshape(n_grid, n_grid, c, h, w)
    grid_img = grid_img.transpose(2, 0, 3, 1, 4).reshape(c, n_grid * h, n_grid * w)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(np.moveaxis(grid_img, 0, 2).squeeze(), cmap="gray" if c == 1 else None,
              extent=[lo, hi, lo, hi])
    ax.set_xlabel("$z_1$")
    ax.set_ylabel("$z_2$")
    fig.savefig(path)
    plt.close(fig)


def visualize_two_dim_manifold(config, resume_dir, device=None):
    """The two-dim manifold of a finished d=2 mnist or fashion-mnist run
    (experiment.py:449-485): ``two_dim_manifold.pdf`` in the run dir;
    returns the decoded (64, C, H, W) grid."""
    assert config["dataset"] in ["mnist", "fashion-mnist"]
    assert config["latent_dimension"] == 2
    viz.require_matplotlib("--two-dim-manifold", "it needs a machine where matplotlib imports")
    config = {**config, "test_metric": False, "use_fid": False}
    setup = setup_experiment(config, resume_dir=resume_dir, testing=True, write_to_disk=False, device=device)
    with setup["trainer"].evaluating():
        images = two_dim_manifold_grid(setup["density"])
    draw_two_dim_manifold(images, os.path.join(resume_dir, "two_dim_manifold.pdf"))
    return images
