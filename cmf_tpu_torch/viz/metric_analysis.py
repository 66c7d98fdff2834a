"""Metric-tensor analysis of a trained non-square flow
(``cmf_tpu/viz/metric_analysis.py`` in torch): the decoder Jacobian and its
metric g = JᵀJ at latents, the g_kk and latent-variance sorts, MACS (the mean
absolute cosine similarity of the Jacobian's columns, the CMF-vs-RNF
battery's headline number), the canonical-metric summary, the per-latent-row
invariants with the Vietoris–Rips Betti numbers of the decoded points, and
the 4-D / 6-D visualiser that writes them. The image half: the prominent-z
sweeps and the cumulative, combined and hierarchical prominent-z grids, the
per-dimension FID, the effective-z reconstruction and FID curves, and the
image metric and centering visualisers.

The Jacobian is a ``torch.func.jvp`` of the flat decode under
``torch.func.vmap`` over the d basis tangents, as the head's generic exact
path computes it, in fp32 (TF32 off on the card, ``device.pin_fp32``), under
``torch.no_grad()``: on an image model the ResNet couplers take the conv
modules there (``torch.func.jvp`` leaves inference mode, and the coupler
kernel, which has no forward-mode rule, raises on a tensor with a tangent).
Every other encode, decode and fixed sample runs under
``torch.inference_mode()``, which routes each ResNet coupler through the
coupler kernel (``nets/core.py``); its results are cloned out of inference
mode, so the Jacobian may take them. No function here records a gradient.

Each function returns numbers (arrays, dicts); the visualisers draw them.
Matplotlib is imported only inside the calls that draw. The JAX package
draws the prominent-z latents from ``PRNGKey(14545)`` and the per-dimension
FID's from its ``rng``; the port cannot reproduce threefry, so each function
takes its draw as an argument, and the visualiser draws it from a CPU
``torch.Generator`` seeded with 14545 (``prominent_z_noise``), the same
draw on every device.
"""

import json
import os

import numpy as np
import torch

from ..eval.fid import activation_statistics, frechet_distance
from .visualizer import _device, _keeps_nothing, _pyplot

# The JAX package's key for the prominent-z draws (metric_analysis.py:199).
PROMINENT_Z_SEED = 14545


def encode(density, x):
    """``density.extract_latent(x)`` under inference mode (the coupler
    kernel), as a tensor outside it."""
    with torch.inference_mode():
        z = density.extract_latent(x)
    return z.clone()


def decode(density, z):
    """``density.decode(z)`` under inference mode (the coupler kernel), as a
    tensor outside it."""
    with torch.inference_mode():
        x = density.decode(z)
    return x.clone()


def fixed_sample(density, noise):
    """``density.fixed_sample(noise)`` (under inference mode: the coupler
    kernel), as a tensor outside it."""
    return density.fixed_sample(noise).clone()


def _flat_decode(density):
    return lambda u: density.decode(u).reshape(u.shape[0], -1)


@torch.no_grad()
def decoder_jacobian(density, z):
    """(B, D, d) Jacobian of the decoder at latents ``z`` (B, d)."""
    batch, d = z.shape
    decode_flat = _flat_decode(density)
    basis = torch.eye(d, dtype=z.dtype, device=z.device)
    cols = torch.func.vmap(
        lambda e: torch.func.jvp(decode_flat, (z,), (e.expand(batch, d),))[1]
    )(basis)  # (d, B, D)
    return cols.permute(1, 2, 0)


def _gram(jac):
    return torch.einsum("bDi,bDj->bij", jac, jac)


def metric_tensor(density, z):
    """g = JᵀJ, (B, d, d)."""
    return _gram(decoder_jacobian(density, z))


def _descending(values):
    """The order that sorts ``values`` from the largest, ties in index
    order (``jnp.argsort`` of the negated values is stable)."""
    return torch.argsort(-values, stable=True)


@torch.no_grad()
def g_kk_sort(density, z):
    """The batch mean of diag(g), sorted from the largest, with its order
    (metric_analysis.py:46-52)."""
    g_kk = torch.diagonal(metric_tensor(density, z), dim1=-2, dim2=-1).mean(dim=0)
    order = _descending(g_kk)
    return g_kk[order].cpu().numpy(), order.cpu().numpy()


@torch.no_grad()
def latent_variance_sort(density, x):
    """The latent coordinates' variances sorted from the largest, their
    order and cumulative fractions (metric_analysis.py:55-63)."""
    var = torch.var(encode(density, x), dim=0, unbiased=False)
    order = _descending(var)
    var_sorted = var[order]
    cumfrac = torch.cumsum(var_sorted, dim=0) / var_sorted.sum()
    return var_sorted.cpu().numpy(), order.cpu().numpy(), cumfrac.cpu().numpy()


def _abs_cos(jac):
    """|cos| between the Jacobian's columns, (B, d, d), and the mean of its
    off-diagonal entries an example, (B,)."""
    jn = jac / (torch.linalg.vector_norm(jac, dim=1, keepdim=True) + 1e-12)
    cos = torch.einsum("bDi,bDj->bij", jn, jn).abs()
    d = cos.shape[-1]
    off = cos * (1 - torch.eye(d, dtype=cos.dtype, device=cos.device))
    return cos, off.sum(dim=(1, 2)) / (d * (d - 1))


@torch.no_grad()
def macs(density, z):
    """(MACS, the batch mean of |cos| (d, d)) (metric_analysis.py:66-77):
    lower is more canonical."""
    cos, per_example = _abs_cos(decoder_jacobian(density, z))
    return float(per_example.mean()), cos.mean(dim=0).cpu().numpy()


@torch.no_grad()
def canonical_metric_summary(density, x, max_points=256, var_threshold=0.95):
    """The CMF-vs-RNF battery's scalars (metric_analysis.py:80-133) of the
    first ``max_points`` rows of ``x``: ``macs``, ``g_diag_dominance``
    (mean |g_ii| / Σ_j |g_ij|), ``g_offdiag_ratio`` (off-diagonal over
    diagonal mass), and the latent axes needed for ``var_threshold`` of the
    cumulative latent variance (``effective_dim_variance``) and of the
    sorted g_kk mass (``effective_dim_gkk``)."""
    x = x[:max_points]
    z = density.extract_latent(x)
    jac = decoder_jacobian(density, z)
    _, per_example = _abs_cos(jac)
    g = _gram(jac)
    diag = torch.diagonal(g, dim1=-2, dim2=-1).abs()
    row_abs = g.abs().sum(dim=-1)
    diag_dominance = float((diag / (row_abs + 1e-12)).mean())
    offdiag_ratio = float(((row_abs - diag).sum(dim=-1) / (diag.sum(dim=-1) + 1e-12)).mean())

    g_kk = np.sort(diag.mean(dim=0).cpu().numpy().astype(np.float64))[::-1]
    g_cum = np.cumsum(g_kk) / max(g_kk.sum(), 1e-30)
    _, _, cumfrac = latent_variance_sort(density, x)
    return {
        "macs": float(per_example.mean()),
        "g_diag_dominance": diag_dominance,
        "g_offdiag_ratio": offdiag_ratio,
        "effective_dim_variance": int(np.searchsorted(cumfrac, var_threshold) + 1),
        "effective_dim_gkk": int(np.searchsorted(g_cum, var_threshold) + 1),
    }


def rips_betti(points, max_points=256, scale=1.0):
    """(b0, b1) of the Vietoris–Rips complex of the first ``max_points``
    points (metric_analysis.py:349-391), numpy: ε is ``scale`` × twice the
    median nearest-neighbour distance; b0 by union-find over the ε-edges,
    b1 = b0 − V + E − T from the clique complex cut at triangles."""
    pts = np.asarray(points)[:max_points].reshape(len(points[:max_points]), -1)
    n = len(pts)
    d2 = np.sum((pts[:, None] - pts[None]) ** 2, axis=-1)
    nn = np.sqrt(np.partition(d2 + np.eye(n) * 1e18, 1, axis=1)[:, 1])
    eps = scale * np.median(nn) * 2.0
    adj = (np.sqrt(d2) <= eps) & ~np.eye(n, dtype=bool)

    parent = np.arange(n)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    edges = 0
    for i in range(n):
        for j in range(i + 1, n):
            if adj[i, j]:
                edges += 1
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
    b0 = len({find(i) for i in range(n)})
    adj_f = adj.astype(np.float64)
    triangles = int(round(np.trace(adj_f @ adj_f @ adj_f) / 6.0))
    b1 = max(0, b0 - n + edges - triangles)
    return b0, b1


@torch.no_grad()
def per_z_invariants(density, z_rows, labels=None):
    """For each (B, d) latent row (metric_analysis.py:394-416): the mean of
    sign·det g ("winding"), Σ sign det g ("degree"), the mean √det g, the
    mean rank of g (eigenvalues above 1e-6 of the largest), the mean trace
    of g, and the Rips b0, b1 of the decoded row."""
    out = []
    for row_idx, zs in enumerate(z_rows):
        g = metric_tensor(density, zs)
        sign, logdet = torch.linalg.slogdet(g)
        eig = torch.linalg.eigvalsh(g)
        rank = (eig > 1e-6 * eig.max(dim=1, keepdim=True).values).sum(dim=1).to(g.dtype)
        b0, b1 = rips_betti(density.decode(zs).cpu().numpy())
        out.append({
            "label": labels[row_idx] if labels else f"row{row_idx}",
            "winding": float((sign * torch.exp(logdet)).mean()),
            "degree": float(sign.sum()),
            "volume_distortion": float(torch.exp(0.5 * logdet).mean()),
            "metric_rank": float(rank.mean()),
            "curvature": float(torch.diagonal(g, dim1=-2, dim2=-1).sum(dim=-1).mean()),
            "rips_b0": b0,
            "rips_b1": b1,
        })
    return out


@torch.no_grad()
def volume_distortion(density, z):
    """√det(JᵀJ) an example (metric_analysis.py:518-523)."""
    _, logdet = torch.linalg.slogdet(metric_tensor(density, z))
    return torch.exp(0.5 * logdet).cpu().numpy()


def winding_number(curve_xy):
    """Turns of a planar curve around the origin (metric_analysis.py:526-530)."""
    theta = np.unwrap(np.arctan2(curve_xy[:, 1], curve_xy[:, 0]))
    return float((theta[-1] - theta[0]) / (2 * np.pi))


def discrete_curvature(curve):
    """Turning angle per unit length of a polyline (metric_analysis.py:533-541)."""
    d1 = np.diff(curve, axis=0)
    seg = np.linalg.norm(d1, axis=1) + 1e-12
    t = d1 / seg[:, None]
    cos_angles = np.clip(np.sum(t[1:] * t[:-1], axis=1), -1, 1)
    return float(np.sum(np.arccos(cos_angles)) / np.sum(seg))


class HighDimensionalNonSquareVisualizer:
    """4-D and 6-D ambient diagnostics (metric_analysis.py:544-622):
    coordinate-pair projections of data against samples, the mean |J| and
    |cos| heatmaps with the MACS scalar, and the invariants (volume
    distortion, each of the first three latent axes' sweep's winding and
    curvature, then ``per_z_invariants``) as JSON. The samples are the
    port's own draws, from a generator seeded with the epoch (the JAX
    package draws them with ``PRNGKey(epoch)``)."""

    def __init__(self, writer, x_train, num_elbo_samples=1, max_points=1000):
        self._writer = writer
        self._x = np.asarray(x_train)[:max_points]
        self._num_elbo_samples = num_elbo_samples

    @torch.no_grad()
    def visualize(self, density, epoch, write_folder=None):
        if _keeps_nothing(self._writer, write_folder):
            return
        plt = _pyplot()
        dev = _device(density)
        z = density.extract_latent(torch.as_tensor(self._x, device=dev))
        gen = torch.Generator(device=dev).manual_seed(epoch)
        samples = density.sample(self._x.shape[0], generator=gen).cpu().numpy()

        big_d = self._x.shape[1]
        pairs = [(i, i + 1) for i in range(0, big_d - 1, 2)][:3]
        fig, axes = plt.subplots(1, len(pairs), figsize=(5 * len(pairs), 4))
        if len(pairs) == 1:
            axes = [axes]
        for ax, (i, j) in zip(axes, pairs):
            ax.scatter(self._x[:, i], self._x[:, j], s=2, alpha=0.4, label="data")
            ax.scatter(samples[:, i], samples[:, j], s=2, alpha=0.4, label="model")
            ax.set_title(f"dims ({i},{j})")
            ax.legend()
        self._writer.write_figure(f"projections_epoch{epoch}", fig, global_step=epoch)
        if write_folder is not None:
            fig.savefig(f"{write_folder}/projections.pdf")
        plt.close(fig)

        jac = decoder_jacobian(density, z[:256])
        mean_abs_jac = jac.abs().mean(dim=0).cpu().numpy()
        macs_value, cos_matrix = macs(density, z[:256])
        self._writer.write_scalar("metric/macs", macs_value, global_step=epoch)

        vol = volume_distortion(density, z[:256])
        mean_z = z.mean(dim=0)
        std_z = z.std(dim=0, unbiased=False)
        invariants = {"volume_distortion_mean": float(np.mean(vol)),
                      "volume_distortion_std": float(np.std(vol)),
                      "macs": macs_value}
        z_rows, row_labels = [], []
        for k in range(min(3, z.shape[1])):
            t = torch.linspace(-2.0, 2.0, 64, device=dev)
            zs = mean_z.repeat(64, 1)
            zs[:, k] = mean_z[k] + t * std_z[k]
            curve = density.decode(zs).cpu().numpy()
            z_rows.append(zs)
            row_labels.append(f"z_{k}")
            invariants[f"axis{k}_winding_xy"] = winding_number(curve[:, :2])
            invariants[f"axis{k}_curvature"] = discrete_curvature(curve)
        self._writer.write_json(f"invariants_epoch{epoch}", invariants)

        battery = per_z_invariants(density, [z[:64]] + z_rows, labels=["z_all"] + row_labels)
        self._writer.write_json(f"topological_battery_epoch{epoch}", battery)

        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        im0 = axes[0].imshow(mean_abs_jac, aspect="auto", cmap="viridis")
        axes[0].set_title("mean |J|")
        fig.colorbar(im0, ax=axes[0])
        im1 = axes[1].imshow(cos_matrix, vmin=0, vmax=1, cmap="magma")
        axes[1].set_title(f"|cos| (MACS={macs_value:.3f})")
        fig.colorbar(im1, ax=axes[1])
        self._writer.write_figure(f"jacobian_epoch{epoch}", fig, global_step=epoch)
        if write_folder is not None:
            fig.savefig(f"{write_folder}/jacobian.pdf")
        plt.close(fig)


# ------------------------------------------------------------ the image half
def _image_grid(images, nrow, pad=1):
    """(N, C, H, W) images as one grid array (H', W', C), each image scaled
    to [0, 1] on its own range, ``nrow`` images a row, one-pixel white gaps
    (metric_analysis.py:249-264)."""
    images = np.asarray(images, dtype=np.float64)
    n, c, h, w = images.shape
    lo = images.reshape(n, -1).min(axis=1)[:, None, None, None]
    hi = images.reshape(n, -1).max(axis=1)[:, None, None, None]
    images = (images - lo) / np.maximum(hi - lo, 1e-12)
    ncol = nrow
    nrows = int(np.ceil(n / ncol))
    grid = np.ones((c, nrows * (h + pad) + pad, ncol * (w + pad) + pad))
    for idx in range(n):
        r, cidx = divmod(idx, ncol)
        y, x = r * (h + pad) + pad, cidx * (w + pad) + pad
        grid[:, y : y + h, x : x + w] = images[idx]
    return np.moveaxis(grid, 0, 2)


def _subgroup_latents(order, d):
    """The latent axes in ``order`` split into min(5, d) prominence
    subgroups, most prominent first (metric_analysis.py:267-271)."""
    order = np.asarray(order)
    return [np.asarray(g) for g in np.array_split(order, min(5, d))]


def _mask(d, dims, device):
    """A (d,) float mask, one on ``dims``."""
    active = torch.zeros(d, device=device)
    active[torch.as_tensor(np.asarray(dims, dtype=np.int64), device=device)] = 1.0
    return active


def prominent_z_noise(order, bs=10, hierarchical_bs=4):
    """The prominent-z grids' draws, each from a CPU generator seeded with
    ``PROMINENT_Z_SEED``, as the JAX package draws each from
    ``PRNGKey(14545)``: (bs, d) normals for the cumulative and the combined
    grid (the same draw), and (2·hierarchical_bs, largest subgroup) for the
    hierarchical one."""
    d = len(order)
    width = max(len(g) for g in _subgroup_latents(order, d))

    def draw(shape):
        return torch.randn(shape, generator=torch.Generator().manual_seed(PROMINENT_Z_SEED))

    return draw((bs, d)), draw((2 * hierarchical_bs, width))


@torch.no_grad()
def prominent_z_sweeps(density, z, order, num_axes=4, steps=7):
    """Decoded sweeps along the ``num_axes`` most prominent latent axes
    (metric_analysis.py:220-233): the latent mean, with axis k moved over
    mean ± 2 std in ``steps`` steps; (num_axes, steps, C, H, W)."""
    mean_z = z.mean(dim=0)
    std_z = z.std(dim=0, unbiased=False)
    sweep = torch.linspace(-2.0, 2.0, steps, device=z.device)
    rows = []
    for k in range(min(num_axes, z.shape[1])):
        axis = int(order[k])
        zs = mean_z.repeat(steps, 1)
        zs[:, axis] = mean_z[axis] + sweep * std_z[axis]
        rows.append(decode(density, zs).cpu().numpy())
    return np.stack(rows)


@torch.no_grad()
def prominent_z_cumulative(density, order, z):
    """The cumulative prominent-z grid (metric_analysis.py:274-286): the
    noise ``z`` (bs, d) with the first 1, 2, ... prominence subgroups
    active and the rest zeroed, through ``fixed_sample``; (images, bs), a
    grid row per level."""
    d = len(order)
    rows, active = [], []
    for g in _subgroup_latents(order, d):
        active = active + list(g)
        rows.append(fixed_sample(density, z * _mask(d, active, z.device)).cpu().numpy())
    return np.concatenate(rows, axis=0), z.shape[0]


@torch.no_grad()
def prominent_z_combined(density, order, z):
    """The combined prominent-z grid (metric_analysis.py:289-316): every
    contiguous range of prominence subgroups active in turn, each row of
    ``fixed_sample`` images followed by an indicator tile that blacks out a
    square for each active axis, at its position in ``order``;
    (images, bs + 1)."""
    d = len(order)
    groups = _subgroup_latents(order, d)
    c, h, w = fixed_sample(density, z[:1]).shape[1:]
    ncols = int(np.ceil(np.sqrt(d)))
    nrows_sq = int(np.ceil(d / ncols))
    sq = max(1, h // max(ncols, nrows_sq))

    rows = []
    for start in range(len(groups)):
        for end in range(start, len(groups)):
            active = np.zeros(d, np.float32)
            for g in groups[start : end + 1]:
                active[g] = 1.0
            imgs = fixed_sample(density, z * torch.as_tensor(active, device=z.device)).cpu().numpy()
            indicator = np.full((1, c, h, w), 255.0, np.float32)
            for pos, dim in enumerate(np.asarray(order)):
                if active[dim]:
                    ii, jj = divmod(pos, ncols)
                    indicator[0, :, ii * sq : ii * sq + sq - 1, jj * sq : jj * sq + sq - 1] = 0.0
            rows.append(np.concatenate([imgs, indicator], axis=0))
    return np.concatenate(rows, axis=0), z.shape[0] + 1


@torch.no_grad()
def prominent_z_hierarchical(density, order, seeds):
    """The hierarchical prominent-z grid (metric_analysis.py:319-346): up to
    4 levels of a binary tree over the top prominence subgroups, level L
    holding bs·2^(L-1) ``fixed_sample`` images whose subgroup values are rows
    of ``seeds`` (2·bs, largest subgroup) picked by the bits of the column
    index, centred between white tiles; (images, bs·2^(levels-1))."""
    d = len(order)
    groups = _subgroup_latents(order, d)
    k_levels = min(4, len(groups))
    seeds = seeds.cpu().numpy()
    bs = seeds.shape[0] // 2
    dev = _device(density)

    probe = fixed_sample(density, torch.zeros((1, d), device=dev))
    blank = np.full((1,) + tuple(probe.shape[1:]), 255.0, np.float32)
    full_cols = bs * 2 ** (k_levels - 1)

    level_rows = []
    for level in range(1, k_levels + 1):
        n = bs * 2 ** (level - 1)
        z = np.zeros((n, d), np.float32)
        for j in range(n):
            for gi in range(level):
                idx = (j >> (level - 1 - gi)) % 2 if gi > 0 else j >> (level - 1)
                g = groups[gi]
                z[j, g] = seeds[idx, : len(g)]
        imgs = fixed_sample(density, torch.as_tensor(z, device=dev)).cpu().numpy()
        pad = (full_cols - n) // 2
        level_rows.append(np.concatenate(
            [np.repeat(blank, pad, 0), imgs, np.repeat(blank, full_cols - n - pad, 0)], axis=0))
    return np.concatenate(level_rows, axis=0), full_cols


@torch.no_grad()
def cumulative_dim_fid(density, x_ref, noise, dims_order, feature_fn=None, batch_size=128):
    """FID against ``x_ref`` of decodes with only the top-k latent axes of
    ``dims_order`` active, k = 1..d (metric_analysis.py:417-455): latents
    drawn from a Gaussian fit of the data's (the encodings of the first 1024
    rows of ``x_ref``), the inactive axes held at the mean. ``noise`` (n, d)
    is the standard-normal draw, taken ``batch_size`` rows a decode, the same
    for every k (the JAX package draws a batch from each split of its
    ``rng``). ``feature_fn=None`` scores raw pixels. A list of d FIDs."""
    dev = _device(density)
    x_ref = torch.as_tensor(x_ref, device=dev)
    noise = torch.as_tensor(noise, device=dev)
    ref_mu, ref_cov = activation_statistics(iter(x_ref.split(batch_size)), feature_fn)
    z_data = encode(density, x_ref[:1024])
    mean_z = z_data.mean(dim=0)
    std_z = z_data.std(dim=0, unbiased=False)
    d = z_data.shape[1]

    curve = []
    for k in range(1, d + 1):
        active = _mask(d, dims_order[:k], dev)

        def batches():
            for eps in noise.split(batch_size):
                z = mean_z + std_z * eps
                yield decode(density, mean_z + (z - mean_z) * active)

        mu, cov = activation_statistics(batches(), feature_fn)
        curve.append(frechet_distance(ref_mu, ref_cov, mu, cov))
    return curve


@torch.no_grad()
def effective_z_curves(density, x, order, feature_fn=None, num_steps=10):
    """Reconstruction MSE and FID with only the k most prominent latents of
    ``order`` kept (metric_analysis.py:458-482): encode ``x``, zero the other
    axes, decode, score against ``x``; k over about ``num_steps`` steps up to
    d. ({k: mse}, {k: fid}), the payloads of ``test_metric/recon.json`` and
    ``test_metric/fid.json``."""
    z = encode(density, x)
    d = z.shape[1]
    mult = max(1, d // num_steps)
    dims = sorted({min(max(k * mult, 1), d) for k in range(num_steps + 1)})
    ref_mu, ref_cov = activation_statistics(iter([x]), feature_fn)
    order = np.asarray(order)
    recons, fids = {}, {}
    for k in dims:
        xhat = decode(density, z * _mask(d, order[:k], z.device))
        recons[k] = float(torch.mean((x - xhat) ** 2))
        mu, cov = activation_statistics(iter([xhat]), feature_fn)
        fids[k] = float(frechet_distance(ref_mu, ref_cov, mu, cov))
    return recons, fids


@torch.no_grad()
def image_metric_analysis(density, x):
    """What ``ImageMetricDensityVisualizer`` computes at the images ``x``
    before its effective-z curves (metric_analysis.py:143-218), on the
    density's device: the JSON payload (``metric_analysis``: the g_kk and
    latent-variance sorts, the cumulative variance, MACS), the batch-mean
    |cos| matrix, the prominent-z sweeps, and the three prominent-z grids as
    (images, nrow) where ``x`` holds images."""
    z = encode(density, x)
    g_sorted, g_order = g_kk_sort(density, z)
    var_sorted, var_order, cumfrac = latent_variance_sort(density, x)
    macs_value, cos_matrix = macs(density, z)
    out = {
        "metric_analysis": {
            "g_kk_sorted": g_sorted.tolist(),
            "g_kk_order": g_order.tolist(),
            "latent_variance_sorted": var_sorted.tolist(),
            "latent_variance_order": var_order.tolist(),
            "cumulative_variance": cumfrac.tolist(),
            "macs": macs_value,
        },
        "cos_matrix": cos_matrix,
        "sweeps": prominent_z_sweeps(density, z, var_order),
    }
    out["grids"] = {}
    if x.dim() == 4:  # the grids are of images (metric_analysis.py:197-198)
        noise, seeds = (t.to(x.device) for t in prominent_z_noise(var_order))
        out["grids"] = {
            "samples_cumulative": prominent_z_cumulative(density, var_order, noise),
            "samples_sequential": prominent_z_combined(density, var_order, noise),
            "samples_hierarchical": prominent_z_hierarchical(density, var_order, seeds),
        }
    return out


_GRID_TAGS = {
    "samples_cumulative": "prominent_z_cumulative",
    "samples_sequential": "prominent_z_combined",
    "samples_hierarchical": "prominent_z_hierarchical",
}


def _show(ax, image):
    """One (C, H, W) image of [0, 256) values, clipped, in grey."""
    ax.imshow(np.clip(np.moveaxis(image, 0, 2).squeeze(), 0, 256) / 256.0, cmap="gray")
    ax.axis("off")


class ImageMetricDensityVisualizer:
    """The image metric analysis (metric_analysis.py:134-246): the g_kk and
    latent-variance sorts with MACS as ``metric_analysis_epoch<k>`` JSON, the
    ``metric/macs`` scalar and a figure; the prominent-z sweeps; the three
    prominent-z grids; and, with a ``write_folder``, ``metric_analysis.pdf``,
    ``prominent_z.pdf``, ``plotted_samples_prominent_d/samples_*.pdf`` and
    the effective-z curves in ``test_metric/{recon,fid}.json``, scored on
    raw values as the JAX package scores them. On images that FID raises
    ``ValueError`` in both packages, after the figures (ROADMAP §3): the
    one-pass fp32 covariance of decodes from k < d active latents has
    eigenvalues below the 1e-2 jitter ``frechet_distance`` tries last.
    Returns ``image_metric_analysis``'s numbers, with ``recon`` and ``fid``
    where there is a folder."""

    def __init__(self, writer, x_train, max_points=256):
        self._writer = writer
        self._x = np.asarray(x_train)[:max_points]

    def visualize(self, density, epoch, write_folder=None):
        if _keeps_nothing(self._writer, write_folder):
            return None
        plt = _pyplot()
        x = torch.as_tensor(self._x, device=_device(density))
        out = image_metric_analysis(density, x)
        payload = out["metric_analysis"]
        self._writer.write_json(f"metric_analysis_epoch{epoch}", payload)
        self._writer.write_scalar("metric/macs", payload["macs"], global_step=epoch)

        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        axes[0].bar(range(len(payload["g_kk_sorted"])), payload["g_kk_sorted"])
        axes[0].set_title("sorted g_kk")
        axes[1].plot(payload["cumulative_variance"], marker="o")
        axes[1].set_title("cumulative latent variance")
        im = axes[2].imshow(out["cos_matrix"], vmin=0, vmax=1, cmap="magma")
        axes[2].set_title(f"|cos| (MACS={payload['macs']:.3f})")
        fig.colorbar(im, ax=axes[2])
        self._writer.write_figure(f"metric_analysis_epoch{epoch}", fig, global_step=epoch)
        if write_folder is not None:
            fig.savefig(f"{write_folder}/metric_analysis.pdf")
        plt.close(fig)

        rows = out["sweeps"]
        if rows.ndim >= 4:  # images (metric_analysis.py:235)
            num_axes, steps = rows.shape[:2]
            fig, axes = plt.subplots(num_axes, steps, figsize=(2 * steps, 2 * num_axes), squeeze=False)
            for i in range(num_axes):
                for j in range(steps):
                    _show(axes[i, j], rows[i, j])
            self._writer.write_figure(f"prominent_z_epoch{epoch}", fig, global_step=epoch)
            if write_folder is not None:
                fig.savefig(f"{write_folder}/prominent_z.pdf")
            plt.close(fig)

        for name, (imgs, nrow) in out["grids"].items():
            grid = _image_grid(imgs, nrow)
            fig, ax = plt.subplots(figsize=(12, 12 * grid.shape[0] / grid.shape[1]))
            ax.imshow(grid.squeeze() if grid.shape[2] == 1 else grid, cmap="gray")
            ax.set_aspect("auto")
            ax.axis("off")
            self._writer.write_figure(f"{_GRID_TAGS[name]}_epoch{epoch}", fig, global_step=epoch)
            if write_folder is not None:
                savedir = os.path.join(write_folder, "plotted_samples_prominent_d")
                os.makedirs(savedir, exist_ok=True)
                fig.savefig(os.path.join(savedir, f"{name}.pdf"))
            plt.close(fig)

        if write_folder is not None:
            order = payload["latent_variance_order"]
            out["recon"], out["fid"] = effective_z_curves(density, x, order)
            savedir = os.path.join(write_folder, "test_metric")
            os.makedirs(savedir, exist_ok=True)
            for name in ("recon", "fid"):
                with open(os.path.join(savedir, f"{name}.json"), "w") as f:
                    json.dump(out[name], f, indent=4)
        return out


@torch.no_grad()
def centering_recons(density, x):
    """The centering analysis's reconstructions (metric_analysis.py:494-500):
    of the images ``x``, and of ``x`` centred on its mean image and shifted
    by that image's mean; (recon, centred recon) as numpy."""
    recon = decode(density, encode(density, x))
    mean = x.mean(dim=0, keepdim=True)
    recon_c = decode(density, encode(density, x - mean + mean.mean()))
    return recon.cpu().numpy(), recon_c.cpu().numpy()


class ImageCenteringDensityVisualizer:
    """The centering analysis (metric_analysis.py:485-515): inputs, their
    reconstructions and their centred reconstructions in a 3×N figure,
    ``centering_epoch<k>`` and, with a ``write_folder``, ``centering.pdf``.
    Returns (inputs, recon, centred recon)."""

    def __init__(self, writer, x_train, max_points=8):
        self._writer = writer
        self._x = np.asarray(x_train)[:max_points]

    def visualize(self, density, epoch, write_folder=None):
        if _keeps_nothing(self._writer, write_folder):
            return None
        plt = _pyplot()
        recon, recon_c = centering_recons(density, torch.as_tensor(self._x, device=_device(density)))
        n = self._x.shape[0]
        fig, axes = plt.subplots(3, n, figsize=(2 * n, 6), squeeze=False)
        for i in range(n):
            for row, img in enumerate((self._x[i], recon[i], recon_c[i])):
                _show(axes[row, i], img)
        axes[0, 0].set_title("input", loc="left")
        axes[1, 0].set_title("reconstruction", loc="left")
        axes[2, 0].set_title("centered recon", loc="left")
        self._writer.write_figure(f"centering_epoch{epoch}", fig, global_step=epoch)
        if write_folder is not None:
            fig.savefig(f"{write_folder}/centering.pdf")
        plt.close(fig)
        return self._x, recon, recon_c
