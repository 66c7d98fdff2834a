"""Metric-tensor analysis of a trained non-square flow, its numeric part
(``cmf_tpu/viz/metric_analysis.py`` in torch): the decoder Jacobian and its
metric g = JᵀJ at latents, the g_kk and latent-variance sorts, MACS (the mean
absolute cosine similarity of the Jacobian's columns, the CMF-vs-RNF
battery's headline number), the canonical-metric summary, the per-latent-row
invariants with the Vietoris–Rips Betti numbers of the decoded points, and
the 4-D / 6-D visualiser that writes them.

The Jacobian is a ``torch.func.jvp`` of the flat decode under
``torch.func.vmap`` over the d basis tangents, as the head's generic exact
path computes it, in fp32 (TF32 off on the card, ``device.pin_fp32``); no
function here records a gradient.
Matplotlib is imported only inside the calls that draw. The image analyses
(``ImageMetricDensityVisualizer``, the prominent-z sweeps, the per-dimension
FID, ``ImageCenteringDensityVisualizer``) wait for ROADMAP module 9.
"""

import numpy as np
import torch

from .visualizer import _device, _keeps_nothing, _pyplot


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
    var = torch.var(density.extract_latent(x), dim=0, unbiased=False)
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
