"""Low-dimensional synthetic manifold datasets (``cmf_tpu/data/two_d.py``,
copied: numpy only, so one name and seed give the same bytes in both
packages).

Contract: reference cmf/datasets/two_d.py:103-891 — same dataset names, same
distributions, same split sizes (train 10k / valid 1k / test 5k), as a
registry of seeded generator functions over ``np.random.Generator``.
"""

import numpy as np

_GENERATORS = {}


def register(*names):
    def deco(f):
        for n in names:
            _GENERATORS[n] = f
        return f

    return deco


def _vonmises(rng, kappa, size, loc=0.0):
    return rng.vonmises(loc, kappa, size)


@register("hemisphere-2-6")
def _hemisphere(rng, size, name):
    """Beta-concentrated hemisphere isometrically embedded in R^6 with uniform
    noise (two_d.py:14-46)."""
    d_prime, d, noise_level = 2, 6, 0.01
    theta1 = rng.beta(5, 5, size) * (np.pi / 2)
    other = rng.uniform(0, np.pi, (size, d_prime - 1))
    x = np.ones((size, d_prime + 1))
    x[:, 0] = np.cos(theta1)
    for i in range(1, d_prime + 1):
        angle_product = np.prod(np.sin(other[:, : i - 1]), axis=1) if i > 1 else 1.0
        x[:, i] = angle_product * (
            np.cos(other[:, i - 1]) if i < d_prime else np.sin(other[:, i - 2])
        )
    q, _ = np.linalg.qr(rng.standard_normal((d, d_prime + 1)))
    data = x @ q.T
    return data + rng.uniform(-noise_level, noise_level, (size, d))


def _sinusoid(rng, size, d_prime, d, sigma_m, noise_level):
    """Latent Gaussian → sinusoidal ambient coords (two_d.py:48-74)."""
    z = rng.normal(0, np.sqrt(sigma_m), (size, d_prime))
    a_j = rng.uniform(3, 4, (d - d_prime, d_prime))
    ambient = np.sin(z @ a_j.T) + rng.uniform(-noise_level, noise_level, (size, d - d_prime))
    return np.hstack([ambient, z])


@register("sinusoid-1-3")
def _sin13(rng, size, name):
    return _sinusoid(rng, size, 1, 3, sigma_m=0.1, noise_level=0.1)


@register("sinusoid-1-6")
def _sin16(rng, size, name):
    return _sinusoid(rng, size, 1, 6, sigma_m=0.1, noise_level=0.1)


@register("river")
def _river(rng, size, name):
    x2 = np.linspace(-2, 2, size)
    x1 = np.sin(4 * x2)
    data = np.stack([x1, x2], 1)
    return data + rng.uniform(-0.02, 0.02, (size, 2))


@register("circles")
def _circles(rng, size, name):
    # sklearn.make_circles(factor=.5, noise=0.08) semantics (two_d.py:120-122)
    # without the dep: equally spaced outer/inner circles, shuffled, gaussian
    # noise, then ×3.
    n_out = size // 2
    n_in = size - n_out
    t_out = np.linspace(0, 2 * np.pi, n_out, endpoint=False)
    t_in = np.linspace(0, 2 * np.pi, n_in, endpoint=False)
    data = np.concatenate(
        [
            np.stack([np.cos(t_out), np.sin(t_out)], 1),
            0.5 * np.stack([np.cos(t_in), np.sin(t_in)], 1),
        ],
        0,
    )
    data = data[rng.permutation(size)]
    return (data + rng.normal(scale=0.08, size=data.shape)) * 3.0


@register("cos")
def _cos(rng, size, name):
    x = rng.random(size) * 5 - 2.5
    return np.stack([x, np.sin(x) * 2.5], 1)


@register("pinwheel")
def _pinwheel(rng, size, name):
    """Five-arm pinwheel (two_d.py:174-191)."""
    radial_std, tangential_std, num_classes, rate = 0.3, 0.1, 5, 0.25
    num_per_class = size // num_classes
    n = num_classes * num_per_class
    rads = np.linspace(0, 2 * np.pi, num_classes, endpoint=False)
    features = rng.standard_normal((n, 2)) * np.array([radial_std, tangential_std])
    features[:, 0] += 1.0
    labels = np.repeat(np.arange(num_classes), num_per_class)
    angles = rads[labels] + rate * np.exp(features[:, 0])
    rotations = np.stack(
        [np.cos(angles), -np.sin(angles), np.sin(angles), np.cos(angles)]
    )
    rotations = np.reshape(rotations.T, (-1, 2, 2))
    data = 2 * np.einsum("ti,tij->tj", features, rotations)[rng.permutation(n)]
    if n < size:  # size not divisible by 5: pad by resampling (reference drops)
        data = np.concatenate([data, data[rng.integers(0, n, size - n)]], 0)
    return data


@register("sawtooth")
def _sawtooth(rng, size, name):
    u = rng.random(size)
    branch = u < 0.5
    x1 = np.where(branch, -1 - np.sqrt(np.abs(1 - 2 * u)), 1 + np.sqrt(np.abs(2 * u - 1)))
    return np.stack([x1, rng.random(size)], 1)


@register("quadspline")
def _quadspline(rng, size, name):
    u = rng.random(size)
    x1 = np.where(u < 0.5, -1 + np.cbrt(2 * u - 1), 1 + np.cbrt(2 * u - 1))
    return np.stack([x1, rng.random(size)], 1)


@register("swissroll")
def _swissroll(rng, size, name):
    # sklearn.make_swiss_roll semantics (two_d.py:117-121) without the dep:
    t = 1.5 * np.pi * (1 + 2 * rng.random(size))
    x = t * np.cos(t)
    y = 21 * rng.random(size)
    z = t * np.sin(t)
    data = np.stack([x, y, z], 1) + rng.normal(scale=1.0, size=(size, 3))
    return data[:, [0, 2]] / 5.0


@register("rings")
def _rings(rng, size, name):
    n4 = n3 = n2 = size // 4
    n1 = size - n4 - n3 - n2
    lin = [np.linspace(0, 2 * np.pi, n, endpoint=False) for n in (n4, n3, n2, n1)]
    xs = np.hstack(
        [np.cos(lin[0]), np.cos(lin[1]) * 0.75, np.cos(lin[2]) * 0.5, np.cos(lin[3]) * 0.25]
    )
    # NOTE: the reference (two_d.py:141) builds circ3_x from linspace4 — a
    # latent bug only visible when n3 != n4; reproduced faithfully above by
    # using lin[1] which equals lin[0] in that case.
    ys = np.hstack(
        [np.sin(lin[0]), np.sin(lin[1]) * 0.75, np.sin(lin[2]) * 0.5, np.sin(lin[3]) * 0.25]
    )
    X = np.stack([xs, ys], 1) * 3.0
    X = X[rng.permutation(size)]
    return X + rng.normal(scale=0.08, size=X.shape)


@register("8gaussians")
def _eight_gaussians(rng, size, name):
    scale = 4.0
    centers = scale * np.array(
        [
            (1, 0), (-1, 0), (0, 1), (0, -1),
            (1 / np.sqrt(2), 1 / np.sqrt(2)), (1 / np.sqrt(2), -1 / np.sqrt(2)),
            (-1 / np.sqrt(2), 1 / np.sqrt(2)), (-1 / np.sqrt(2), -1 / np.sqrt(2)),
        ]
    )
    idx = rng.integers(0, 8, size)
    data = rng.standard_normal((size, 2)) * 0.5 + centers[idx]
    return data / 1.414


@register("2spirals")
def _two_spirals(rng, size, name):
    n = np.sqrt(rng.random((size // 2, 1))) * 540 * (2 * np.pi) / 360
    d1x = -np.cos(n) * n + rng.random((size // 2, 1)) * 0.5
    d1y = np.sin(n) * n + rng.random((size // 2, 1)) * 0.5
    x = np.vstack([np.hstack([d1x, d1y]), np.hstack([-d1x, -d1y])]) / 3
    return x + rng.standard_normal(x.shape) * 0.1


@register("checkerboard")
def _checkerboard(rng, size, name):
    x1 = rng.random(size) * 4 - 2
    x2_ = rng.random(size) - rng.integers(0, 2, size) * 2
    x2 = x2_ + (np.floor(x1) % 2)
    return np.stack([x1, x2], 1) * 2


@register("fuzzy-line")
def _fuzzy_line(rng, size, name):
    x = rng.random(size) * 5 - 2.5
    data = np.stack([x, x], 1)
    noise = rng.random(size) * 0.5
    return data + np.stack([noise, -noise], 1)


@register("pure-line")
def _pure_line(rng, size, name):
    x = rng.random(size) * 5 - 2.5
    return np.stack([x, x], 1)


@register("linein3d")
def _line_in_3d(rng, size, name):
    x = rng.random(size) * 5 - 2.5
    data = np.stack([x, x, np.zeros_like(x)], 1)
    noise = rng.random(size) * 0.5
    return data + np.stack([noise, -noise, np.zeros_like(noise)], 1)


@register("3d-line")
def _three_d_line(rng, size, name):
    x = rng.random(size) * 5 - 2.5
    data = np.stack([x, x, 2 * x], 1)
    noise = rng.random(size) * 0.5
    return data + np.stack([noise, noise, -noise], 1)


@register("shifted-line")
def _shifted_line(rng, size, name):
    x = rng.random(size) * 5 + 2.5
    data = np.stack([x, x], 1)
    noise = rng.random(size) * 0.5
    return data + np.stack([noise, -noise], 1)


@register("box")
def _box(rng, size, name):
    return np.stack([rng.random(size) * 5 - 2.5, rng.random(size) * 5 - 2.5], 1)


@register("vertical-line")
def _vertical_line(rng, size, name):
    return np.stack([rng.random(size) * 0.1 - 0.05, rng.random(size) * 5 - 2.5], 1)


@register("cross")
def _cross(rng, size, name):
    x1 = rng.random(size) * 5 - 2.5
    x2 = np.empty(size)
    x2[: size // 2] = x1[: size // 2]
    x2[size // 2 :] = -x1[size // 2 :]
    data = np.stack([x1, x2], 1)
    return data[rng.permutation(size)]


@register("2uniforms")
def _two_uniforms(rng, size, name):
    mixture = (rng.random(size) > 0.5).astype(int)
    x1 = rng.random(size) + mixture - 2 * (1 - mixture)
    x2 = 2 * (rng.random(size) - 0.5)
    return np.stack([x1, x2], 1)


@register("2lines")
def _two_lines(rng, size, name):
    x1 = np.empty(size)
    x1[: size // 2] = -1.0
    x1[size // 2 :] = 1.0
    x1 += 0.01 * (rng.random(size) - 0.5)
    x2 = 2 * (rng.random(size) - 0.5)
    return np.stack([x1, x2], 1)[rng.permutation(size)]


@register("2marginals")
def _two_marginals(rng, size, name):
    x1 = np.empty(size)
    x1[: size // 2] = -1.0
    x1[size // 2 :] = 1.0
    x1 += 0.5 * (rng.random(size) - 0.5)
    x2 = rng.standard_normal(size)
    return np.stack([x1, x2], 1)[rng.permutation(size)]


@register("1uniform")
def _one_uniform(rng, size, name):
    return np.stack([rng.random(size) - 0.5, rng.random(size) - 0.5], 1)


@register("annulus")
def _annulus(rng, size, name):
    rad1, rad2 = 2, 1
    theta = 2 * np.pi * rng.random(size)
    r = np.sqrt(rng.random(size) * (rad1**2 - rad2**2) + rad2**2)
    return np.stack([r * np.cos(theta), r * np.sin(theta)], 1)


@register("ellipse")
def _ellipse(rng, size, name):
    theta = 2 * np.pi * np.linspace(0, 1, size)
    r1 = rng.random(size) * 2
    r2 = rng.random(size) * 1
    phi = np.pi / 4
    x1 = r1 * np.cos(theta) * np.cos(phi) - r2 * np.sin(theta) * np.sin(phi)
    x2 = r1 * np.cos(theta) * np.sin(phi) + r2 * np.sin(theta) * np.cos(phi)
    return np.stack([x1, x2], 1)


@register("2ellipses")
def _two_ellipses(rng, size, name):
    half = size // 2
    theta = 2 * np.pi * np.linspace(0, 1, half)
    x1 = np.empty(size)
    x2 = np.empty(size)
    rA1 = rng.random(half) * 2
    rA2 = rng.random(half) * 0.2
    rB1 = rng.random(half) * 2
    rB2 = rng.random(half) * 0.2
    phiA, phiB = np.pi / 2, np.pi / 6
    x1[:half] = rA1 * np.cos(theta) * np.cos(phiA) - rA2 * np.sin(theta) * np.sin(phiA)
    x2[:half] = rA1 * np.cos(theta) * np.sin(phiA) + rA2 * np.sin(theta) * np.cos(phiA)
    x1[half:] = rB1 * np.cos(theta) * np.cos(phiB) - rB2 * np.sin(theta) * np.sin(phiB)
    x2[half:] = rB1 * np.cos(theta) * np.sin(phiB) + rB2 * np.sin(theta) * np.cos(phiB)
    return np.stack([x1, x2], 1)


@register("split-gaussian")
def _split_gaussian(rng, size, name):
    x1 = rng.standard_normal(size)
    x2 = rng.standard_normal(size)
    x2[x1 >= 0] += 2
    x2[x1 < 0] -= 2
    return np.stack([x1, x2], 1)


@register("von-mises-circle")
def _von_mises_circle(rng, size, name):
    theta = _vonmises(rng, 1.0, size, loc=np.pi / 2)
    return np.stack([np.cos(theta), np.sin(theta)], 1)


@register("3d-von-mises-circle", "von-mises-sphere")
def _von_mises_sphere(rng, size, name):
    theta = _vonmises(rng, 1.0, size, loc=np.pi / 2)
    phi = _vonmises(rng, 1.0, size, loc=np.pi / 2) / 2
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], 1
    )


def _uniform_sphere_angles(rng, size):
    theta = 2 * np.pi * rng.random(size)
    phi = np.pi * rng.random(size)
    return (
        np.cos(theta) * np.sin(phi),
        np.sin(theta) * np.sin(phi),
        np.cos(phi),
    )


@register("sphere")
def _sphere(rng, size, name):
    return np.stack(_uniform_sphere_angles(rng, size), 1)


@register("offcenter-sphere")
def _offcenter_sphere(rng, size, name):
    return np.stack(_uniform_sphere_angles(rng, size), 1) + 10.0


@register("offcenter-spheres")
def _offcenter_spheres(rng, size, name):
    nA = int(9 * size / 10)
    nB = size - nA  # reference uses int(size/10), exact for its 10k/1k/5k sizes
    a = np.stack(_uniform_sphere_angles(rng, nA), 1) + 10.0
    b = np.stack(_uniform_sphere_angles(rng, nB), 1) - 2.0
    return np.concatenate([a, b], 0)


# Noise levels (σ4, σ5, σ6) for the randomized sphere-in-R6 family
# (two_d.py:434-664); "null6d" zeroes the sphere coordinates themselves.
_S2INR6_NOISE = {
    "randomized-s2inr6": (0.03, 0.03, 0.03),
    "randomized-s2inr6-001": (0.01, 0.01, 0.01),
    "randomized-s2inr6-001-0": (0.01, 0.01, 0.0),
    "randomized-s2inr6-003": (0.03, 0.03, 0.03),
    "randomized-s2inr6-003-0": (0.03, 0.03, 0.0),
    "randomized-s2inr6-003-0015-0": (0.03, 0.015, 0.0),
    "randomized-s2inr6-005": (0.05, 0.05, 0.05),
    "randomized-s2inr6-005-0": (0.05, 0.05, 0.0),
    "randomized-s2inr6-000": (0.0, 0.0, 0.0),
    "null6d": (0.0, 0.0, 0.0),
}


@register(*_S2INR6_NOISE.keys())
def _randomized_s2inr6(rng, size, name):
    s4, s5, s6 = _S2INR6_NOISE[name]
    x1, x2, x3 = _uniform_sphere_angles(rng, size)
    if name == "null6d":
        x1, x2, x3 = 0 * x1, 0 * x2, 0 * x3
    data_s2 = np.stack([x1, x2, x3], 1)
    extra = np.stack(
        [s4 * rng.standard_normal(size), s5 * rng.standard_normal(size)], 1
    )
    if name == "randomized-s2inr6-003-1":
        x6 = np.ones(size)
    else:
        x6 = s6 * rng.standard_normal(size)
    return np.hstack([data_s2, extra, x6[:, None]])


_S2INR6_NOISE["randomized-s2inr6-003-1"] = (0.03, 0.03, None)
_GENERATORS["randomized-s2inr6-003-1"] = _randomized_s2inr6


def _stereographic_up(coords):
    """One 'inverse stereographic' lift step as the reference writes it
    (two_d.py:666-748): x_i ← 2 x_i / (1 + Σ x_j²), new coord 1 − 2/(1+Σx²)."""
    denom = 1 + np.sum(coords**2, axis=1, keepdims=True)
    lifted = coords * 2 / denom
    new = 1 - 2 / denom[:, 0]
    return np.hstack([lifted, new[:, None]])


@register("s4inr6")
def _s4inr6(rng, size, name):
    theta = 2 * np.pi * rng.random(size)
    phi = np.pi * rng.random(size)
    psi = 2 * np.pi * rng.random(size)
    x1 = np.sin(psi) * np.sin(phi) * np.cos(theta)
    x2 = np.sin(psi) * np.sin(phi) * np.sin(theta)
    x3 = np.sin(psi) * np.cos(phi)
    x4 = np.cos(psi)
    data = np.stack([x1, x2, x3, x4], 1)
    data = _stereographic_up(data)
    return _stereographic_up(data)


@register("s2inr6")
def _s2inr6(rng, size, name):
    data = np.stack(_uniform_sphere_angles(rng, size), 1)
    data = _stereographic_up(data)
    data = _stereographic_up(data)
    return _stereographic_up(data)


@register("trivial-s2inr6")
def _trivial_s2inr6(rng, size, name):
    data = np.stack(_uniform_sphere_angles(rng, size), 1)
    return np.hstack([data, np.zeros((size, 3))])


@register("trivial-s2inr4")
def _trivial_s2inr4(rng, size, name):
    data = np.stack(_uniform_sphere_angles(rng, size), 1)
    return np.hstack([data, np.zeros((size, 1))])


@register("randomized-s2inr4")
def _randomized_s2inr4(rng, size, name):
    data = np.stack(_uniform_sphere_angles(rng, size), 1)
    return np.hstack([data, 0.02 * rng.standard_normal((size, 1))])


@register("fuzzy-line-in-r4")
def _fuzzy_line_r4(rng, size, name):
    t = np.linspace(-1, 1, size)
    data_2d = np.stack([t, 0.1 * rng.standard_normal(size)], 1)
    return np.hstack([data_2d, np.zeros((size, 2))])


@register("4d-fuzzy-line-in-r4")
def _fuzzy_line_4d(rng, size, name):
    t = np.linspace(-1, 1, size)
    return np.stack(
        [t] + [0.1 * rng.standard_normal(size) for _ in range(3)], 1
    )


@register("hyperboloid")
def _hyperboloid(rng, size, name):
    v = np.linspace(-0.75, 0.75, size)
    theta = 2 * np.pi * rng.random(size)
    return np.stack(
        [np.cosh(v) * np.cos(theta), np.cosh(v) * np.sin(theta), np.sinh(v)], 1
    )


@register("torus")
def _torus(rng, size, name):
    R, r = 1.0, 0.1
    theta = 2 * np.pi * np.linspace(0, 1, size)
    phi = 2 * np.pi * rng.random(size)
    return np.stack(
        [
            (R + r * np.cos(theta)) * np.cos(phi),
            (R + r * np.cos(theta)) * np.sin(phi),
            r * np.sin(theta),
        ],
        1,
    )


@register("moebius")
def _moebius(rng, size, name):
    R, w, n = 1.0, 0.2, 1
    v = w * rng.random(size) - w / 2.0
    theta = 2 * np.pi * rng.random(size)
    return np.stack(
        [
            (R + (v / 2) * np.cos(n * theta / 2)) * np.cos(theta),
            (R + (v / 2) * np.cos(n * theta / 2)) * np.sin(theta),
            (v / 2) * np.sin(n * theta / 2),
        ],
        1,
    )


@register("sin-wave-mixture")
def _sin_wave_mixture(rng, size, name):
    theta_1 = 1.5 * rng.standard_normal(size) - 3 * np.pi / 2
    theta_2 = 1.5 * rng.standard_normal(size) + np.pi / 2
    mix = rng.random(size) < 0.5
    x1 = mix * theta_1 + ~mix * theta_2
    return np.stack([x1, np.sin(x1)], 1)


# One example's width of every registered name that is not 2, so that a
# caller can choose by shape without generating rows.
_WIDTHS = {
    **dict.fromkeys(("sinusoid-1-3", "linein3d", "3d-line", "3d-von-mises-circle", "von-mises-sphere",
                     "sphere", "offcenter-sphere", "offcenter-spheres", "hyperboloid", "torus",
                     "moebius"), 3),
    **dict.fromkeys(("trivial-s2inr4", "randomized-s2inr4", "fuzzy-line-in-r4",
                     "4d-fuzzy-line-in-r4"), 4),
    **dict.fromkeys(("hemisphere-2-6", "sinusoid-1-6", "s4inr6", "s2inr6", "trivial-s2inr6",
                     *_S2INR6_NOISE), 6),
}


def data_width(name):
    """One example's width (D) of dataset ``name``."""
    if name not in _GENERATORS:
        raise AssertionError(f"Unknown dataset `{name}'")
    return _WIDTHS.get(name, 2)


def get_2d_data(name, size, seed=0):
    """Generate ``size`` samples of dataset ``name`` as float32 (N, D)."""
    if name not in _GENERATORS:
        raise AssertionError(f"Unknown dataset `{name}'")
    rng = np.random.default_rng(seed)
    return _GENERATORS[name](rng, size, name).astype(np.float32)


def get_2d_datasets(name, seed=0):
    """Train/valid/test arrays with the reference's split sizes
    (two_d.py:887-891)."""
    return (
        get_2d_data(name, 10000, seed=seed),
        get_2d_data(name, 1000, seed=seed + 1),
        get_2d_data(name, 5000, seed=seed + 2),
    )
