"""cmf_tpu_torch: canonical manifold flows in PyTorch, for one NVIDIA H100.

The port of ``cmf_tpu`` (JAX) to PyTorch and hand-written CUDA kernels. It
imports ``torch``, ``numpy``, ``scipy`` (the FID's matrix square root, the
svhn reader, the 2-D visualiser's von Mises curve) and the standard
library, with ``matplotlib`` (the visualisers) and ``torchvision`` (its InceptionV3 weights, omniglot and
celeba) inside the calls that need them: nothing of JAX and nothing of
``cmf_tpu``. Where it needs one of ``cmf_tpu``'s pure-Python
modules (config DSL, schemas, synthetic and 2-D zoo data, objective schedule) it keeps its
own copy, held equal to the original by ``tests/test_torch_*.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--device cpu`` on the CLI); see ``device.resolve_device``.
"""
