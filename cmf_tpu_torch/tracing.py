"""Named spans of the program's layers on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function("cmf/" + name)`` while a
torch profiler is recording (the CLI's ``--profile-dir`` epoch, a benchmark's
traced stretch), so each span lands in the same Chrome trace as the aten ops
and kernels it covers. With no profiler it is one shared context that does
nothing: a span then costs the gate, one attribute read.
"""

import torch
import torch.autograd.profiler as _profiler


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name):
    """A context manager that marks ``cmf/<name>`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function("cmf/" + name)
    return _OFF
