"""Couplers: networks producing (shift, log_scale) pairs
(``cmf_tpu/couplers.py`` in torch)."""

from torch import nn


class IndependentCoupler(nn.Module):
    """Separate shift and log-scale nets (couplers.py:6-24)."""

    def __init__(self, shift_net, log_scale_net):
        super().__init__()
        self.shift = shift_net
        self.log_scale = log_scale_net

    def forward(self, inputs):
        return self.shift(inputs), self.log_scale(inputs)


class ChunkedSharedCoupler(nn.Module):
    """One net; the first half of its output channels is the shift, the
    second half the log-scale (couplers.py:27-60)."""

    def __init__(self, shift_log_scale_net):
        super().__init__()
        self.net = shift_log_scale_net

    def forward(self, inputs):
        out = self.net(inputs)
        c = out.shape[1]
        assert c % 2 == 0
        return out[:, : c // 2], out[:, c // 2 :]


class IndexedSharedCoupler(nn.Module):
    """One net emitting (B, 2, D): head 0 is the shift, head 1 the
    log-scale; MADE's coupler (couplers.py:54-68)."""

    def __init__(self, shift_log_scale_net):
        super().__init__()
        self.net = shift_log_scale_net

    def forward(self, inputs):
        out = self.net(inputs)
        assert out.dim() > 2 and out.shape[1] == 2
        return out[:, 0], out[:, 1]
