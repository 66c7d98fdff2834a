"""The ResNet coupler of one coupling at (B, C_in, C_out, H, W): a 3×3
conv C_in → hidden, ``blocks`` residual blocks of two 3×3 hidden → hidden
convs, a 1×1 conv hidden → C_out and the tanh head, fp32."""

F32 = 4


def launch(b, c_in, c_out, h, w, hidden, blocks):
    """(FLOPs, bytes) of one launch: every conv's multiply-adds once (the
    elementwise work is left out, under 1% of it); the input read, the
    output and every weight read once."""
    pixels = b * h * w
    macs = 9 * c_in * hidden + blocks * 2 * 9 * hidden * hidden + hidden * c_out
    weights = 9 * c_in * hidden + blocks * 2 * (9 * hidden * hidden + hidden) + hidden * c_out + 3 * c_out
    return 2 * pixels * macs, F32 * (pixels * (c_in + c_out) + weights)
