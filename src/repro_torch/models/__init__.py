"""Model substrate of the port.  Only the layers the re-ID tower uses have
been carried over; the model zoo waits for its kernels."""

from .layers import init_linear, init_norm, linear, rms_norm

__all__ = ["init_linear", "init_norm", "linear", "rms_norm"]
