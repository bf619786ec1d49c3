"""Device (JAX/XLA) kernels of the calling pipeline."""

import functools


def exact_f64(fn):
    """Run ``fn`` inside JAX's x64 scope, so its float64/int64 arrays stay
    float64/int64 on the device — the CNV and SV kernels then compute
    exactly what the host does, without turning x64 on for the whole
    process (the tile kernel and the mesh step keep their explicit int32
    and float32)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        import jax
        with jax.enable_x64(True):
            return fn(*args, **kwargs)
    return wrapped
