"""The one place that chooses the device path.

Every dispatch between a hand-written GPU kernel and its plain XLA
reference asks `kernel_route()`:

- ``"gpu"`` on a CUDA backend: the Pallas (Triton) kernels run, compiled
  for the card.  A kernel that fails to compile raises; nothing falls back
  to interpret mode or to the XLA reference.
- ``"xla"`` on the CPU: the plain XLA reference runs (tests use the
  kernels in interpret mode explicitly).

Any other backend is an error rather than a silent default.  Setting
LOCITYPER_KERNEL_ROUTE=xla runs the XLA references on the GPU too (for
end-to-end comparisons of the kernels with them).
"""
from __future__ import annotations

import os

import jax

ROUTES = {"gpu": "gpu", "cpu": "xla"}
ROUTE_ENV = "LOCITYPER_KERNEL_ROUTE"


def kernel_route() -> str:
    """"gpu" on a CUDA backend, "xla" on the CPU; raises otherwise."""
    backend = jax.default_backend()
    try:
        route = ROUTES[backend]
    except KeyError:
        raise RuntimeError(
            f"unsupported JAX backend {backend!r}: locityper runs on an "
            f"NVIDIA GPU (CUDA) or on the CPU") from None
    forced = os.environ.get(ROUTE_ENV)
    if forced:
        if forced not in ("xla", route):
            raise RuntimeError(f"{ROUTE_ENV}={forced!r} is not available "
                               f"on the {backend} backend")
        return forced
    return route
