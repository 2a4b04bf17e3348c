from ..physics import cloudsc
from .triton_cloudsc import cloudsc_triton

__all__ = ["cloudsc_triton", "step_fn"]


def step_fn(backend: str):
    """The one-step function of an engine: fields, params, ptsphy, config ->
    CloudscOutputs. The driver and the mesh path look it up here at call
    time, so the CPU tests swap in the kernel in interpret mode in one
    place."""
    if backend == "triton":
        return cloudsc_triton
    return cloudsc
