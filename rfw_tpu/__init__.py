"""rfw_tpu — a JAX path-tracing framework.

A ground-up rebuild of the capabilities of MeirBon/rendering-fw on
JAX/XLA/Pallas, run on NVIDIA GPUs (tests on the CPU). See ARCHITECTURE.md for the layer map and design decisions.
"""

from .camera import Camera, CameraView
from .config import DEFAULT_CONFIG, RenderConfig

__version__ = "0.1.0"

__all__ = ["Camera", "CameraView", "RenderConfig", "DEFAULT_CONFIG"]


def __getattr__(name):
    # Lazy imports keep `import rfw_tpu` light (no jax import until used).
    if name == "RenderSystem":
        from .system import RenderSystem
        return RenderSystem
    if name == "scene":
        from . import scene
        return scene
    raise AttributeError(f"module 'rfw_tpu' has no attribute {name!r}")
