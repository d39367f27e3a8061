"""rayforce-tpu: a columnar query engine with the Rayfall language
(capabilities of RayforceDB/rayforce, re-architected for JAX/XLA over
device-resident columns)."""

from .core.builtins import Runtime  # noqa: F401

__version__ = "0.1.0"
