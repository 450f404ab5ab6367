"""Models of the port: vit, its registry, and the flax-params converter."""

from .registry import get_model, get_model_input_size  # noqa: F401
