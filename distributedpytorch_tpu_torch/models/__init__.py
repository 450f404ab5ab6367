"""Models of the port: cnn, mlp, resnet and vit, their registry, and the
flax-params converter."""

from .registry import get_model, get_model_input_size  # noqa: F401
