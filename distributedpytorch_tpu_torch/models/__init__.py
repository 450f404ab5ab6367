"""Models of the port: cnn, mlp, the torchvision zoo (resnet, alexnet, vgg,
squeezenet, densenet, inception) and vit (with the GPipe vit of
``--pipeline-parallel``, ``vit_pipeline.py``), their registry, the
flax-params converter and the torchvision ``state_dict`` loader of
``--use-pretrained``."""

from .registry import get_model, get_model_input_size  # noqa: F401
