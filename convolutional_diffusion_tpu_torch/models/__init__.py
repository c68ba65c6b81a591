"""The convolutional diffusion backbones (NHWC at the API), counterpart of
`convolutional_diffusion_tpu/models`."""

from .ddim import DiffusionModel
from .embedding import TimeClassEmbedding
from .resnet import MinimalResNet
from .unet import MinimalUNet, UBlock

__all__ = [
    "DiffusionModel",
    "TimeClassEmbedding",
    "MinimalResNet",
    "MinimalUNet",
    "UBlock",
]
