"""Image transforms on the device (the port of ``mmlspark_tpu/opencv``)."""
from .image_transformer import ImageTransformer, ImageSetAugmenter

__all__ = ["ImageTransformer", "ImageSetAugmenter"]
