"""Processor for the port: its own copy of the JAX package's
SpatialVLAProcessor (processor.py, text_tokenizer.py), whose image step is
the jax-free one of image.py."""
from .image import preprocess_image, preprocess_images, preprocess_images_u8, resize_image_u8
from .processor import IGNORE_INDEX, SpatialVLAProcessor, scale_intrinsics
from .text_tokenizer import ByteTokenizer, HFTokenizerAdapter, TextTokenizer, load_text_tokenizer

__all__ = [
    "ByteTokenizer",
    "HFTokenizerAdapter",
    "IGNORE_INDEX",
    "SpatialVLAProcessor",
    "TextTokenizer",
    "load_text_tokenizer",
    "preprocess_image",
    "preprocess_images",
    "preprocess_images_u8",
    "resize_image_u8",
    "scale_intrinsics",
]
