"""Port parity for the NHWC image ops (``mmlspark_tpu_torch/ops/image.py``)
and ``ImageTransformer`` / ``ImageSetAugmenter`` against the JAX package,
on the same seeded numpy batches, on the CPU.

Tolerances:

- crop, center crop, flip, threshold, unroll: identical;
- normalize, grayscale, the gaussian kernel: rtol 1e-6 / atol 1e-6 (one
  rounding of each float32 product and sum, in either order);
- blur: atol 1e-4 on pixels in [0, 255] (a depthwise 5x5 convolution,
  summed in another order);
- resize on [0, 255]: atol 1e-3.  ``jax.image.resize``'s ``"linear"``
  antialiases when it shrinks and ``F.interpolate(antialias=True)``
  computes the same triangle filter; the sums of up to ~2 x scale taps
  round differently (largest difference seen: 2.3e-4, a 32 -> 224 grow);
  nearest: identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import DataFrame as JaxDataFrame
from mmlspark_tpu.opencv import ImageSetAugmenter as JaxAugmenter
from mmlspark_tpu.opencv import ImageTransformer as JaxTransformer
from mmlspark_tpu.ops import image as jax_image
from mmlspark_tpu_torch.core import DataFrame
from mmlspark_tpu_torch.opencv import ImageSetAugmenter, ImageTransformer
from mmlspark_tpu_torch.ops import image


def _batch(n=2, h=13, w=11, c=3, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 255, (n, h, w, c)).astype(np.float32)


def _both(fn_port, fn_jax, x, *args, **kw):
    got = fn_port(torch.from_numpy(x), *args, **kw).numpy()
    want = np.asarray(fn_jax(jnp.asarray(x), *args, **kw))
    assert got.shape == want.shape
    return got, want


@pytest.mark.parametrize("src,dst", [
    ((32, 32), (224, 224)),      # CIFAR -> the backbone's input: grow
    ((256, 256), (224, 224)),    # ImageNet resize: shrink, antialiased
    ((35, 33), (17, 40)),        # odd sizes, shrink one dim, grow the other
    ((7, 9), (5, 5)),
    ((8, 8), (8, 8)),            # same size
    ((31, 29), (64, 13)),
])
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_resize_equals_jax(src, dst, method):
    x = _batch(h=src[0], w=src[1], seed=sum(src) + sum(dst))
    got, want = _both(image.resize, jax_image.resize, x, *dst, method=method)
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_resize_takes_uint8_and_refuses_unknown_methods():
    x = _batch(h=12, w=12).astype(np.uint8)
    got, want = _both(image.resize, jax_image.resize, x, 6, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert got.dtype == np.float32
    with pytest.raises(NotImplementedError, match="lanczos3"):
        image.resize(torch.from_numpy(x), 6, 6, method="lanczos3")


@pytest.mark.parametrize("hw", [(13, 11), (8, 8), (3, 20)])
def test_crops_and_flips_are_identical(hw):
    x = _batch(h=hw[0], w=hw[1], seed=hw[0])
    for args in ((5, 4), (20, 30), (1, 1)):
        got, want = _both(image.center_crop, jax_image.center_crop, x,
                          *args)
        np.testing.assert_array_equal(got, want)
    got, want = _both(image.crop, jax_image.crop, x, 1, 2, 3, 4)
    np.testing.assert_array_equal(got, want)
    for horizontal in (True, False):
        got, want = _both(image.flip, jax_image.flip, x, horizontal)
        np.testing.assert_array_equal(got, want)
    got, want = _both(image.unroll, jax_image.unroll, x)
    np.testing.assert_array_equal(got, want)


def test_normalize_and_grayscale_equal_jax():
    x = _batch()
    got, want = _both(image.normalize, jax_image.normalize, x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got, want = _both(image.normalize, jax_image.normalize, x,
                      (0.5, 0.25, 0.0), (2.0, 1.0, 0.5), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    got, want = _both(image.to_grayscale, jax_image.to_grayscale, x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("size,sigma", [(5, 1.0), (3, 0.5), (7, 2.5)])
def test_gaussian_kernel_and_blur_equal_jax(size, sigma):
    np.testing.assert_allclose(image.gaussian_kernel(size, sigma).numpy(),
                               np.asarray(jax_image.gaussian_kernel(size,
                                                                    sigma)),
                               rtol=1e-6, atol=1e-7)
    x = _batch(h=9, w=14, c=3, seed=size)
    got, want = _both(image.blur, jax_image.blur, x, size, sigma)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["binary", "binary_inv", "trunc", "tozero",
                                  "tozero_inv"])
def test_threshold_is_identical(kind):
    x = _batch(seed=3)
    got, want = _both(image.threshold, jax_image.threshold, x, 100.0, 200.0,
                      kind)
    np.testing.assert_array_equal(got, want)


def test_threshold_refuses_unknown_kinds():
    with pytest.raises(ValueError, match="unknown threshold kind"):
        image.threshold(torch.zeros(1, 2, 2, 1), 1.0, kind="otsu")


def _image_frame(frame_cls, shapes, seed=4):
    rng = np.random.default_rng(seed)
    col = np.empty(len(shapes), dtype=object)
    for i, s in enumerate(shapes):
        col[i] = rng.uniform(0, 255, s).astype(np.float32)
    return frame_cls.from_dict({"image": col}, num_partitions=2)


def _chain(t):
    return (t.resize(20, 18).crop(1, 2, 16, 15).center_crop(12, 12)
            .flip(1).flip(0).blur(5, 5, 1.2).threshold(60.0, 250.0, "trunc")
            .normalize().color_format("gray").unroll())


def test_image_transformer_chain_equals_jax():
    """Every op of the chain over a column of mixed shapes (one device
    batch per shape, as the reference groups them)."""
    shapes = [(24, 22, 3), (17, 31, 3), (24, 22, 3), (40, 40, 3),
              (17, 31, 3)]
    port = _chain(ImageTransformer(input_col="image", output_col="out",
                                   device="cpu"))
    ref = _chain(JaxTransformer(input_col="image", output_col="out"))
    assert port.get("stages") == ref.get("stages")
    got = port.transform(_image_frame(DataFrame, shapes)).collect()["out"]
    want = ref.transform(_image_frame(JaxDataFrame, shapes)).collect()["out"]
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.shape == b.shape == (144,)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_image_set_augmenter_equals_jax():
    shapes = [(6, 5, 3)] * 3
    port = ImageSetAugmenter().set_params(
        input_col="image", output_col="aug", flip_up_down=True, device="cpu")
    ref = JaxAugmenter().set_params(
        input_col="image", output_col="aug", flip_up_down=True)
    got = port.transform(_image_frame(DataFrame, shapes)).collect()["aug"]
    want = ref.transform(_image_frame(JaxDataFrame, shapes)).collect()["aug"]
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
