"""Procedural 10-class shape images — the in-container vision TRAINING corpus.

The reference ships a remote repository of pretrained vision backbones
(``deep-learning/.../downloader/ModelDownloader.scala:26-112``); this
environment is zero-egress, so no CIFAR/ImageNet download exists to train
on.  Instead the committed backbone (``tools/train_backbone.py``) trains on
this deterministic, SYNTHETIC-BY-CONSTRUCTION generator: 32x32x3 images of
ten geometric/texture classes with randomized colors, position, scale,
rotation and noise.  The point is not the corpus (it is openly synthetic) —
it is that the checkpoint is GENUINELY TRAINED end to end and that its
frozen features transfer: the eval protocol probes them on the REAL UCI
digits scans (sklearn's bundled load_digits) against a raw-pixel baseline.

The port's own copy (numpy only) of ``mmlspark_tpu/dl/procedural_shapes.py``;
its ``digits_as_images`` (sklearn's digits) stays with the JAX package and
its tests.

Classes: 0 circle, 1 ring, 2 square, 3 triangle, 4 cross, 5 horizontal
stripes, 6 vertical stripes, 7 checkerboard, 8 dot grid, 9 two-bar glyph.
"""
from __future__ import annotations

import numpy as np

NUM_CLASSES = 10
HW = 32


def _sample_batch(rng: np.random.Generator, labels: np.ndarray) -> np.ndarray:
    """(n, 32, 32, 3) float32 in [0, 1] for the given class labels."""
    n = len(labels)
    yy, xx = np.mgrid[0:HW, 0:HW].astype(np.float32)
    xx = (xx / (HW - 1)) * 2 - 1
    yy = (yy / (HW - 1)) * 2 - 1

    cx = rng.uniform(-0.25, 0.25, n).astype(np.float32)
    cy = rng.uniform(-0.25, 0.25, n).astype(np.float32)
    scale = rng.uniform(0.55, 0.95, n).astype(np.float32)
    theta = rng.uniform(-np.pi / 5, np.pi / 5, n).astype(np.float32)
    ct, st = np.cos(theta), np.sin(theta)

    # per-sample rotated/scaled/translated coordinates (n, HW, HW)
    dx = xx[None] - cx[:, None, None]
    dy = yy[None] - cy[:, None, None]
    u = (dx * ct[:, None, None] + dy * st[:, None, None]) / scale[:, None, None]
    v = (-dx * st[:, None, None] + dy * ct[:, None, None]) / scale[:, None, None]
    r2 = u * u + v * v
    au, av = np.abs(u), np.abs(v)
    freq = rng.uniform(4.0, 7.0, n).astype(np.float32)[:, None, None]

    masks = np.zeros((n, HW, HW), np.float32)
    inside = np.maximum(au, av) < 0.75           # texture classes: window
    for cls in range(NUM_CLASSES):
        sel = labels == cls
        if not sel.any():
            continue
        if cls == 0:
            m = r2[sel] < 0.45 ** 2
        elif cls == 1:
            m = (r2[sel] < 0.50 ** 2) & (r2[sel] > 0.28 ** 2)
        elif cls == 2:
            m = np.maximum(au[sel], av[sel]) < 0.42
        elif cls == 3:
            m = (v[sel] > -0.45) & (v[sel] < 1.9 * (0.48 - au[sel]) - 0.45)
        elif cls == 4:
            m = ((au[sel] < 0.14) & (av[sel] < 0.55)) | \
                ((av[sel] < 0.14) & (au[sel] < 0.55))
        elif cls == 5:
            m = (np.sin(freq[sel] * np.pi * v[sel]) > 0) & inside[sel]
        elif cls == 6:
            m = (np.sin(freq[sel] * np.pi * u[sel]) > 0) & inside[sel]
        elif cls == 7:
            m = (np.sin(freq[sel] * np.pi * u[sel])
                 * np.sin(freq[sel] * np.pi * v[sel]) > 0) & inside[sel]
        elif cls == 8:
            fu = (u[sel] * freq[sel] / 2) % 1.0 - 0.5
            fv = (v[sel] * freq[sel] / 2) % 1.0 - 0.5
            m = (fu * fu + fv * fv < 0.22 ** 2) & inside[sel]
        else:  # two parallel bars
            m = (au[sel] < 0.5) & ((np.abs(v[sel] - 0.22) < 0.11)
                                   | (np.abs(v[sel] + 0.22) < 0.11))
        masks[sel] = m.astype(np.float32)

    # contrasting foreground/background colors + noise
    bg = rng.uniform(0.0, 0.45, (n, 1, 1, 3)).astype(np.float32)
    fg = rng.uniform(0.55, 1.0, (n, 1, 1, 3)).astype(np.float32)
    flip = rng.uniform(size=n) < 0.5             # half: dark-on-light
    bg[flip], fg[flip] = fg[flip], bg[flip]
    img = bg + (fg - bg) * masks[..., None]
    img += rng.normal(0, 0.06, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def make_shapes(n: int, seed: int = 0, batch: int = 4096):
    """Deterministic (X (n,32,32,3) f32 in [0,1], y (n,) i32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NUM_CLASSES, n).astype(np.int32)
    X = np.empty((n, HW, HW, 3), np.float32)
    for a in range(0, n, batch):
        b = min(a + batch, n)
        X[a:b] = _sample_batch(rng, labels[a:b])
    return X, labels
