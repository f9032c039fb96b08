"""Image decoding for the dataset loaders' Python path, and PNG writing.

The JAX package's loaders read frames with ``imageio``. A machine may lack
it, so the Python path takes the first of these routes that imports:

- ``"imageio"``: ``imageio.v2.imread``, as the JAX package does;
- ``"pillow"``: Pillow, imageio's own backend for PNG and JPEG, which gives
  the same arrays.

Without either, :func:`imread` raises, and so does :func:`imwrite`, which
writes over the same routes. The native C++ loader
(:mod:`.native_loader`) comes before both when it builds. Resizing needs
OpenCV, imported only when a frame's size differs from the size asked for.
"""

from __future__ import annotations

import importlib.util

import numpy as np

__all__ = ["ROUTES", "python_route", "imread", "imwrite", "resize"]

ROUTES = ("imageio", "pillow")


def python_route() -> str:
    """The first of :data:`ROUTES` this machine can run; raises ImportError
    when it can run neither."""
    if importlib.util.find_spec("imageio") is not None:
        return "imageio"
    if importlib.util.find_spec("PIL") is not None:
        return "pillow"
    raise ImportError("decoding an image file needs imageio or Pillow, and neither is installed")


def imread(path, route: str | None = None) -> np.ndarray:
    """Decodes the image at ``path`` by ``route`` (default
    :func:`python_route`): (H, W) for gray, (H, W, C) otherwise, uint8 or
    uint16 as stored."""
    route = route or python_route()
    if route == "imageio":
        import imageio.v2 as imageio

        return np.asarray(imageio.imread(path))
    if route == "pillow":
        from PIL import Image

        with Image.open(path) as img:
            if img.mode == "P":  # imageio expands palettes the same way
                img = img.convert("RGBA" if "transparency" in img.info else "RGB")
            return np.asarray(img)
    raise ValueError(f"decode route must be one of {ROUTES}, got {route!r}")


def imwrite(path, img: np.ndarray, route: str | None = None) -> None:
    """Writes ``img`` to ``path`` in the format its suffix names (PNG for a
    frame of a dataset tree: 8-bit (H, W, 3) color or 16-bit (H, W) depth)
    by ``route`` (default :func:`python_route`)."""
    route = route or python_route()
    img = np.ascontiguousarray(img)
    if route == "imageio":
        import imageio.v2 as imageio

        imageio.imwrite(path, img)
    elif route == "pillow":
        from PIL import Image

        Image.fromarray(img).save(path)
    else:
        raise ValueError(f"write route must be one of {ROUTES}, got {route!r}")


def resize(img: np.ndarray, height: int, width: int, interpolation: str) -> np.ndarray:
    """``cv2.resize`` to (height, width) with 'linear' or 'nearest'
    interpolation. Raises when OpenCV is missing: no other interpolation
    stands in for it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"resizing a {img.shape[0]}x{img.shape[1]} frame to {height}x{width} needs OpenCV "
            "(cv2), which is not installed; ask for the files' own height and width"
        ) from e
    flag = {"linear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST}[interpolation]
    return cv2.resize(img, (width, height), interpolation=flag)
