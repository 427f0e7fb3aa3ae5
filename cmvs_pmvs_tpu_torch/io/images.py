"""Image, mask and edge-map loading for the visualize/masks/edges trees.

The reference loads any format via CImg + libjpeg
(reference source/image/image.cpp:473-830, source/image/photoSetS.cpp:24-73:
try visualize/%08d.{ppm,jpg,png,tiff}, falling back to 4-digit names).
Here PIL covers all formats, plus a dependency-free binary PPM writer used
by the synthetic-scene generators.

The port's own copy of cmvs_pmvs_tpu/io/images.py
(the port imports nothing of the JAX package).
"""
from __future__ import annotations

import os

import numpy as np

_EXTS = (".ppm", ".jpg", ".jpeg", ".png", ".tiff", ".pgm", ".pbm")


def find_image_path(dirname: str, image_id: int,
                    exts: tuple[str, ...] = _EXTS) -> str | None:
    """Resolve visualize/%08d.* with 4-digit fallback
    (reference photoSetS.cpp:27-72)."""
    for fmt in ("%08d", "%04d"):
        base = os.path.join(dirname, fmt % image_id)
        for ext in exts:
            p = base + ext
            if os.path.exists(p):
                return p
    return None


def load_image(path: str) -> np.ndarray:
    """Load an RGB image -> uint8 [H, W, 3]."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def load_pgm_mask(path: str) -> np.ndarray:
    """Load a mask/edge map -> uint8 [H, W], nonzero = usable
    (reference image.cpp mask semantics: 127 < value => in-mask)."""
    from PIL import Image
    with Image.open(path) as im:
        arr = np.asarray(im.convert("L"), dtype=np.uint8)
    return (arr > 127).astype(np.uint8)


def save_pgm(path: str, mask: np.ndarray) -> None:
    """Binary P5 PGM writer for masks (nonzero -> 255, so load_pgm_mask's
    127-threshold round-trips; format: reference image.cpp:569-607)."""
    mask = (np.asarray(mask) > 0).astype(np.uint8) * 255
    h, w = mask.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(mask.tobytes())


def save_ppm(path: str, image: np.ndarray) -> None:
    """Binary P6 PPM writer (format: reference image.cpp:609-641)."""
    image = np.asarray(image, dtype=np.uint8)
    h, w = image.shape[:2]
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(image.tobytes())


def load_ppm(path: str) -> np.ndarray:
    """Binary P6 PPM reader (avoids PIL for hot test paths)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P6"):
        raise ValueError("Not a P6 PPM")
    fields: list[bytes] = []
    i = 2
    while len(fields) < 3:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while data[i:i + 1] != b"\n":
                i += 1
            continue
        j = i
        while not data[j:j + 1].isspace():
            j += 1
        fields.append(data[i:j])
        i = j
    i += 1  # single whitespace after maxval
    w, h = int(fields[0]), int(fields[1])
    return np.frombuffer(data, dtype=np.uint8, count=w * h * 3,
                         offset=i).reshape(h, w, 3).copy()
