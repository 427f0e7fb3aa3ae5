"""Write a scene as a PMVS input tree with the benchmark's own numpy
writers: `visualize/%08d.ppm` (binary P6), `txt/%08d.txt` (CONTOUR, the
raw 3x4 projection), an empty `models/` and the option file.
"""
from __future__ import annotations

import os

import numpy as np

OPTION = "option.txt"


def save_ppm(path: str, image: np.ndarray):
    """Binary P6 PPM of a uint8 [H, W, 3] image."""
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(image, dtype=np.uint8).tobytes())


def load_ppm(path: str) -> np.ndarray:
    """The uint8 [H, W, 3] image of a binary P6 PPM as `save_ppm` writes
    it (header without comments)."""
    with open(path, "rb") as f:
        data = f.read()
    fields, i = [], 0
    while len(fields) < 4:
        while data[i:i + 1].isspace():
            i += 1
        j = i
        while not data[j:j + 1].isspace():
            j += 1
        fields.append(data[i:j])
        i = j
    magic, w, h, maxval = fields
    if magic != b"P6" or maxval != b"255":
        raise ValueError(f"{path}: not an 8-bit P6 PPM")
    w, h = int(w), int(h)
    # one whitespace byte ends the header
    return np.frombuffer(data, np.uint8, count=w * h * 3,
                         offset=i + 1).reshape(h, w, 3)


def save_camera(path: str, P: np.ndarray):
    """A CONTOUR camera file: the projection's three rows."""
    rows = np.asarray(P, np.float64).reshape(3, 4)
    with open(path, "w") as f:
        f.write("CONTOUR\n" + "".join(
            " ".join("%.17g" % v for v in r) + "\n" for r in rows))


def option_text(options: dict, level: int, num: int) -> str:
    """The option file: the configuration's options in the order the
    reference's genOption writes them, at `level`, every image a target
    (`timages -1 0 num`)."""
    keys = ("csize", "threshold", "wsize", "minImageNum", "CPU", "setEdge",
            "useBound", "useVisData", "sequence", "maxAngle", "quad")
    lines = [f"level {level}"] + [f"{k} {options[k]}" for k in keys]
    lines += [f"timages -1 0 {num}", f"oimages {options['oimages']}"]
    return "\n".join(lines) + "\n"


def write_tree(root: str, P: np.ndarray, images: np.ndarray,
               options: dict, level: int):
    """The PMVS tree of one scene under `root`."""
    for sub in ("visualize", "txt", "models"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, (p, im) in enumerate(zip(P, images)):
        save_ppm(os.path.join(root, "visualize", "%08d.ppm" % i), im)
        save_camera(os.path.join(root, "txt", "%08d.txt" % i), p)
    with open(os.path.join(root, OPTION), "w") as f:
        f.write(option_text(options, level, len(P)))
