#!/usr/bin/env python3
"""Write the JPEG fixtures of the codec tests and their decoded pixels.

    python3 tests/data/make_jpeg_fixtures.py

Writes, beside this script, two 64x48 (width x height) colour JPEGs at
quality 95, ``jpeg444.jpg`` with 4:4:4 and ``jpeg420.jpg`` with 4:2:0
chroma subsampling, each with cv2's decoded BGR pixels as
``jpeg444.npy`` / ``jpeg420.npy``.  The image is a smooth two-way
gradient with a disc and a sharp diagonal edge, fixed (no randomness).
The codec tests hold the decode to these pixels.
"""
import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 64, 48


def image():
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    b = 40 + 180 * x / (W - 1)
    g = 30 + 200 * y / (H - 1)
    r = 128 + 100 * np.sin(x / 7.0) * np.cos(y / 5.0)
    disc = (x - 40) ** 2 + (y - 20) ** 2 < 12 ** 2
    r = np.where(disc, 230, r)
    g = np.where(disc, 40, g)
    edge = x + y < 30
    b = np.where(edge, 20, b)
    return np.clip(np.stack([b, g, r], 2), 0, 255).round().astype(np.uint8)


def main():
    img = image()
    for name, factor in (("jpeg444", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
                         ("jpeg420", cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420)):
        ok, buf = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_QUALITY, 95,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
        assert ok
        with open(os.path.join(HERE, name + ".jpg"), "wb") as f:
            f.write(buf.tobytes())
        np.save(os.path.join(HERE, name + ".npy"),
                cv2.imdecode(buf, cv2.IMREAD_COLOR))


if __name__ == "__main__":
    main()
