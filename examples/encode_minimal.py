"""Minimal encode: RGB array in, JPEG file out.

The analog of the reference's examples/encode_minimal.c."""
import numpy as np

from gpujpeg_jax import Encoder, ImageParameters, Parameters
from gpujpeg_jax.types import ColorSpace, PixelFormat


def main():
    H, W = 480, 640
    y, x = np.mgrid[0:H, 0:W]
    img = np.stack([
        (x * 255 // W), (y * 255 // H), ((x + y) * 255 // (W + H))
    ], axis=-1).astype(np.uint8)

    params = Parameters(quality=90, restart_interval=8)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder().encode(img, params, image)
    with open("minimal.jpg", "wb") as f:
        f.write(data)
    print(f"wrote minimal.jpg ({len(data)} bytes)")


if __name__ == "__main__":
    main()
