"""Decode a JPEG file to a PNM image.

The analog of the reference's examples/decode_to_pnm.c."""
import sys

from gpujpeg_jax import Decoder
from gpujpeg_jax.utils import image_io


def main():
    src = sys.argv[1] if len(sys.argv) > 1 else "minimal.jpg"
    dst = sys.argv[2] if len(sys.argv) > 2 else "decoded.pnm"
    with open(src, "rb") as f:
        data = f.read()
    raw, image = Decoder().decode(data)
    image_io.save_image(dst, raw, image)
    print(f"wrote {dst} ({image.width}x{image.height})")


if __name__ == "__main__":
    main()
