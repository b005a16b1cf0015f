"""Multi-device sharded encode: one image's MCU-row bands across all
available devices (the capability the single-GPU reference lacks).

Run on CPU for demonstration:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_encode.py
"""
import numpy as np

from gpujpeg_jax import Encoder, ImageParameters, Parameters
from gpujpeg_jax.parallel import ShardedEncoder, choose_restart_interval
from gpujpeg_jax.types import ColorSpace, PixelFormat


def main():
    import jax
    H, W = 512, 640
    y, x = np.mgrid[0:H, 0:W]
    img = np.clip(np.stack([128 + 90 * np.sin(x / 23.0),
                            128 + 80 * np.cos(y / 17.0),
                            128 + 70 * np.sin((x + y) / 31.0)], axis=-1),
                  0, 255).astype(np.uint8)

    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    n = len(jax.devices())
    params = Parameters(quality=85)
    ri = choose_restart_interval(params, image, n)
    params = Parameters(quality=85, restart_interval=ri)

    enc = ShardedEncoder()                     # default mesh over all devices
    data = enc.encode(img, params, image)
    single = Encoder().encode(img, params, image)
    print(f"{n} devices, restart interval {ri}: {len(data)} bytes; "
          f"bit-identical to single-device: {data == single}")


if __name__ == "__main__":
    main()
