"""Zero-host-copy round trip with JAX device arrays.

The analog of the reference's OpenGL / CUDA-buffer interop
(examples/decode_to_cuda_pnm.c, encode from GPU memory): the encoder
accepts a device-resident frame and the decoder can leave its output on
device, so producer/consumer pipelines never bounce through the host."""
import jax.numpy as jnp
import numpy as np

from gpujpeg_jax import Decoder, Encoder, ImageParameters, Parameters
from gpujpeg_jax.types import ColorSpace, PixelFormat


def main():
    H, W = 256, 320
    rng = np.random.default_rng(0)
    frame_host = np.clip(
        rng.normal(128, 30, (H, W, 3)), 0, 255).astype(np.uint8)
    frame_device = jnp.asarray(frame_host)     # e.g. another model's output

    params = Parameters(quality=85, restart_interval=8)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder().encode(frame_device, params, image)   # no H2D copy

    dec = Decoder()
    raw_device, out_image = dec.decode_to_device(data)     # stays on device
    # the flagship (px-tail) decode leaves the pixels as int32 RAW WORDS
    # — the same bytes as the u8 buffer, and exactly the encoder's
    # words-form input, so transcode chains stay zero-copy on device
    print(type(raw_device), raw_device.dtype, out_image.width,
          out_image.height)
    data2 = Encoder().encode(raw_device, params, image)    # re-encode chain
    print(f"transcode: {len(data)} -> {len(data2)} bytes, no host copy")
    host = np.ascontiguousarray(np.asarray(raw_device))
    if host.dtype == np.int32:
        host = host.view("<u1")                            # free view
    mse = float(np.mean((host.reshape(-1).astype(np.float32)
                         - frame_host.reshape(-1)) ** 2))
    print(f"round-trip MSE: {mse:.1f}")


if __name__ == "__main__":
    main()
