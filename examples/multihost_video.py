"""Multi-host video pipeline: frames sharded across processes, each
frame's MCU-row bands sharded across that process's local devices —
encode and decode (SURVEY §2.3; the single-GPU reference has no
distributed story at all).

Launch one process per host (or per GPU). Under a cluster launcher JAX
can detect (SLURM, MPI), ``init_distributed()`` finds the coordinator
by itself; elsewhere pass it explicitly, as this CPU demonstration
does by spawning it twice:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python examples/multihost_video.py 0 2 localhost:9876 &
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python examples/multihost_video.py 1 2 localhost:9876
"""
import sys

import numpy as np

from gpujpeg_jax import ImageParameters, Parameters
from gpujpeg_jax.parallel import (
    MultiHostDecoder,
    MultiHostEncoder,
    init_distributed,
)
from gpujpeg_jax.types import ColorSpace, PixelFormat


def main():
    if len(sys.argv) >= 4:
        pid, nproc, coord = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3])
        init_distributed(coord, num_processes=nproc, process_id=pid)
    else:
        init_distributed()          # cluster launcher auto-discovery

    import jax
    H, W = 256, 320
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=85, restart_interval=4)

    # each process owns its own frames (e.g. its slice of a video)
    rng = np.random.default_rng(100 + jax.process_index())
    y, x = np.mgrid[0:H, 0:W]
    frames = [np.clip(np.stack([128 + 90 * np.sin(x / (21.0 + f)),
                                128 + 80 * np.cos(y / 17.0),
                                128 + 70 * np.sin((x + y) / 31.0)], -1)
                      + rng.normal(0, 2, (H, W, 3)), 0, 255)
              .astype(np.uint8) for f in range(2)]

    enc = MultiHostEncoder()
    streams = enc.encode_my_frames(frames, params, image)
    print(f"process {jax.process_index()}: encoded "
          f"{[len(s) for s in streams]} bytes")

    dec = MultiHostDecoder()
    for frame, stream, (raw, oi) in zip(frames, streams,
                                        dec.decode_my_frames(streams)):
        got = np.asarray(raw).reshape(H, W, 3).astype(np.int64)
        mse = np.mean((got - frame.astype(np.int64)) ** 2)
        psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))
        print(f"process {jax.process_index()}: round-trip PSNR "
              f"{psnr:.2f} dB")
        assert psnr > 30


if __name__ == "__main__":
    main()
