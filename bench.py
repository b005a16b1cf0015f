#!/usr/bin/env python
"""Headline benchmark: 8K (7680x4320, 33 Mpix) RGB encode and decode at
Q75, non-interleaved, restart markers — the reference's flagship
configuration — on one GPU.

Methodology: steady-state calls timed with ``block_until_ready``; the
device pipeline runs on device-resident input (the reference's published
"w/o PCIe xfers" row: GTX 3080, 2.30 ms at 8K Q75, reference
README.md:113); the end-to-end wall includes transfers and host stream
assembly. Median and quartiles over the iterations.

Prints ONE JSON line:
  {"metric": "encode_8k_q75_device_ms", "value": <median ms>, "unit": "ms",
   "vs_baseline": <2.30 / ms>, ..., "device": {...}}

Exits non-zero without a GPU: a CPU time is not a device metric.
Run: python bench.py   (BENCH_ITERS sets the iteration count, default 30)
"""
import json
import os
import sys
import time

import numpy as np

BASELINE_DEVICE_MS = 2.30   # GTX 3080, 8K Q75 encode w/o PCIe (README.md:113)
BASELINE_E2E_MS = 6.20      # GTX 3080, 8K Q75 encode incl. PCIe (README.md:97)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_image(H, W, seed=7):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    img = np.stack([
        128 + 90 * np.sin(x / 23.0) * np.cos(y / 17.0),
        128 + 80 * np.cos(x / 31.0 + 1.0) * np.sin(y / 11.0),
        128 + 70 * np.sin((x + y) / 41.0),
    ], axis=-1)
    img += rng.normal(0, 3.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def timed(fn, n):
    """(median, q1, q3) ms over n calls; fn must block."""
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(ts, [25, 50, 75])
    return float(med), float(q1), float(q3)


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench.py measures the GPU; JAX's first device is {dev!r}")
        sys.exit(1)
    from gpujpeg_jax.models.decoder import Decoder
    from gpujpeg_jax.models.encoder import Encoder
    from gpujpeg_jax.ops.jax_pipeline import _enc_context
    from gpujpeg_jax.params import ImageParameters, Parameters, \
        suggest_restart_interval
    from gpujpeg_jax.plan import make_plan
    from gpujpeg_jax.types import ColorSpace, PixelFormat

    H, W = 4320, 7680
    iters = int(os.environ.get("BENCH_ITERS", "30"))
    log(f"devices: {jax.devices()}")
    img = make_image(H, W)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    ri = suggest_restart_interval(image, subsampled=False, interleaved=False,
                                  pow2=True)
    params = Parameters(quality=75, restart_interval=ri, interleaved=False)
    log(f"image: {W}x{H}, Q75 non-interleaved, ri={ri}, {iters} iters")

    enc = Encoder(backend="jax")
    t0 = time.perf_counter()
    out = enc.encode(img, params, image)
    first_iter_s = time.perf_counter() - t0
    enc_wall = timed(lambda: enc.encode(img, params, image),
                     max(3, iters // 6))
    ctx = _enc_context(make_plan(params, image), *enc._tables(params))
    raw_dev = jax.block_until_ready(jax.numpy.asarray(img.reshape(-1)))
    enc_dev = timed(lambda: jax.block_until_ready(ctx.fn(raw_dev)), iters)
    log(f"encode: first call {first_iter_s:.2f} s, wall {enc_wall[0]:.3f} "
        f"ms (baseline incl. PCIe {BASELINE_E2E_MS} ms), device "
        f"{enc_dev[0]:.3f} ms (baseline {BASELINE_DEVICE_MS} ms)")

    dec = Decoder(backend="jax")
    dec.capture_device_call = True
    dec.decode(out)
    dec_wall = timed(lambda: dec.decode(out), max(3, iters // 6))
    dfn, dargs = dec.last_device_call
    dec_dev = timed(lambda: jax.block_until_ready(dfn(*dargs)), iters)
    log(f"decode: wall {dec_wall[0]:.3f} ms (baseline incl. PCIe 6.76 ms), "
        f"device {dec_dev[0]:.3f} ms (baseline 2.38 ms)")

    print(json.dumps({
        "metric": "encode_8k_q75_device_ms",
        "value": enc_dev[0],
        "unit": "ms",
        "vs_baseline": BASELINE_DEVICE_MS / enc_dev[0],
        "encode_device_q1_q3_ms": enc_dev[1:],
        "encode_wall_ms": enc_wall[0],
        "decode_device_ms": dec_dev[0],
        "decode_wall_ms": dec_wall[0],
        "first_iteration_s": first_iter_s,
        "host_frames": enc.stats.host_frames + dec.stats.host_frames,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
