#!/usr/bin/env python
"""Benchmark suite on one GPU (`bench.py` stays the one-line headline).

Covers the BASELINE.json configs measurable on one card:
  - HD / 4K / 8K / 16K encode + decode, Q75 non-interleaved, restart
    markers (reference README.md:95-97,127-129 conditions)
  - Y4M-style video batch: same-geometry frames through one cached
    executable (the reference's `-n` iteration mode)
  - optional quality sweep Q10..Q100 at 8K (--sweep; each quality is a
    new geometry, so expect one compile per quality on a cold cache)

Methodology: device-resident input, each call timed to
``block_until_ready`` (the reference's "w/o PCIe xfers" rows); medians
over the iterations. Exits non-zero without a GPU.

Prints a table to stdout and one JSON line per config to stderr.
Run: python bench_suite.py [--sweep | --sweep-only] [--no-16k]
"""
import json
import os
import sys
import time

import numpy as np

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402

from gpujpeg_jax.models.decoder import Decoder                # noqa: E402
from gpujpeg_jax.models.encoder import Encoder                # noqa: E402
from gpujpeg_jax.params import (                              # noqa: E402
    ImageParameters, Parameters, suggest_restart_interval)
from gpujpeg_jax.plan import make_plan                        # noqa: E402
from gpujpeg_jax.types import ColorSpace, PixelFormat         # noqa: E402
from gpujpeg_jax.ops.jax_pipeline import _enc_context         # noqa: E402

# GTX 3080 w/o PCIe transfers (reference README.md:113,145); 16K encode
# extrapolated from the with-PCIe ratio
BASE_ENC = {"HD": 0.21, "4K": 0.75, "8K": 2.30, "16K": 9.2}
BASE_DEC = {"HD": 0.25, "4K": 0.85, "8K": 2.38, "16K": 11.1}
RES = {"HD": (1080, 1920), "4K": (2160, 3840), "8K": (4320, 7680),
       "16K": (8640, 15360)}


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


def median_ms(fn, iters):
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def device_times(img, params, image, iters):
    """(encode device ms, decode device ms, jpeg bytes)."""
    enc = Encoder(backend="jax")
    out = enc.encode(img, params, image)                     # compile
    ctx = _enc_context(make_plan(params, image), *enc._tables(params))
    raw_dev = jax.block_until_ready(jnp.asarray(img.reshape(-1)))
    enc_ms = median_ms(lambda: ctx.fn(raw_dev), iters)
    dec = Decoder(backend="jax")
    dec.output_to_device = True
    dec.capture_device_call = True
    dec.decode(out)                                          # compile
    dfn, dargs = dec.last_device_call
    dec_ms = median_ms(lambda: dfn(*dargs), iters)
    return enc_ms, dec_ms, out


def bench_res(name, iters):
    H, W = RES[name]
    img = make_image(H, W)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    ri = suggest_restart_interval(image, subsampled=False, interleaved=False,
                                  pow2=True)
    params = Parameters(quality=75, restart_interval=ri, interleaved=False)
    enc_ms, dec_ms, out = device_times(img, params, image, iters)
    mpix = W * H / 1e6
    row = dict(config=name, mpix=mpix, encode_device_ms=enc_ms,
               decode_device_ms=dec_ms, encode_mpix_s=mpix / enc_ms * 1e3,
               decode_mpix_s=mpix / dec_ms * 1e3, jpeg_bytes=len(out),
               vs_3080_encode=BASE_ENC[name] / enc_ms,
               vs_3080_decode=BASE_DEC[name] / dec_ms)
    print(json.dumps(row), file=sys.stderr, flush=True)
    return row


def bench_video(iters=100):
    """Same-geometry frame stream through one cached executable — the
    Y4M batch case (reference `-n 100`) — plus the end-to-end
    encode_batch / decode_batch walls."""
    H, W = RES["HD"]
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    ri = suggest_restart_interval(image, subsampled=False, interleaved=False,
                                  pow2=True)
    params = Parameters(quality=75, restart_interval=ri, interleaved=False)
    enc = Encoder(backend="jax")
    frames = [make_image(H, W, seed=s) for s in range(4)]
    enc.encode(frames[0], params, image)
    ctx = _enc_context(make_plan(params, image), *enc._tables(params))
    devs = [jnp.asarray(f.reshape(-1)) for f in frames]
    jax.block_until_ready(ctx.fn(devs[0]))
    t0 = time.perf_counter()
    outs = [ctx.fn(devs[i % 4]) for i in range(iters)]
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    row = dict(config=f"video_{iters}xHD", fps=iters / dt,
               mpix_s=iters * W * H / 1e6 / dt)

    n = max(10, iters // 4)
    t0 = time.perf_counter()
    streams = enc.encode_batch([frames[i % 4] for i in range(n)], params,
                               image)
    dt_e = time.perf_counter() - t0
    row.update(encode_e2e_fps=n / dt_e)
    dec = Decoder(backend="jax")
    dec.decode(streams[0])          # compile/warm
    t0 = time.perf_counter()
    dec.decode_batch(streams)
    dt_d = time.perf_counter() - t0
    row.update(decode_e2e_fps=n / dt_d)
    print(json.dumps(row), file=sys.stderr, flush=True)
    return row


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_suite.py measures the GPU; JAX's first device is "
              f"{dev!r}", file=sys.stderr)
        sys.exit(1)
    do_sweep = "--sweep" in sys.argv or "--sweep-only" in sys.argv
    do_res = "--sweep-only" not in sys.argv
    do_16k = "--no-16k" not in sys.argv
    iters = int(os.environ.get("BENCH_ITERS", "20"))
    print(f"devices: {jax.devices()}", file=sys.stderr)

    rows = []
    if do_res:
        for name in ("HD", "4K", "8K") + (("16K",) if do_16k else ()):
            rows.append(bench_res(name, iters))
        rows.append(bench_video())

    if do_sweep:
        H, W = RES["8K"]
        img = make_image(H, W)
        image = ImageParameters(width=W, height=H,
                                color_space=ColorSpace.RGB,
                                pixel_format=PixelFormat.PF_444_U8_P012)
        ri = suggest_restart_interval(image, subsampled=False,
                                      interleaved=False, pow2=True)
        for q in range(10, 101, 10):
            params = Parameters(quality=q, restart_interval=ri,
                                interleaved=False)
            enc_ms, dec_ms, out = device_times(img, params, image, 8)
            row = dict(config=f"8K_Q{q}", jpeg_bytes=len(out),
                       encode_device_ms=enc_ms, decode_device_ms=dec_ms)
            print(json.dumps(row), file=sys.stderr, flush=True)

    hdr = ("config", "mpix", "encode_device_ms", "decode_device_ms",
           "encode_mpix_s", "decode_mpix_s")
    print("\t".join(hdr))
    for r in rows:
        print("\t".join(str(r.get(k, "")) for k in hdr))


if __name__ == "__main__":
    main()
