"""Multi-device sharded encode on the virtual 8-device CPU mesh.

The strongest possible oracle: band/segment sharding must not change the
bitstream at all — segments are byte-identical whether coded on 1 chip or 8,
because DC prediction resets at every restart marker (the same invariant the
reference's segment-parallel GPU kernels rely on,
gpujpeg_huffman_gpu_encoder.cu:326-337).
"""
import numpy as np
import pytest
import jax
from jax.sharding import Mesh

from gpujpeg_jax.models.encoder import Encoder
from gpujpeg_jax.models.decoder import Decoder
from gpujpeg_jax.params import ImageParameters, Parameters
from gpujpeg_jax.parallel import ShardedEncoder, choose_restart_interval, plan_bands
from gpujpeg_jax.types import ColorSpace, PixelFormat

from conftest import make_test_rgb, psnr


def _mesh(frame: int, seg: int) -> Mesh:
    devs = np.array(jax.devices()[: frame * seg]).reshape(frame, seg)
    return Mesh(devs, ("frame", "seg"))


@pytest.mark.parametrize("interleaved", [False, True])
def test_sharded_encode_bit_identical(interleaved):
    H, W = 128, 160
    img = make_test_rgb(H, W, seed=3)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=80, restart_interval=4, interleaved=interleaved)

    single = Encoder(backend="jax").encode(img, params, image)

    enc = ShardedEncoder(_mesh(1, 8))
    sharded = enc.encode(img, params, image)
    assert sharded == single


def test_sharded_batch_frames():
    H, W = 64, 64
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=75, restart_interval=2)
    frames = [make_test_rgb(H, W, seed=s) for s in range(3)]

    enc = ShardedEncoder(_mesh(2, 4))
    outs = enc.encode_batch(frames, params, image)
    assert len(outs) == 3
    dec = Decoder(backend="golden")
    for f, out in zip(frames, outs):
        raw, info = dec.decode(out)
        assert psnr(f, raw.reshape(H, W, 3)) > 30


def test_choose_restart_interval_divides():
    image = ImageParameters(width=1920, height=1088, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(interleaved=False)
    ri = choose_restart_interval(params, image, 8)
    assert ri >= 1
    layout = plan_bands(
        Parameters(interleaved=False, restart_interval=ri), image, 8)
    # every scan's per-band MCU count divides cleanly
    for c in layout.plan.components:
        assert c.mcu_count % ri == 0


def test_plan_bands_rejects_misaligned():
    image = ImageParameters(width=64, height=100, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    with pytest.raises(ValueError):
        plan_bands(Parameters(restart_interval=2), image, 8)
    with pytest.raises(ValueError):
        plan_bands(Parameters(restart_interval=0),
                   ImageParameters(width=64, height=128,
                                   color_space=ColorSpace.RGB,
                                   pixel_format=PixelFormat.PF_444_U8_P012), 8)


def test_sharded_decode_round_trip():
    from gpujpeg_jax.parallel import ShardedDecoder
    H, W = 128, 160
    img = make_test_rgb(H, W, seed=5)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=85, restart_interval=4)
    data = Encoder(backend="jax").encode(img, params, image)

    mesh = _mesh(1, 8)
    raw, out_img = ShardedDecoder(mesh).decode(data)
    assert (out_img.width, out_img.height) == (W, H)
    # must match the single-chip decoder exactly
    ref, _ = Decoder(backend="jax").decode(data)
    np.testing.assert_array_equal(raw, ref)
    assert psnr(img, raw.reshape(H, W, 3)) > 30


def test_sharded_decode_fallback_non_aligned():
    from gpujpeg_jax.parallel import ShardedDecoder
    # 40-pixel height cannot split into 8 MCU-row bands -> silent fallback
    H, W = 40, 64
    img = make_test_rgb(H, W, seed=6)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder(backend="golden").encode(
        img, Parameters(quality=80, restart_interval=3), image)
    raw, out_img = ShardedDecoder(_mesh(1, 8)).decode(data)
    assert psnr(img, raw.reshape(H, W, 3)) > 30


def test_sharded_tier2_fallback_high_entropy(monkeypatch):
    """A tier-1 capacity overflow must rerun on the tier-2 worst-case
    geometry instead of raising (round-1 advisor finding), and stay
    bit-identical to the single-chip encoder. The tiny forced budget
    makes the overflow deterministic."""
    import gpujpeg_jax.parallel.sharded as sh
    import gpujpeg_jax.ops.entropy_v2 as ev2
    monkeypatch.setattr(ev2, "seg_budget_for_quality", lambda q, bps: 8)
    rng = np.random.default_rng(5)
    H, W = 64, 64
    img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=90, restart_interval=2)

    import gpujpeg_jax.ops.jax_pipeline as jp
    jp._ENC_CACHE.clear()     # cached contexts were built with real budgets
    single = Encoder(backend="jax").encode(img, params, image)
    enc = ShardedEncoder(_mesh(1, 8))
    sharded = enc.encode(img, params, image)
    jp._ENC_CACHE.clear()
    assert sharded == single
    assert enc._cache and next(iter(enc._cache.values())).fn2 is not None, \
        "expected tier-2 rerun to have engaged"


def test_sharded_decode_reuses_executable():
    """Repeat sharded decodes of same-geometry streams must reuse ONE
    cached jitted shard_map — a fresh jit(closure) per call misses
    jit's identity-keyed cache and recompiles every frame."""
    from gpujpeg_jax.parallel import ShardedDecoder

    h, w = 64, 96
    params = Parameters(quality=85, restart_interval=2)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    enc = Encoder(backend="golden")
    d1 = enc.encode(make_test_rgb(h, w, seed=1).reshape(-1), params, image)
    d2 = enc.encode(make_test_rgb(h, w, seed=2).reshape(-1), params, image)
    dec = ShardedDecoder(_mesh(1, 4))
    r1, _ = dec.decode(d1)
    assert len(dec._cache) == 1, "decode executable not cached at all"
    r2, _ = dec.decode(d2)
    assert len(dec._cache) == 1, "same-family frame rebuilt the jit"
    assert r1.size == r2.size


def test_sharded_decode_batch_matches_per_frame():
    """ShardedDecoder.decode_batch (deferred band fetch) must match
    per-frame decodes exactly, including an infeasible-geometry frame
    that falls back to the single-chip decoder mid-batch."""
    from gpujpeg_jax.parallel import ShardedDecoder

    h, w = 64, 96
    params = Parameters(quality=85, restart_interval=2)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    enc = Encoder(backend="golden")
    streams = [enc.encode(make_test_rgb(h, w, seed=s).reshape(-1), params,
                          image) for s in (1, 2)]
    # 40-row height does not divide into 4 whole-MCU-row bands ->
    # single-chip fallback inside the batch
    img3 = make_test_rgb(40, 48, seed=3)
    image3 = ImageParameters(width=48, height=40,
                             color_space=ColorSpace.RGB,
                             pixel_format=PixelFormat.PF_444_U8_P012)
    streams.append(enc.encode(img3.reshape(-1), params, image3))

    dec = ShardedDecoder(_mesh(1, 4))
    want = [dec.decode(s) for s in streams]
    got = dec.decode_batch(streams)
    assert len(got) == len(want)
    for (g, gi), (w_, wi) in zip(got, want):
        assert gi == wi
        assert np.array_equal(g, w_)
