"""The device pipeline on both decode routes, on the CPU backend: the
XLA lockstep decoder (the CPU route) and the Pallas Huffman kernel of
the GPU route, run in the Pallas interpreter. Only the kernel's
compilation for the card is replaced by the interpreter; everything
around it (row build, tables, reorders, the dequant/IDCT tail, batching
and sharding) is the code the GPU runs.
"""
import io

import numpy as np
import pytest
from PIL import Image

from conftest import make_test_rgb, psnr

from gpujpeg_jax.models.decoder import Decoder
from gpujpeg_jax.models.encoder import Encoder
from gpujpeg_jax.params import ImageParameters, Parameters
from gpujpeg_jax.types import ColorSpace, PixelFormat

ROUTES = ("xla", "kernel")


@pytest.fixture(autouse=True)
def _fresh_caches():
    import gpujpeg_jax.ops.jax_pipeline as jp
    jp._ENC_CACHE.clear()
    jp._DEC_CACHE.clear()
    yield
    jp._ENC_CACHE.clear()
    jp._DEC_CACHE.clear()


def _decoder(route: str, **kw) -> Decoder:
    """A device decoder on ``route``; the kernel runs interpreted."""
    dec = Decoder(backend="jax", **kw)
    dec.routes = dict(dec.routes, huffman_decode=route)
    dec._kernel_interpret = route == "kernel"
    dec.set_output_format(ColorSpace.RGB, PixelFormat.PF_444_U8_P012)
    return dec


def _sharded_decoder(mesh, route: str):
    from gpujpeg_jax.parallel import ShardedDecoder
    dec = ShardedDecoder(mesh)
    dec.routes = dict(dec.routes, huffman_decode=route)
    dec._kernel_interpret = route == "kernel"
    return dec


def _roundtrip_device(img, params, image, route):
    data = Encoder(backend="jax").encode(img.reshape(-1), params, image)
    import gpujpeg_jax.models.decoder as dmod
    old = dmod.CPU_SEGMENT_THRESHOLD
    dmod.CPU_SEGMENT_THRESHOLD = 0      # force the device decode path
    try:
        dec = _decoder(route)
        raw, oi = dec.decode(data)
    finally:
        dmod.CPU_SEGMENT_THRESHOLD = old
    assert dec.stats.host_frames == 0
    return data, raw, oi


@pytest.mark.parametrize("route", ROUTES)
def test_pallas_encode_decode_noninterleaved(route):
    h, w = 64, 80
    img = make_test_rgb(h, w)
    params = Parameters(quality=85, restart_interval=2)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data, raw, _ = _roundtrip_device(img, params, image, route)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(pil, img) > 32
    assert psnr(raw.reshape(h, w, 3), img) > 32


@pytest.mark.parametrize("route", ROUTES)
def test_pallas_decode_interleaved_template_path(route):
    """An interleaved multi-component scan drives the kernel's per-slot
    component template."""
    h, w = 64, 96
    img = make_test_rgb(h, w)
    params = Parameters(quality=85, restart_interval=2, interleaved=True)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data, raw, _ = _roundtrip_device(img, params, image, route)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_less(30.0, psnr(raw.reshape(h, w, 3), pil))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("sub", [420, 422])
def test_pallas_decode_subsampled_device(sub, route):
    h, w = 64, 96
    img = make_test_rgb(h, w)
    params = Parameters(quality=90, restart_interval=2,
                        interleaved=True).with_chroma_subsampling(sub)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data, raw, _ = _roundtrip_device(img, params, image, route)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(raw.reshape(h, w, 3), pil) > 30


def test_pallas_encode_tier_fallback_high_entropy(rng):
    """Noise at Q90 blows the tier-1 typical-content budget; the encoder
    must rerun on the tier-2 worst-case geometry ON THE DEVICE (no host
    route) and still produce a stream PIL decodes."""
    h, w = 48, 64
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    params = Parameters(quality=90, restart_interval=2)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    import gpujpeg_jax.ops.jax_pipeline as jp
    enc = Encoder(backend="jax")
    data = enc.encode(img.reshape(-1), params, image)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(pil, img) > 25
    # the tier-2 context must actually have been built (fallback taken)
    ctxs = [c for c in jp._ENC_CACHE.values()]
    assert any(c._tier2 is not None for c in ctxs), \
        "expected tier-1 overflow to engage the tier-2 geometry"
    assert enc.stats.host_frames == 0


@pytest.mark.parametrize("route", ROUTES)
def test_decoder_perf_stats_device_path(route):
    """CLI -v decode must fill the huffman/IDCT/postprocess phase splits
    on the device path (reference: gpujpeg_common.h:315-325)."""
    import gpujpeg_jax.models.decoder as dmod
    h, w = 64, 80
    img = make_test_rgb(h, w)
    params = Parameters(quality=85, restart_interval=2)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder(backend="golden").encode(img.reshape(-1), params, image)
    old = dmod.CPU_SEGMENT_THRESHOLD
    dmod.CPU_SEGMENT_THRESHOLD = 0
    try:
        dec = _decoder(route, perf_stats=True)
        staged, _ = dec.decode(data)
        plain, _ = _decoder(route).decode(data)
    finally:
        dmod.CPU_SEGMENT_THRESHOLD = old
    st = dec.stats
    assert st.duration_huffman_coder > 0
    assert st.duration_dct_quantization > 0
    assert st.duration_postprocessor > 0
    assert st.duration_in_gpu > 0
    assert np.array_equal(staged, plain)


def test_sharded_decode_v3_kernel_path():
    """ShardedDecoder runs the Huffman kernel per band (interpreted) and
    matches the single-device golden decode."""
    import jax
    from jax.sharding import Mesh

    H, W = 128, 160
    img = make_test_rgb(H, W, seed=5)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=85, restart_interval=4)
    data = Encoder(backend="golden").encode(img, params, image)

    devs = np.array(jax.devices()[:8]).reshape(1, 8)
    dec = _sharded_decoder(Mesh(devs, ("frame", "seg")), "kernel")
    raw, out_img = dec.decode(data)
    assert any(k[0] == "kernel" for k in dec._cache), \
        "kernel route did not serve the bands"
    ref, _ = Decoder(backend="golden").decode(data)
    assert np.abs(raw.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("route", ROUTES)
def test_pallas_decode_corrupt_entropy_no_crash(monkeypatch, rng, route):
    """Corrupt entropy bytes through the DEVICE decode: invalid codes,
    runs past coefficient 63 and reads past a segment must yield a
    full-size image, never a crash or hang."""
    import gpujpeg_jax.models.decoder as dmod
    h, w = 64, 80
    img = make_test_rgb(h, w)
    params = Parameters(quality=85, restart_interval=4)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder(backend="golden").encode(img.reshape(-1), params, image)
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    sos = data.find(b"\xff\xda")
    buf = bytearray(data)
    for _ in range(12):
        i = int(rng.integers(sos + 20, len(buf) - 3))
        if buf[i] != 0xFF and buf[i - 1] != 0xFF:   # keep marker structure
            buf[i] ^= 0x55
    from gpujpeg_jax.stream.reader import JpegParseError
    try:
        raw, oi = _decoder(route).decode(bytes(buf))
        assert np.asarray(raw).size == oi.width * oi.height * 3
    except JpegParseError:
        pass  # clean parse error acceptable


def test_decode_v2_large_wcap_kernel(monkeypatch):
    """Large per-segment streams (Q100 noise, ri=32: hundreds of words
    per segment) through the kernel route must match the XLA route
    exactly — the kernel handles every row capacity."""
    import gpujpeg_jax.models.decoder as dmod
    import gpujpeg_jax.ops.jax_pipeline as jp
    h, w = 64, 128
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    params = Parameters(quality=100, restart_interval=32)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder(backend="golden").encode(img.reshape(-1), params, image)
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    outs = {r: np.asarray(_decoder(r).decode(data)[0]) for r in ROUTES}
    assert np.array_equal(outs["xla"], outs["kernel"])
    wcaps = [k[4][0] for k in jp._DEC_CACHE if k[3] == "kernel"]
    assert wcaps and max(wcaps) > 384, wcaps


def test_sharded_pallas_encode_decode_bit_identical():
    """Sharded encode/decode inside shard_map: streams byte-identical to
    the single-device encoder, decode (kernel route per band)
    bit-identical to the single-device decoder."""
    import jax
    from jax.sharding import Mesh
    from gpujpeg_jax.parallel import ShardedEncoder

    h, w = 64, 80
    img = make_test_rgb(h, w)
    params = Parameters(quality=85, restart_interval=2)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    want = Encoder(backend="jax").encode(img.reshape(-1), params, image)

    devs = np.array(jax.devices()[:4])
    mesh = Mesh(devs.reshape(1, -1), ("frame", "seg"))
    enc = ShardedEncoder(mesh)
    got = enc.encode(img, params, image)
    assert got == want

    ref, _ = _decoder("kernel").decode(want)
    raw, _ = _sharded_decoder(mesh, "kernel").decode(want)
    assert np.array_equal(np.asarray(raw).reshape(-1),
                          np.asarray(ref).reshape(-1))


@pytest.mark.parametrize("route", ROUTES)
def test_decode_batch_pipelined_device_path(monkeypatch, route):
    """decode_batch's deferred-sync, fused (vmapped) launches must match
    per-frame synchronous decodes exactly."""
    import gpujpeg_jax.models.decoder as dmod
    h, w = 64, 80
    params = Parameters(quality=85, restart_interval=1)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    enc = Encoder(backend="golden")
    datas = [enc.encode(make_test_rgb(h, w, seed=s).reshape(-1), params,
                        image) for s in (1, 2, 3)]
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    dec = _decoder(route)
    want = [dec.decode(d)[0] for d in datas]
    got = dec.decode_batch(datas)
    for (g, _), w_ in zip(got, want):
        assert isinstance(g, np.ndarray)
        assert np.array_equal(g, w_)


def test_encode_batch_pipelined_device_path(rng):
    """Batch encode: byte-identical to per-frame encodes, including a
    noise frame that overflows the tier-1 capacity mid-batch (re-run
    synchronously through the tier chain without disturbing its
    neighbors)."""
    h, w = 64, 80
    params = Parameters(quality=98, restart_interval=4)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    frames = [make_test_rgb(h, w, seed=1).reshape(-1),
              rng.integers(0, 256, h * w * 3, dtype=np.uint8),
              make_test_rgb(h, w, seed=2).reshape(-1)]
    enc = Encoder(backend="jax")
    want = [enc.encode(f, params, image) for f in frames]
    got = enc.encode_batch(frames, params, image)
    assert got == want
    assert enc.stats.host_frames == 0


def test_decode_wcap_bucketing_reuses_executable(monkeypatch):
    """Two frames of one geometry whose busiest segments differ in size
    must land in one wcap bucket and reuse ONE compiled decode pipeline
    (without bucketing, every video frame whose max segment grew would
    recompile); a drastically busier stream may open a second bucket but
    must still decode correctly."""
    import gpujpeg_jax.ops.jax_pipeline as jp
    import gpujpeg_jax.models.decoder as dmod
    h, w = 64, 80
    params = Parameters(quality=85, restart_interval=4)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    enc = Encoder(backend="golden")
    d1 = enc.encode(make_test_rgb(h, w, seed=1).reshape(-1), params, image)
    d2 = enc.encode(make_test_rgb(h, w, seed=2).reshape(-1), params, image)
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    dec = _decoder("kernel")
    r1, _ = dec.decode(d1)
    assert len(jp._DEC_CACHE) == 1
    r2, _ = dec.decode(d2)
    assert len(jp._DEC_CACHE) == 1, "same-family frame recompiled"
    # noise at Q98 blows far past the smooth frames' bucket
    import dataclasses
    rng = np.random.default_rng(3)
    noisy = rng.integers(0, 256, h * w * 3, dtype=np.uint8)
    d3 = enc.encode(noisy, dataclasses.replace(params, quality=98), image)
    r3, _ = dec.decode(d3)
    ref3, _ = Decoder(backend="golden").decode(d3)
    assert np.abs(r3.astype(int) - ref3.astype(int)).max() <= 1
    assert psnr(np.asarray(r1).reshape(h, w, 3),
                make_test_rgb(h, w, seed=1)) > 30


def test_decoder_init_warms_real_content_bucket(monkeypatch):
    """Decoder.init() must warm the wcap bucket REAL content lands in:
    decoding a natural-statistics frame right after init() must not
    grow the executable cache (an all-zero warm frame compresses to
    almost nothing, lands in a smaller bucket, and leaves the first real
    frame to pay a fresh compile)."""
    import gpujpeg_jax.ops.jax_pipeline as jp
    import gpujpeg_jax.models.decoder as dmod
    h, w = 64, 80
    params = Parameters(quality=75, restart_interval=8)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    dec = _decoder("kernel")
    dec.init(params, image)
    warmed = len(jp._DEC_CACHE)
    assert warmed >= 1
    data = Encoder(backend="golden").encode(
        make_test_rgb(h, w, seed=3).reshape(-1), params, image)
    raw, _ = dec.decode(data)
    assert len(jp._DEC_CACHE) == warmed, \
        "first real-content decode after init() compiled a new executable"
    assert psnr(np.asarray(raw).reshape(h, w, 3),
                make_test_rgb(h, w, seed=3)) > 30


def test_encode_batch_fused_chunks(rng, monkeypatch):
    """Fused B-frame launches (leading batch dim via vmap over the
    encode context): multi-chunk, odd tail (padded, outputs dropped)
    and an overflow frame mid-chunk — byte-identical to per-frame."""
    monkeypatch.setenv("GPUJPEG_BATCH_FRAMES", "2")
    h, w = 64, 80
    params = Parameters(quality=95, restart_interval=4)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    frames = [make_test_rgb(h, w, seed=s).reshape(-1) for s in range(4)]
    frames.insert(2, rng.integers(0, 256, h * w * 3, dtype=np.uint8))
    enc = Encoder(backend="jax")
    want = [enc.encode(f, params, image) for f in frames]
    got = enc.encode_batch(frames, params, image)
    assert got == want


def test_device_words_transcode_chain():
    """decode_to_device's device-resident raw image feeds the encoder
    directly (no host round trip): the re-encoded stream must byte-match
    encoding the same bytes from the host."""
    import gpujpeg_jax.models.decoder as dmod
    h, w = 128, 512
    img = make_test_rgb(h, w, seed=31)
    params = Parameters(quality=75, restart_interval=32, interleaved=False)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder(backend="jax").encode(img.reshape(-1), params, image)
    old = dmod.CPU_SEGMENT_THRESHOLD
    dmod.CPU_SEGMENT_THRESHOLD = 0
    try:
        dec = _decoder("kernel")
        raw_dev, _ = dec.decode_to_device(data)
        assert not isinstance(raw_dev, np.ndarray)   # stayed on device
        assert raw_dev.dtype.name == "uint8"
        data2 = Encoder(backend="jax").encode(raw_dev, params, image)
        host_bytes = np.asarray(raw_dev).reshape(-1)
        want = Encoder(backend="jax").encode(host_bytes, params, image)
    finally:
        dmod.CPU_SEGMENT_THRESHOLD = old
    assert data2 == want
