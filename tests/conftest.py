"""Test configuration: force JAX onto a virtual 8-device CPU mesh so the
multi-device sharding paths are testable without accelerator hardware.

Tests that need the GPU take the ``gpu_device`` fixture (marker ``gpu``):
whether a card is present is decided there, at run time, never while a
test module is imported."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked ``gpu``; skips where JAX has none
    (the CPU test run). Run them on the card with
    ``python -m pytest tests/test_huffman_kernel.py -m gpu`` without
    JAX_PLATFORMS=cpu."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: this test runs compiled kernels on the card")


def make_test_rgb(height: int, width: int, seed: int = 7) -> np.ndarray:
    """Natural-ish test image: smooth gradients + structured detail, so
    JPEG round-trip PSNR is meaningful (pure noise compresses terribly)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width]
    r = 128 + 90 * np.sin(x / 23.0) * np.cos(y / 17.0)
    g = 128 + 80 * np.cos(x / 31.0 + 1.0) * np.sin(y / 11.0)
    b = 128 + 70 * np.sin((x + y) / 41.0)
    img = np.stack([r, g, b], axis=-1)
    img += rng.normal(0, 3.0, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_natural_rgb(height: int, width: int, seed: int = 7) -> np.ndarray:
    """1080p-class color-oracle fixture with real-content statistics:
    detail lives in LUMA (all three channels move together) while chroma
    varies smoothly — like the reference's camera fixture
    (colors/image_bt709_422.yuv). Per-pixel RGB noise (make_test_rgb)
    puts energy into high-frequency chroma, which 4:2:0/4:2:2
    decimation must destroy; that is a fixture artifact, not a codec
    defect, and it is why a 40 dB bar needs natural chroma statistics
    (reference oracle: colors/test_common.sh:17)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width]
    # smooth chroma-bearing base
    r = 128 + 70 * np.sin(x / 97.0) * np.cos(y / 71.0)
    g = 128 + 60 * np.cos(x / 131.0 + 1.0) * np.sin(y / 83.0)
    b = 128 + 55 * np.sin((x + y) / 151.0)
    img = np.stack([r, g, b], axis=-1)
    # luma detail: coarse random field, bilinearly upsampled 8x, plus
    # mild high-frequency texture — added equally to R/G/B (chroma-free)
    ch, cw = -(-height // 8) + 1, -(-width // 8) + 1
    coarse = rng.normal(0, 22.0, (ch, cw))
    yy, xx = np.mgrid[0:height, 0:width]
    fy, fx = yy / 8.0, xx / 8.0
    y0, x0 = fy.astype(int), fx.astype(int)
    wy, wx = fy - y0, fx - x0
    up = ((1 - wy) * (1 - wx) * coarse[y0, x0]
          + (1 - wy) * wx * coarse[y0, x0 + 1]
          + wy * (1 - wx) * coarse[y0 + 1, x0]
          + wy * wx * coarse[y0 + 1, x0 + 1])
    detail = up + 6.0 * np.sin(x / 2.9) * np.sin(y / 3.7)
    img += detail[..., None]
    return np.clip(img, 0, 255).astype(np.uint8)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return 99.0
    return 10.0 * np.log10(255.0 ** 2 / mse)
