"""Device DCT/IDCT as matrix products.

A redesign of the reference's warp-butterfly AAN kernels (reference:
src/gpujpeg_dct_gpu.cu:180-294 forward, :472-618 inverse): instead of an
8-point butterfly per thread, the whole 2-D 8x8 DCT is one (64, 64)
linear operator (the Kronecker square of the 1-D DCT-II matrix) applied
to flattened blocks — a single (N, 64) @ (64, 64) float32 product at
``Precision.HIGHEST`` (true fp32, not TF32: byte identity with the
golden coder depends on it). Quantization (division by the quality-scaled
table) folds into the operator's columns exactly like the reference
pre-divides its table (gpujpeg_table.c:112-120); the -128 level shift
folds into a bias; the zig-zag permutation folds into the row order so
coefficients come out entropy-ready with no gather.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..tables import dct_zigzag_operator


@functools.lru_cache(maxsize=1)
def fdct_split_operator() -> tuple[np.ndarray, np.ndarray]:
    """The zig-zag forward DCT operator (tables.dct_zigzag_operator) split
    as ``D_hi + D_lo`` in float32: ``D_hi`` on a 2^-11 grid, so for
    centered pixels (|x| <= 128) every partial sum of ``x @ D_hi`` is a
    multiple of 2^-11 below 2^13 and the product is exact in float32 in
    any summation order; ``D_lo`` (|D_lo| <= 2^-12) is the remainder."""
    D64 = dct_zigzag_operator()
    hi = np.round(D64 * 2048.0) / 2048.0
    return hi.astype(np.float32), (D64 - hi).astype(np.float32)


def fdct_quant_rows(blocks_u8: jax.Array, d_hi: jax.Array, d_lo: jax.Array,
                    qdiv: jax.Array) -> jax.Array:
    """(N, 64) uint8 pixel blocks -> (N, 64) int32 quantized zig-zag
    coefficients ``rint(DCT / qdiv)``; ``qdiv`` (N, 64) or (64,) float32
    quant steps, a runtime value (XLA strength-reduces divides by
    embedded constants, changing the rounding).

    A plain float32 product rounds its partial sums (up to ~2e-4 absolute
    at 8 bits of input), which flips ~1e-4 of the quotients of
    photographic content against the float64 golden operator. Here the
    exact ``x @ D_hi`` carries the magnitude, the small ``x @ D_lo`` the
    rest, and the quotient is rounded from the exact remainder
    ``x @ D_hi - k0 * q``, so the result is off the exact DCT by ~1e-6
    before the division."""
    x = blocks_u8.astype(jnp.float32) - 128.0

    def dot(a, b):
        return jax.lax.dot_general(
            a, b, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)

    s_hi = dot(x, d_hi)
    s_lo = dot(x, d_lo)
    k0 = jnp.rint(s_hi / qdiv)
    rem = (s_hi - k0 * qdiv) + s_lo
    return (k0 + jnp.rint(rem / qdiv)).astype(jnp.int32)


@functools.lru_cache(maxsize=1)
def idct_split_operator() -> tuple[np.ndarray, np.ndarray]:
    """The inverse DCT operator (zig-zag coefficient -> natural pixel; the
    transpose of the orthonormal forward operator) split as
    ``D_hi + D_lo`` in float32, ``D_hi`` on a 2^-9 grid: for dequantized
    coefficients below 2^11 (every valid stream) each partial sum of
    ``dq @ D_hi`` is a multiple of 2^-9 below 2^15, exact in float32."""
    D64 = dct_zigzag_operator()
    inv = D64.T
    hi = np.round(inv * 512.0) / 512.0
    return hi.astype(np.float32), (inv - hi).astype(np.float32)


def dequant_idct_device(coeff: jax.Array, q: jax.Array, d_hi: jax.Array,
                        d_lo: jax.Array) -> jax.Array:
    """(N, 64) int coeffs (zig-zag) -> (N, 64) uint8 pixels (natural
    order). ``q`` (64,) float32 quant steps; ``d_hi``/``d_lo`` from
    :func:`idct_split_operator`. The pixel is rounded from the exact
    ``dq @ D_hi`` and the small ``dq @ D_lo`` (as in
    :func:`fdct_quant_rows`), so it matches the float64 golden decode
    except within ~1e-6 of a .5 tie."""
    dq = coeff.astype(jnp.float32) * q

    def dot(a, b):
        return jax.lax.dot_general(
            a, b, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)

    v = dot(dq, d_hi) + 128.0
    k0 = jnp.rint(v)
    rem = (v - k0) + dot(dq, d_lo)
    return jnp.clip(k0 + jnp.rint(rem), 0.0, 255.0).astype(jnp.uint8)
