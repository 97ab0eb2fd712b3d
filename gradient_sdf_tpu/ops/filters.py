"""Small image filters: median blur and bilinear sampling.

The reference uses cv::medianBlur(depth, 5) before fusion
(`MapGradPixelSdf.cpp:53` — note the reference computes `med_depth` but its
pixel loop reads the raw depth, so the filter is dead code there; here it is
wired behind `FusionConfig.median_blur_depth`, default off for parity) and
hand-rolled bilinear sampling with finite-difference image gradients in
PhotoBA (`PhotometricOptimizer.cpp:57-139`). Both become XLA-native here:
the median as a fixed 25-element sorting network via jnp.sort over a patch
axis, the sampler as a gather + lerp whose analytic derivative equals the
reference's bilinearly-weighted forward differences in the interior.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def median_blur(img: jax.Array, ksize: int = 5) -> jax.Array:
    """Median filter with BORDER_REFLECT_101 (matches cv::medianBlur).

    Builds the k^2 shifted views along a new axis and takes the middle order
    statistic with jnp.sort — k^2 is tiny (25) so this is a bandwidth-bound
    elementwise op, no data-dependent control flow.
    """
    r = ksize // 2
    padded = jnp.pad(img, r, mode="reflect")
    h, w = img.shape
    patches = [
        jax.lax.dynamic_slice(padded, (dy, dx), (h, w))
        for dy in range(ksize)
        for dx in range(ksize)
    ]
    stack = jnp.stack(patches, axis=-1)
    return jnp.sort(stack, axis=-1)[..., (ksize * ksize) // 2]


def bilinear_sample_grad(img: jax.Array, u: jax.Array, v: jax.Array):
    """Bilinear sample + analytic image gradient (the framework's single
    image sampler; PhotoBA's intensity/Jacobian source).

    img: [H, W, C]; u/v: (…,) pixel coords (u = x/col, v = y/row).
    Returns (A (…,C), dAdu (…,C), dAdv (…,C), in_bounds (…,)).

    In-bounds test matches the reference (0 <= u < W, 0 <= v < H,
    `PhotometricOptimizer.cpp:176-178`); out-of-bounds samples clamp to the
    border and callers discard them via the mask. Interior gradients equal
    the reference's bilinearly-weighted forward differences
    (`computeImageGradient`, PhotometricOptimizer.cpp:81-139).
    """
    H, W = img.shape[0], img.shape[1]
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    uc = jnp.clip(u, 0.0, W - 1.000001)
    vc = jnp.clip(v, 0.0, H - 1.000001)
    u0 = jnp.floor(uc).astype(jnp.int32)
    v0 = jnp.floor(vc).astype(jnp.int32)
    u1 = jnp.minimum(u0 + 1, W - 1)
    v1 = jnp.minimum(v0 + 1, H - 1)
    fu = (uc - u0)[..., None]
    fv = (vc - v0)[..., None]
    i00 = img[v0, u0]
    i01 = img[v0, u1]
    i10 = img[v1, u0]
    i11 = img[v1, u1]
    top = i00 + fu * (i01 - i00)
    bot = i10 + fu * (i11 - i10)
    A = top + fv * (bot - top)
    dAdu = (1 - fv) * (i01 - i00) + fv * (i11 - i10)
    dAdv = (1 - fu) * (i10 - i00) + fu * (i11 - i01)
    return A, dAdu, dAdv, inb
