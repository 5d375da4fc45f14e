"""Batched bilinear image sampling and gradients.

Batched replacement for the reference's scalar samplers
(`/root/reference/include/common.h:35-59` — `GetPixelValue` bilinear
interpolation and `GetImageGradient{,X,Y}` central differences, duplicated
as `Keyframe` methods at `include/keyframe.h:50-64`).

Images are float arrays (H, W). Sample positions are float pixel
coordinates (..., 2) in (u=x=col, v=y=row) order, matching the reference.
Out-of-bounds coordinates are clamped (the reference clamps too,
common.h:37-38); callers combine with `camera.is_inside` masks.

The point samplers are gather-based and `vmap`-free by construction: they
accept arbitrary batch shapes of coordinates directly, so XLA sees one big
gather rather than many small ones.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _gather(img, yi, xi):
    """img (H, W); yi, xi int arrays of identical batch shape -> values."""
    H, W = img.shape[-2], img.shape[-1]
    yi = jnp.clip(yi, 0, H - 1)
    xi = jnp.clip(xi, 0, W - 1)
    flat = img.reshape(img.shape[:-2] + (H * W,))
    return jnp.take(flat, yi * W + xi, axis=-1)


def bilinear(img, uv):
    """Bilinear sample img (H, W) at uv (..., 2) -> (...,). Ref common.h:35-42."""
    u = uv[..., 0]
    v = uv[..., 1]
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = u - x0
    fy = v - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    v00 = _gather(img, y0i, x0i)
    v01 = _gather(img, y0i, x0i + 1)
    v10 = _gather(img, y0i + 1, x0i)
    v11 = _gather(img, y0i + 1, x0i + 1)
    return (
        (1 - fx) * (1 - fy) * v00
        + fx * (1 - fy) * v01
        + (1 - fx) * fy * v10
        + fx * fy * v11
    )


def bilinear_with_grad(img, uv):
    """Bilinear value AND exact surface gradient from the SAME 4 gathers.

    Returns (value (...,), grad (..., 2)). The derivative of the bilinear
    interpolant is
        dI/du = (1-fy)(v01 - v00) + fy(v11 - v10)
        dI/dv = (1-fx)(v10 - v00) + fx(v11 - v01)
    Central differences (the reference's estimator, common.h:44-59) cost
    4 extra bilinear evaluations = 16 extra gathers per sample, so this
    4-gather fused form is the one hot paths must use.
    """
    u = uv[..., 0]
    v = uv[..., 1]
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = u - x0
    fy = v - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    v00 = _gather(img, y0i, x0i)
    v01 = _gather(img, y0i, x0i + 1)
    v10 = _gather(img, y0i + 1, x0i)
    v11 = _gather(img, y0i + 1, x0i + 1)
    val = (
        (1 - fx) * (1 - fy) * v00
        + fx * (1 - fy) * v01
        + (1 - fx) * fy * v10
        + fx * fy * v11
    )
    gx = (1 - fy) * (v01 - v00) + fy * (v11 - v10)
    gy = (1 - fx) * (v10 - v00) + fx * (v11 - v01)
    return val, jnp.stack([gx, gy], axis=-1)


def bilinear_indexed_with_grad(imgs, k, uv):
    """`bilinear_with_grad` over a stacked image set with per-item index.

    imgs: (K, H, W); k: (N,); uv: (N, ..., 2). Returns (val, grad).
    """
    K, H, W = imgs.shape
    flat = imgs.reshape(K * H * W)
    u = uv[..., 0]
    v = uv[..., 1]
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = u - x0
    fy = v - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 2)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 2)
    extra = uv.ndim - 2
    k_b = k.reshape((k.shape[0],) + (1,) * extra)
    i00 = k_b * (H * W) + y0i * W + x0i
    v00 = jnp.take(flat, i00)
    v01 = jnp.take(flat, i00 + 1)
    v10 = jnp.take(flat, i00 + W)
    v11 = jnp.take(flat, i00 + W + 1)
    val = (
        (1 - fx) * (1 - fy) * v00
        + fx * (1 - fy) * v01
        + (1 - fx) * fy * v10
        + fx * fy * v11
    )
    gx = (1 - fy) * (v01 - v00) + fy * (v11 - v10)
    gy = (1 - fx) * (v10 - v00) + fx * (v11 - v01)
    return val, jnp.stack([gx, gy], axis=-1)


# ---------------------------------------------------------------------------
# Windowed sampling.
#
# (1) Extract one contiguous window per feature with a *batched
#     dynamic_slice* (N block copies instead of N*P*P*4 element gathers),
# (2) inside iteration loops, evaluate bilinear samples as SEPARABLE
#     hat-function weight matmuls against the cached windows — dense
#     arithmetic, zero gathers.
# ---------------------------------------------------------------------------


def extract_windows(img, centers, win: int):
    """Per-feature square windows via batched dynamic_slice.

    img (H, W); centers (N, 2) float. Returns (windows (N, win, win),
    base (N, 2) int32 window origins as (x0, y0)). The slices carry the
    `extract_windows` name scope in profiler traces.
    """
    H, W = img.shape
    base = jnp.floor(centers).astype(jnp.int32) - win // 2
    base = jnp.clip(
        base, jnp.zeros(2, jnp.int32), jnp.array([W - win, H - win], jnp.int32)
    )

    def one(b):
        return jax.lax.dynamic_slice(img, (b[1], b[0]), (win, win))

    with jax.named_scope("extract_windows"):
        return jax.vmap(one)(base), base


def extract_windows_indexed(imgs, k, centers, win: int):
    """`extract_windows` over a stacked image set (K, H, W) with per-item
    image index k (N,)."""
    K, H, W = imgs.shape
    base = jnp.floor(centers).astype(jnp.int32) - win // 2
    base = jnp.clip(
        base, jnp.zeros(2, jnp.int32), jnp.array([W - win, H - win], jnp.int32)
    )

    def one(ki, b):
        return jax.lax.dynamic_slice(imgs, (ki, b[1], b[0]), (1, win, win))[0]

    with jax.named_scope("extract_windows"):
        return jax.vmap(one)(k, base), base


def _hat_weights(coords, win: int):
    """Linear-interpolation weights (N, S, win) for 1-D coords (N, S).

    Row r of the weight matrix is the hat function max(0, 1 - |c - r|):
    exactly bilinear interpolation, as a dense matmul operand.
    """
    grid = jnp.arange(win, dtype=coords.dtype)
    return jnp.maximum(0.0, 1.0 - jnp.abs(coords[..., None] - grid))


def _hat_weights_grad(coords, win: int):
    """d/dc of `_hat_weights`: -sign(c - r) on the hat support."""
    grid = jnp.arange(win, dtype=coords.dtype)
    d = coords[..., None] - grid
    return jnp.where(jnp.abs(d) < 1.0, -jnp.sign(d), 0.0)


def sample_windows(windows, base, uv):
    """Bilinear samples from cached windows — no gathers.

    windows (N, win, win); base (N, 2); uv (N, P, Q, 2) absolute image
    coords (P/Q arbitrary sample grid dims). Returns (N, P, Q).
    Coordinates outside a window are clamped to its border.
    """
    rows, win = windows.shape[-2], windows.shape[-1]
    n, P, Q = uv.shape[0], uv.shape[1], uv.shape[2]
    us = jnp.clip(uv[..., 0] - base[:, None, None, 0], 0.0, win - 1.0)
    vs = jnp.clip(uv[..., 1] - base[:, None, None, 1], 0.0, rows - 1.0)
    # Separable: rows of the sample grid share v per row and u per column
    # only for axis-aligned grids; keep it general with flattened samples.
    us_f = us.reshape(n, P * Q)
    vs_f = vs.reshape(n, P * Q)
    Wx = _hat_weights(us_f, win)
    Wy = _hat_weights(vs_f, rows)
    vals = jnp.einsum("nsy,nyx,nsx->ns", Wy, windows, Wx)
    return vals.reshape(n, P, Q)


def sample_windows_with_grad(windows, base, uv):
    """Samples + exact bilinear-surface gradients from cached windows."""
    rows, win = windows.shape[-2], windows.shape[-1]
    n, P, Q = uv.shape[0], uv.shape[1], uv.shape[2]
    us = jnp.clip(uv[..., 0] - base[:, None, None, 0], 0.0, win - 1.0)
    vs = jnp.clip(uv[..., 1] - base[:, None, None, 1], 0.0, rows - 1.0)
    us_f = us.reshape(n, P * Q)
    vs_f = vs.reshape(n, P * Q)
    Wx = _hat_weights(us_f, win)
    Wy = _hat_weights(vs_f, rows)
    dWx = _hat_weights_grad(us_f, win)
    dWy = _hat_weights_grad(vs_f, rows)
    Ty = jnp.einsum("nsy,nyx->nsx", Wy, windows)     # shared row pass
    vals = jnp.einsum("nsx,nsx->ns", Ty, Wx)
    gx = jnp.einsum("nsx,nsx->ns", Ty, dWx)
    Tdy = jnp.einsum("nsy,nyx->nsx", dWy, windows)
    gy = jnp.einsum("nsx,nsx->ns", Tdy, Wx)
    g = jnp.stack([gx, gy], axis=-1)
    return vals.reshape(n, P, Q), g.reshape(n, P, Q, 2)


def _axis_coords(windows, base, centers, half):
    """Per-axis window-relative sample coordinates for an axis-aligned
    (2*half, 2*half) patch grid centered at `centers`.

    Returns (us (N, P), vs (N, P)) clamped to the window, P = 2*half —
    identical per-axis clamping to `sample_windows` on the same grid.
    Windows may be rectangular (rows != cols).
    """
    rows, win = windows.shape[-2], windows.shape[-1]
    r = jnp.arange(-half, half, dtype=centers.dtype)
    us = jnp.clip(centers[:, 0:1] - base[:, 0:1] + r[None], 0.0, win - 1.0)
    vs = jnp.clip(centers[:, 1:2] - base[:, 1:2] + r[None], 0.0, rows - 1.0)
    return us, vs


def sample_patch_grid(windows, base, centers, half: int):
    """Bilinear patch samples from cached windows, SEPARABLE form.

    Equivalent to `sample_windows(windows, base, centers + patch_offsets)`
    but exploits that the grid is axis-aligned: every patch row shares v
    and every column shares u, so the hat-weight operands are (N, P, win)
    instead of (N, P*P, win) — 2*half-fold less weight traffic, and the
    two 1-D passes are clean batched matmuls.

    windows (N, win, win); base (N, 2); centers (N, 2) absolute image
    coords. Returns (N, P, P), rows indexed by v, columns by u.
    """
    us, vs = _axis_coords(windows, base, centers, half)
    rows, win = windows.shape[-2], windows.shape[-1]
    Wu = _hat_weights(us, win)                     # (N, P, win)
    Wv = _hat_weights(vs, rows)
    Ty = jnp.einsum("npy,nyx->npx", Wv, windows)   # rows pass
    return jnp.einsum("npx,nqx->npq", Ty, Wu)      # cols pass


def sample_patch_grid_with_grad(windows, base, centers, half: int):
    """Separable patch samples plus exact bilinear-surface gradients.

    Returns (vals (N, P, P), gx (N, P, P), gy (N, P, P)); gradients come
    as separate planes rather than a stacked (..., 2)."""
    us, vs = _axis_coords(windows, base, centers, half)
    rows, win = windows.shape[-2], windows.shape[-1]
    Wu = _hat_weights(us, win)
    Wv = _hat_weights(vs, rows)
    dWu = _hat_weights_grad(us, win)
    dWv = _hat_weights_grad(vs, rows)
    Ty = jnp.einsum("npy,nyx->npx", Wv, windows)
    vals = jnp.einsum("npx,nqx->npq", Ty, Wu)
    gx = jnp.einsum("npx,nqx->npq", Ty, dWu)
    Tdy = jnp.einsum("npy,nyx->npx", dWv, windows)
    gy = jnp.einsum("npx,nqx->npq", Tdy, Wu)
    return vals, gx, gy


def sample_patch_grid_scaled(windows, base, centers, half: int, scale):
    """`sample_patch_grid` with per-item grid SPACING (values only).

    Sample coords = centers + r * scale, r in [-half, half), scale (N,).
    Used by templated direct tracking: the frozen keyframe template's
    pixel pitch in the current image scales with the keyframe/current
    depth ratio, so the current patch must be sampled at that pitch or
    forward motion biases the photometric GN (observed: 10x ATE).
    """
    rows, win = windows.shape[-2], windows.shape[-1]
    r = jnp.arange(-half, half, dtype=centers.dtype)
    us = jnp.clip(
        centers[:, 0:1] - base[:, 0:1] + r[None] * scale[:, None],
        0.0, win - 1.0,
    )
    vs = jnp.clip(
        centers[:, 1:2] - base[:, 1:2] + r[None] * scale[:, None],
        0.0, rows - 1.0,
    )
    Wu = _hat_weights(us, win)
    Wv = _hat_weights(vs, rows)
    Ty = jnp.einsum("npy,nyx->npx", Wv, windows)
    return jnp.einsum("npx,nqx->npq", Ty, Wu)


def sample_patch_grid_scaled_with_grad(windows, base, centers, half: int,
                                       scale):
    """`sample_patch_grid_with_grad` with per-item grid SPACING.

    Sample coords = centers + r * scale, r in [-half, half), scale (N,) —
    the scale-warped patch footprint photometric BA uses (the template's
    pixel pitch in the current image scales with the anchor/current depth
    ratio). Gradients are wrt the IMAGE coordinate (not the patch index):
    d(value)/du at each sample point, so chain rules compose unchanged.

    Returns (vals (N, P, P), gx (N, P, P), gy (N, P, P)).
    """
    rows, win = windows.shape[-2], windows.shape[-1]
    r = jnp.arange(-half, half, dtype=centers.dtype)
    us = jnp.clip(
        centers[:, 0:1] - base[:, 0:1] + r[None] * scale[:, None],
        0.0, win - 1.0,
    )
    vs = jnp.clip(
        centers[:, 1:2] - base[:, 1:2] + r[None] * scale[:, None],
        0.0, rows - 1.0,
    )
    Wu = _hat_weights(us, win)
    Wv = _hat_weights(vs, rows)
    dWu = _hat_weights_grad(us, win)
    dWv = _hat_weights_grad(vs, rows)
    Ty = jnp.einsum("npy,nyx->npx", Wv, windows)
    vals = jnp.einsum("npx,nqx->npq", Ty, Wu)
    gx = jnp.einsum("npx,nqx->npq", Ty, dWu)
    Tdy = jnp.einsum("npy,nyx->npx", dWv, windows)
    gy = jnp.einsum("npx,nqx->npq", Tdy, Wu)
    return vals, gx, gy


def gradient(img, uv, delta: float = 1.0):
    """Central-difference image gradient at uv (..., 2) -> (..., 2) [gx, gy].

    Ref common.h:44-59 uses half-pixel central differences on the bilinear
    surface; we use +-delta (default 1 px) central differences of the
    bilinear interpolant, which is the same estimator family.
    """
    du = jnp.stack([jnp.full_like(uv[..., 0], delta), jnp.zeros_like(uv[..., 0])], axis=-1)
    dv = jnp.stack([jnp.zeros_like(uv[..., 0]), jnp.full_like(uv[..., 0], delta)], axis=-1)
    gx = (bilinear(img, uv + du) - bilinear(img, uv - du)) / (2.0 * delta)
    gy = (bilinear(img, uv + dv) - bilinear(img, uv - dv)) / (2.0 * delta)
    return jnp.stack([gx, gy], axis=-1)


def patch_offsets(half: int, dtype=jnp.float32):
    """Dense (2*half, 2*half, 2) grid of integer offsets in [-half, half).

    Matches the reference's patch convention `for x in [-half, half) for y
    in [-half, half)` (viso.cpp:269-276): an 8x8 patch for half=4.
    """
    r = jnp.arange(-half, half, dtype=dtype)
    oy, ox = jnp.meshgrid(r, r, indexing="ij")
    return jnp.stack([ox, oy], axis=-1)  # (P, P, 2) in (du, dv) order


def sample_patches(img, centers, half: int):
    """Sample square patches around centers.

    img: (H, W); centers: (N, 2) float pixel coords.
    Returns (N, 2*half, 2*half) bilinear patch values.
    """
    offs = patch_offsets(half, dtype=centers.dtype)  # (P, P, 2)
    uv = centers[:, None, None, :] + offs[None]  # (N, P, P, 2)
    return bilinear(img, uv)


def bilinear_indexed(imgs, k, uv):
    """Bilinear sample from a *stack* of images with a per-item index.

    imgs: (K, H, W); k: (N,) int32 image indices; uv: (N, ..., 2).
    Used by map-to-frame alignment where each pair reads its own
    best-viewing reference keyframe (ref viso.cpp:768-843) — one flat
    gather instead of N image copies.
    """
    K, H, W = imgs.shape
    flat = imgs.reshape(K * H * W)
    u = uv[..., 0]
    v = uv[..., 1]
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = u - x0
    fy = v - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 2)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 2)
    extra = uv.ndim - 2  # batch dims beyond N
    k_b = k.reshape((k.shape[0],) + (1,) * extra)
    base = k_b * (H * W)
    i00 = base + y0i * W + x0i
    v00 = jnp.take(flat, i00)
    v01 = jnp.take(flat, i00 + 1)
    v10 = jnp.take(flat, i00 + W)
    v11 = jnp.take(flat, i00 + W + 1)
    return (
        (1 - fx) * (1 - fy) * v00
        + fx * (1 - fy) * v01
        + (1 - fx) * fy * v10
        + fx * fy * v11
    )


def gradient_indexed(imgs, k, uv, delta: float = 1.0):
    """Central-difference gradient of `bilinear_indexed` samples (..., 2)."""
    du = jnp.stack([jnp.full_like(uv[..., 0], delta), jnp.zeros_like(uv[..., 0])], axis=-1)
    dv = jnp.stack([jnp.zeros_like(uv[..., 0]), jnp.full_like(uv[..., 0], delta)], axis=-1)
    gx = (bilinear_indexed(imgs, k, uv + du) - bilinear_indexed(imgs, k, uv - du)) / (2 * delta)
    gy = (bilinear_indexed(imgs, k, uv + dv) - bilinear_indexed(imgs, k, uv - dv)) / (2 * delta)
    return jnp.stack([gx, gy], axis=-1)


def sample_patches_with_grad(img, centers, half: int):
    """Patches plus per-pixel gradients: (N,P,P), (N,P,P,2)."""
    offs = patch_offsets(half, dtype=centers.dtype)
    uv = centers[:, None, None, :] + offs[None]
    return bilinear(img, uv), gradient(img, uv)
