"""Windowed (zero-gather) sampling must agree with gather-based bilinear."""

import jax.numpy as jnp
import numpy as np

from viso_tpu.geometry import sampling


def test_windowed_matches_gather(rng):
    img = jnp.asarray(rng.uniform(0, 255, (96, 128)).astype(np.float32))
    n = 64
    centers = jnp.asarray(
        np.stack([rng.uniform(12, 116, n), rng.uniform(12, 84, n)], -1).astype(
            np.float32
        )
    )
    offs = sampling.patch_offsets(4, jnp.float32)
    uv = centers[:, None, None, :] + offs[None]
    ref = sampling.bilinear(img, uv)
    win, base = sampling.extract_windows(img, centers, 24)
    out = sampling.sample_windows(win, base, uv)
    assert np.allclose(np.asarray(out), np.asarray(ref), atol=1e-3)


def test_windowed_grad_matches_gather(rng):
    img = jnp.asarray(rng.uniform(0, 255, (96, 128)).astype(np.float32))
    n = 32
    centers = jnp.asarray(
        np.stack([rng.uniform(12, 116, n), rng.uniform(12, 84, n)], -1).astype(
            np.float32
        )
    )
    offs = sampling.patch_offsets(4, jnp.float32)
    uv = centers[:, None, None, :] + offs[None]
    v_ref, g_ref = sampling.bilinear_with_grad(img, uv)
    win, base = sampling.extract_windows(img, centers, 24)
    v, g = sampling.sample_windows_with_grad(win, base, uv)
    assert np.allclose(np.asarray(v), np.asarray(v_ref), atol=1e-3)
    assert np.allclose(np.asarray(g), np.asarray(g_ref), atol=1e-2)


def test_windowed_indexed(rng):
    imgs = jnp.asarray(rng.uniform(0, 255, (3, 64, 80)).astype(np.float32))
    n = 24
    centers = jnp.asarray(
        np.stack([rng.uniform(12, 68, n), rng.uniform(12, 52, n)], -1).astype(
            np.float32
        )
    )
    k = jnp.asarray(rng.integers(0, 3, n), jnp.int32)
    offs = sampling.patch_offsets(3, jnp.float32)
    uv = centers[:, None, None, :] + offs[None]
    ref = sampling.bilinear_indexed(imgs, k, uv)
    win, base = sampling.extract_windows_indexed(imgs, k, centers, 20)
    out = sampling.sample_windows(win, base, uv)
    assert np.allclose(np.asarray(out), np.asarray(ref), atol=1e-3)


def test_window_edge_clamping(rng):
    # Centers near the border: windows clip to the image; samples inside
    # the image must still be exact.
    img = jnp.asarray(rng.uniform(0, 255, (48, 64)).astype(np.float32))
    centers = jnp.asarray([[5.0, 5.0], [60.0, 44.0]], jnp.float32)
    offs = sampling.patch_offsets(2, jnp.float32)
    uv = centers[:, None, None, :] + offs[None]
    ref = sampling.bilinear(img, uv)
    win, base = sampling.extract_windows(img, centers, 16)
    out = sampling.sample_windows(win, base, uv)
    assert np.allclose(np.asarray(out), np.asarray(ref), atol=1e-3)


def test_patch_grid_matches_flattened(rng):
    """Separable axis-aligned grid sampling == generic sample_windows."""
    img = jnp.asarray(rng.uniform(0, 255, (96, 128)).astype(np.float32))
    n = 64
    centers = jnp.asarray(
        np.stack([rng.uniform(2, 126, n), rng.uniform(2, 94, n)], -1).astype(
            np.float32
        )
    )
    offs = sampling.patch_offsets(4, jnp.float32)
    uv = centers[:, None, None, :] + offs[None]
    win, base = sampling.extract_windows(img, centers, 16)
    ref = sampling.sample_windows(win, base, uv)
    out = sampling.sample_patch_grid(win, base, centers, 4)
    assert np.allclose(np.asarray(out), np.asarray(ref), atol=1e-4)


def test_patch_grid_with_grad_matches_flattened(rng):
    img = jnp.asarray(rng.uniform(0, 255, (96, 128)).astype(np.float32))
    n = 48
    centers = jnp.asarray(
        np.stack([rng.uniform(2, 126, n), rng.uniform(2, 94, n)], -1).astype(
            np.float32
        )
    )
    offs = sampling.patch_offsets(3, jnp.float32)
    uv = centers[:, None, None, :] + offs[None]
    win, base = sampling.extract_windows(img, centers, 16)
    v_ref, g_ref = sampling.sample_windows_with_grad(win, base, uv)
    v, gx, gy = sampling.sample_patch_grid_with_grad(win, base, centers, 3)
    assert np.allclose(np.asarray(v), np.asarray(v_ref), atol=1e-4)
    assert np.allclose(np.asarray(gx), np.asarray(g_ref[..., 0]), atol=1e-3)
    assert np.allclose(np.asarray(gy), np.asarray(g_ref[..., 1]), atol=1e-3)


def test_rectangular_windows_match_square(rng):
    """Rectangular (R, C) windows at arbitrary origins (the shape of the
    stereo matcher's scanline strips) must sample identically to the
    exact square windows wherever both cover the patch."""
    H, W = 96, 160
    img = jnp.asarray(rng.uniform(0, 255, (H, W)).astype(np.float32))
    n = 64
    centers = jnp.asarray(
        np.stack([rng.uniform(12, W - 12, n), rng.uniform(12, H - 12, n)], -1)
        .astype(np.float32)
    )
    win = 16
    sq_win, sq_base = sampling.extract_windows(img, centers, win)
    # Rectangular window: origin rounded down to (8, 32), extent grown
    # to keep coverage.
    R, C = 24, 64
    bx = jnp.clip(sq_base[:, 0] & ~31, 0, W - C)
    by = jnp.clip(sq_base[:, 1] & ~7, 0, H - R)
    base = jnp.stack([bx, by], -1)

    def one(b):
        import jax

        return jax.lax.dynamic_slice(img, (b[1], b[0]), (R, C))

    import jax

    rect_win = jax.vmap(one)(base)
    for half in (3, 4):
        v_sq = sampling.sample_patch_grid(sq_win, sq_base, centers, half)
        v_rc = sampling.sample_patch_grid(rect_win, base, centers, half)
        assert np.allclose(np.asarray(v_rc), np.asarray(v_sq), atol=1e-4)
    v_sq, gx_s, gy_s = sampling.sample_patch_grid_with_grad(
        sq_win, sq_base, centers, 4
    )
    v_rc, gx_r, gy_r = sampling.sample_patch_grid_with_grad(
        rect_win, base, centers, 4
    )
    assert np.allclose(np.asarray(v_rc), np.asarray(v_sq), atol=1e-4)
    assert np.allclose(np.asarray(gx_r), np.asarray(gx_s), atol=1e-3)
    assert np.allclose(np.asarray(gy_r), np.asarray(gy_s), atol=1e-3)


def test_patch_grid_scaled_matches_flattened(rng):
    """Per-item scaled grid sampling == generic sample_windows on the
    same scaled coordinates (values and value+grad variants)."""
    img = jnp.asarray(rng.uniform(0, 255, (96, 128)).astype(np.float32))
    n = 40
    centers = jnp.asarray(
        np.stack([rng.uniform(16, 112, n), rng.uniform(16, 80, n)], -1)
        .astype(np.float32)
    )
    scale = jnp.asarray(rng.uniform(0.6, 1.8, n).astype(np.float32))
    half = 3
    offs = sampling.patch_offsets(half, jnp.float32)
    uv = centers[:, None, None, :] + offs[None] * scale[:, None, None, None]
    win, base = sampling.extract_windows(img, centers, 24)
    ref = sampling.sample_windows(win, base, uv)
    # Non-integer spacing changes the f32 summation order: ~1e-3 abs on
    # [0, 255] values is pure rounding, not a sampling-grid mismatch.
    out = sampling.sample_patch_grid_scaled(win, base, centers, half, scale)
    assert np.allclose(np.asarray(out), np.asarray(ref), atol=3e-3)
    v, gx, gy = sampling.sample_patch_grid_scaled_with_grad(
        win, base, centers, half, scale
    )
    assert np.allclose(np.asarray(v), np.asarray(ref), atol=3e-3)
    v_ref, g_ref = sampling.sample_windows_with_grad(win, base, uv)
    assert np.allclose(np.asarray(gx), np.asarray(g_ref[..., 0]), atol=5e-3)
    assert np.allclose(np.asarray(gy), np.asarray(g_ref[..., 1]), atol=5e-3)
