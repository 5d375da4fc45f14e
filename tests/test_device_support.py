"""What the program needs from the machine it runs on: the device check,
the peak table, the compile-cache location, window extraction at the
engine's widths, and plots that need no plotting library."""

import struct
import sys
import zlib

import jax
import numpy as np
import pytest

import bench
import chip_smoke
from viso_tpu.geometry import sampling
from viso_tpu.ops import stereo
from viso_tpu.utils import compile_cache


def test_peak_table_resolves_h100():
    p = bench.peaks("NVIDIA H100 80GB HBM3")
    assert p["f32_flops"] == 67e12
    assert p["hbm_bytes_s"] == 3.35e12


def test_peak_table_rejects_unknown_device():
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peaks("cpu")


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    a = compile_cache.cache_dir()
    b = compile_cache.cache_dir()
    assert a == b
    root = __file__.rsplit("/tests/", 1)[0]
    assert a == f"{root}/.jax_cache"


def test_chip_smoke_device_check_rejects_cpu():
    with pytest.raises(RuntimeError, match="expected a GPU"):
        chip_smoke.check_device(jax.devices("cpu")[0])


def test_dryrun_multichip_needs_its_devices():
    import __graft_entry__

    with pytest.raises(RuntimeError, match="need 64 devices"):
        __graft_entry__.dryrun_multichip(64)


# Window sizes of direct (10, 16, 24), lk (24) and the stereo matcher's
# left windows (12) at 1240x376.
@pytest.mark.parametrize("win", [10, 12, 16, 24])
def test_extraction_matches_numpy_at_kitti_width(win):
    rng = np.random.default_rng(win)
    H, W, N = 376, 1240, 512
    img = rng.integers(0, 256, (H, W)).astype(np.float32)
    centers = np.stack(
        [rng.uniform(-4, W + 4, N), rng.uniform(-4, H + 4, N)], -1
    ).astype(np.float32)
    got, base = jax.jit(sampling.extract_windows, static_argnums=2)(
        img, centers, win
    )
    ref_base, ref = chip_smoke.numpy_windows(img, centers, win)
    assert np.array_equal(np.asarray(base), ref_base)
    assert np.array_equal(np.asarray(got), np.stack(ref))


def test_stereo_strips_match_numpy_at_kitti_width():
    rng = np.random.default_rng(1)
    H, W, N = 376, 1240, 512
    h, w = chip_smoke.STRIP_HW
    img = rng.integers(0, 256, (H, W)).astype(np.float32)
    bx = rng.integers(0, W - w + 1, N).astype(np.int32)
    by = rng.integers(0, H - h + 1, N).astype(np.int32)
    got = jax.jit(stereo.scanline_strips, static_argnums=(3, 4))(
        img, bx, by, h, w
    )
    ref = np.stack([img[y:y + h, x:x + w] for x, y in zip(bx, by)])
    assert np.array_equal(np.asarray(got), ref)


def _png_size(path):
    """(width, height, color type) of a PNG, checking its chunks' CRCs
    and that the pixel data inflates to the declared size."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    channels = {0: 1, 2: 3}[ctype]
    assert len(zlib.decompress(chunks[b"IDAT"])) == h * (1 + w * channels)
    return w, h, ctype


def test_plots_need_no_matplotlib(monkeypatch, tmp_path):
    from viso_tpu.geometry import se3
    from viso_tpu.utils import viz

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    n = 20
    R = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    t = np.stack([[0.1 * i, 0.0, -0.5 * i] for i in range(n)]).astype(
        np.float32
    )
    R_gt, t_gt = se3.se3_exp(np.zeros(6, np.float32))
    p = viz.plot_trajectory(
        R, t, np.broadcast_to(np.asarray(R_gt), R.shape), t * 1.1,
        path=str(tmp_path / "trajectory.png"),
    )
    w, h, ctype = _png_size(p)
    assert (w, h, ctype) == (840, 840, 2)
    pts = np.random.default_rng(0).normal(0, 5, (64, 3))
    p = viz.plot_map_topdown(
        pts, np.ones(64, bool), kf_R=R[:4], kf_t=t[:4],
        path=str(tmp_path / "map.png"),
    )
    assert _png_size(p)[2] == 2
