"""Device-time profile + MFU estimate for the per-frame tracking kernel.

Thin CLI wrapper around bench.device_metrics: it builds the EXACT
headline-bench engine (same config -> the persistent compile cache hits)
and reports XLA's cost analysis of the compiled track executable plus a
pipelined burst's sustained on-device s/frame.

  * MFU = flops / (s_frame * f32 peak, bench.PEAKS). Sparse VO
    front-ends are gather-bound, so single-digit MFU is expected.
  * HBM utilization is the meaningful ceiling for this workload.

The same numbers are recorded by every `python bench.py` run, so this
tool is for interactive profiling — optionally with a full
jax.profiler trace via --trace-dir. Needs a GPU.

Usage: python tools/profile_device.py [--frames 64] [--trace-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--trace-dir", default="")
    args = ap.parse_args()

    import jax

    import bench
    from viso_tpu.slam.engine import StereoVO
    from viso_tpu.utils import compile_cache
    from viso_tpu.utils import device as device_mod

    compile_cache.enable()
    peak = bench.peaks(device_mod.require_gpu(jax.devices()[0]).device_kind)

    # EXACT bench_headline config (shared compile cache entries).
    cfg = bench.headline_config()
    frames, _, _ = bench.headline_sequence(cfg, 12)
    vo = StereoVO(cfg)
    for il, ir in frames:
        vo.process(il, ir)
    staged = [vo.to_device(il, ir)[0] for il, ir in frames]
    jax.block_until_ready(staged)

    if args.trace_dir:
        with jax.profiler.trace(args.trace_dir):
            out = bench.device_metrics(vo, staged, peak, n=args.frames)
    else:
        out = bench.device_metrics(vo, staged, peak, n=args.frames)
    vo.close()
    out["device"] = device_mod.describe(jax.devices())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
