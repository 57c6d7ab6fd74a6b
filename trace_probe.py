"""Profile the serving path and list the top device operations.

    python trace_probe.py [--tile T] [--frames N] [--out DIR]

Compiles the generated 1024^2 stress scene and the filter scene
(utils/stress.py), warms each, then records one jax.profiler trace of N
`render_tiles_planar` calls per scene under DIR/<scene>.  For every device
stream line of the trace it prints the time per frame of the heaviest
operations, and for the device as a whole its busy time and idle share
inside the traced window.  Run it on the accelerator; on the CPU the
trace holds no device plane.
"""

import argparse
import collections
import glob
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

import svgrasterize_tpu.render_plan as rp  # noqa: E402
from svgrasterize_tpu import scene_from_str  # noqa: E402
from svgrasterize_tpu.core.transform import Transform  # noqa: E402
from svgrasterize_tpu.utils.stress import filter_doc, stress_doc  # noqa: E402

TR = Transform().matrix(0, 1, 0, 1, 0, 0)


def _union_ns(intervals) -> int:
    """Total length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + ((cur_e - cur_s) if cur_e is not None else 0)


def reduce(path: str, frames: int, top: int = 18) -> None:
    """Print per-stream top ops (us/frame, calls/frame) and the device's
    busy time and idle share from one .xplane.pb file."""
    pd = jax.profiler.ProfileData.from_file(path)
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        stream_iv = []
        for line in plane.lines:
            per = collections.Counter()
            cnt = collections.Counter()
            iv = []
            for ev in line.events:
                per[ev.name] += ev.duration_ns
                cnt[ev.name] += 1
                iv.append((ev.start_ns, ev.start_ns + ev.duration_ns))
            if not iv:
                continue
            if line.name.startswith("Stream"):
                stream_iv.extend(iv)
            lo = min(s for s, _ in iv)
            hi = max(e for _, e in iv)
            print(f"-- {plane.name} | {line.name}: events={len(iv)} "
                  f"span_ms={(hi - lo) / 1e6} busy_ms={_union_ns(iv) / 1e6} "
                  f"sum_ms={sum(per.values()) / 1e6}")
            for name, ns in per.most_common(top):
                print(f"  {ns / frames / 1e3:10.1f} us/frame  "
                      f"x{cnt[name] / frames:g}  {name[:140]}")
        if stream_iv:
            lo = min(s for s, _ in stream_iv)
            hi = max(e for _, e in stream_iv)
            busy = _union_ns(stream_iv)
            print(f"== {plane.name} streams: window_ms={(hi - lo) / 1e6} "
                  f"busy_ms={busy / 1e6} idle_share={1 - busy / (hi - lo)}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tile", type=int, default=None,
                        help="canvas tile (default: the backend's)")
    parser.add_argument("--frames", type=int, default=5)
    parser.add_argument("--out", default="traces",
                        help="directory for the trace files")
    opts = parser.parse_args(argv)
    for name, doc in (("stress", stress_doc()), ("filter", filter_doc())):
        scene, _ids, size = scene_from_str(doc)
        w, h = int(size[0]), int(size[1])
        compiled = rp.compile_scene(scene, TR, (0, 0, h, w), False,
                                    tile=opts.tile)
        fn = compiled.render_tiles_planar
        jax.block_until_ready(fn())
        jax.block_until_ready(fn())
        out_dir = os.path.join(opts.out, name)
        with jax.profiler.trace(out_dir):
            for _ in range(opts.frames):
                out = fn()
            jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(opts.frames):
            jax.block_until_ready(fn())
        print(f"== {name} tile={compiled.tile} host ms/frame untraced="
              f"{(time.perf_counter() - t0) / opts.frames * 1e3}")
        files = glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                          recursive=True)
        reduce(sorted(files)[-1], opts.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
