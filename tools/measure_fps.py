"""End-to-end streamed-frame-rate measurement (run on the GPU).

Starts the web server in-process, starts the default simulation via
the HTTP API, reads /api/stream for 20 s and reports fps at the
reference's 800x264 default. Exits non-zero below 8 fps.

    python tools/measure_fps.py [--nx 800 --ny 264] [--seconds 20]
"""
import argparse
import os
import sys
import threading
import time
import urllib.request

sys.path.insert(0, os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..")))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=800)
    ap.add_argument("--ny", type=int, default=264)
    ap.add_argument("--port", type=int, default=8731)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--warmup", type=float, default=60.0,
                    help="seconds to wait for first compile + ramp")
    args = ap.parse_args()

    from cfd_demo_jax.apps.web import server as S
    th = threading.Thread(
        target=S.main,
        args=(["--port", str(args.port), "--nx", str(args.nx),
               "--ny", str(args.ny)],), daemon=True)
    th.start()
    time.sleep(2)
    req = urllib.request.Request(
        f"http://127.0.0.1:{args.port}/api/control", method="POST",
        data=b'{"action": "start"}',
        headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req).read()
    time.sleep(args.warmup)
    r = urllib.request.urlopen(f"http://127.0.0.1:{args.port}/api/stream")
    t0 = time.monotonic()
    frames = 0
    while time.monotonic() - t0 < args.seconds:
        chunk = r.read(65536)
        if not chunk:
            break
        frames += chunk.count(b"--frame")
    dt = time.monotonic() - t0
    print(f"frames={frames} in {dt:.1f}s -> {frames / dt:.1f} fps "
          f"({args.nx}x{args.ny})")
    # Stop the sim thread cleanly before interpreter teardown.
    req = urllib.request.Request(
        f"http://127.0.0.1:{args.port}/api/control", method="POST",
        data=b'{"action": "reset"}',
        headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req).read()
    time.sleep(1)
    return 0 if frames / dt >= 8.0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
