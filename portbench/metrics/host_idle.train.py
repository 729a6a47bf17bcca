"""The host-bound share of the traced train steps' stretch, in percent:
the device's idle time up to the launch of work the host had not yet asked
for, under any span (``gaps.py``); ``idle_share.train`` minus it is the
device-side idle.  None on a program without ``tsdiff.train.*`` spans."""

from portbench import gaps


def read(ctx):
    g = gaps.of_run(ctx)
    if g is None or not any(n.startswith("tsdiff.train.") for n in g["names"]):
        return None
    return 100.0 * sum(g["host"].values()) / 1e6 / ctx["trace"]["window_s"]
