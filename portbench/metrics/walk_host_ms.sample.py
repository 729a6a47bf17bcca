"""Host-bound idle ms per traced walk under the program's ``tsdiff.walk.*``
spans (``WalkRunner.run``: the statics, the start and noise, the replays'
launches, the read-back): the device's idle time that the walk's own host
work left it (``gaps.py``).  None on a program without those spans."""

from portbench import gaps


def read(ctx):
    return gaps.host_ms(ctx, "tsdiff.walk.", len(ctx["window"].get("traced", [])))
