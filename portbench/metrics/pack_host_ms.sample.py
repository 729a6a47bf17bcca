"""Host-bound idle ms per traced walk under the program's ``tsdiff.pack.*``
spans (``from_numpy_graphs``: the packer and the copies to the card): what
packing costs the card, where ``pack_ms.sample`` is its host time
(``gaps.py``).  None on a program without those spans."""

from portbench import gaps


def read(ctx):
    return gaps.host_ms(ctx, "tsdiff.pack.", len(ctx["window"].get("traced", [])))
