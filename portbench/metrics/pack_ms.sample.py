"""Host ms to pack one batch (``from_numpy_graphs``: the C++ packer and the
copy to the card), the mean over the window's batches, from the
benchmark's span around the call."""


def read(ctx):
    packs = ctx["window"]["pack_s"]
    return 1e3 * sum(packs) / len(packs) if packs else None
