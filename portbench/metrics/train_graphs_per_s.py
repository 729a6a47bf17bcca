"""Real (unpadded) graphs of the window's train steps over the window's
time, the last step waited for (host clock)."""


def read(ctx):
    return ctx["window"]["train_graphs_per_s"]
