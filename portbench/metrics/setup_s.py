"""Seconds from the process's start to the window's start (host clock):
loading, building or finding the kernels, and walking every shape once."""


def read(ctx):
    return ctx["setup_s"]
