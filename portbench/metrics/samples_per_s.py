"""Samples of the window's walks over the time from the window's start to
the end of its last walk (host clock; no walk is cut off)."""


def read(ctx):
    return ctx["window"]["samples_per_s"]
