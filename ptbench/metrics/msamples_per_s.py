"""Pixel samples accumulated into the framebuffer a second: width x height x
spp of every pass the window ran, over the window (host clock, each pass
ended by a device synchronise). The count comes from the traffic's
parameters, not from a counter of the program."""


def read(rec):
    return len(rec["walls"]) * rec["spp"] * rec["pixels"] / rec["window_s"] / 1e6
