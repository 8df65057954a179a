"""Device milliseconds of the convolution kernels (the trace's ``conv``
family: cuDNN's forward, data- and weight-gradient kernels and their
layout transforms) per patch stepped in the traced window."""


def read(r):
    conv = r["trace"].get("families", {}).get("conv")
    patches = r["traced_window"].get("patches")
    if not conv or not patches:
        return None
    return 1e3 * conv / patches
