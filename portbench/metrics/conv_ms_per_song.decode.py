"""Device milliseconds of the convolution kernels (the trace's ``conv``
family) per song separated in the traced window."""


def read(r):
    conv = r["trace"].get("families", {}).get("conv")
    songs = r["traced_window"].get("songs")
    if not conv or not songs:
        return None
    return 1e3 * conv / songs
