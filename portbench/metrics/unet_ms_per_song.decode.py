"""Device milliseconds of the U-Net a song: the program's phase clock
inside its captured decode (``svs_torch.utils.profiling.mark``,
``decode.unet``: from the STFT's end to the mask's), averaged over every
replay of the run.  None where the program keeps no such clock on a CUDA
device, or the traced window saw no busy card."""


def read(r):
    from svs_torch.utils import profiling
    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None or not r["trace"].get("busy_s"):
        return None
    unet = snapshot().get("phases", {}).get("cuda", {}).get("decode.unet")
    if not unet or not unet["count"]:
        return None
    return 1e3 * unet["s"] / unet["count"]
