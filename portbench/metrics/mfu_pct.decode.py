"""The U-Net's forward FLOPs (``portbench/flops.py``, from shapes) over the
padded segments of every song decoded in the untraced window, over that
window's seconds and the card's dense bf16 peak, in %."""


def read(r):
    w, peak = r["window"], r["peak_flops"]
    if not peak or not w.get("songs"):
        return None
    return 100.0 * w["songs"] * w["decode_flops_per_song"] / (
        w["seconds"] * peak)
