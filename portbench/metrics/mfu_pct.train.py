"""The U-Net's training FLOPs (``portbench/flops.py``: convs forward and
backward, from shapes) of every patch stepped in the untraced window, over
that window's seconds and the card's dense bf16 peak, in %."""


def read(r):
    w, peak = r["window"], r["peak_flops"]
    if not peak or not w.get("patches"):
        return None
    return 100.0 * w["patches"] * w["train_flops_per_patch"] / (
        w["seconds"] * peak)
