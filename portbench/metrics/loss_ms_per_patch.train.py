"""Device milliseconds of the loss per patch: the program's phase clocks
inside its captured train step (``svs_torch.utils.profiling.mark``), the
loss's forward (``train.loss_fwd``) and backward (``train.loss_bwd``), each
averaged over every replay of the run, over the patches a step of the
traced window.  None where the program keeps no such clocks on a CUDA
device, or the traced window saw no busy card."""


def read(r):
    from svs_torch.utils import profiling
    snapshot = getattr(profiling, "snapshot", None)
    tw = r["traced_window"]
    if snapshot is None or not tw.get("attempted") or \
            not r["trace"].get("busy_s"):
        return None
    phases = snapshot().get("phases", {}).get("cuda", {})
    parts = [phases.get(p) for p in ("train.loss_fwd", "train.loss_bwd")]
    if not all(p and p["count"] for p in parts):
        return None
    per_step = sum(p["s"] / p["count"] for p in parts)
    return 1e3 * per_step / (tw["patches"] / tw["attempted"])
