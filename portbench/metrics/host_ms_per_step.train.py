"""Host milliseconds a train step outside any trace, from the program's
untraced ledger (``svs_torch.utils.profiling.annotate(..., always=True)``,
``snapshot()['host']``: the set-up's steps and the untraced window's): the
step (``svs.train.step``: the program's lookup, staging, replay,
bookkeeping, copy-out) and the feed (``svs.train.feed``: the index draw and
the gather), less the feed's wait for the card (``svs.train.feed.wait``)
and the programs' builds (``svs.program.build``: the set-up's warm-up and
capture), over the steps.  None where the program keeps no such ledger,
or the traced window saw no busy card (the host's share of a card's
step)."""


def read(r):
    from svs_torch.utils import profiling
    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None or not r["trace"].get("busy_s"):
        return None
    host = snapshot().get("host", {})
    step, feed = host.get("svs.train.step"), host.get("svs.train.feed")
    if not (step and feed and step["count"]):
        return None
    less = sum(host.get(n, {}).get("total_s", 0.0)
               for n in ("svs.train.feed.wait", "svs.program.build"))
    return 1e3 * (step["total_s"] + feed["total_s"] - less) / step["count"]
