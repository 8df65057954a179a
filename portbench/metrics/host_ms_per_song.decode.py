"""Host milliseconds a song outside any trace, from the program's untraced
ledger (``svs_torch.utils.profiling.annotate(..., always=True)``,
``snapshot()['host']``: the set-up's call and the untraced window's): the
stream calls (``svs.decode.call``) less their waits for the copies back
(``svs.decode.collect.wait``, one a song) and the programs' builds
(``svs.program.build``: the set-up's capture), over the songs.  None where
the program keeps no such ledger, or the traced window saw no busy card
(the host's share of a card's decode)."""


def read(r):
    from svs_torch.utils import profiling
    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None or not r["trace"].get("busy_s"):
        return None
    host = snapshot().get("host", {})
    call = host.get("svs.decode.call")
    wait = host.get("svs.decode.collect.wait")
    if not (call and wait and wait["count"]):
        return None
    build = host.get("svs.program.build", {}).get("total_s", 0.0)
    return 1e3 * (call["total_s"] - wait["total_s"] - build) / wait["count"]
