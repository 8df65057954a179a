"""The share of the traced window in which the card ran no kernel, copy or
set: 100 * (1 - busy / window), in %."""


def read(r):
    t = r["trace"]
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
