"""Share of the traced window's idle time that the device trace puts down
to the host's Python inside the harness's ``feed`` span and no narrower
range: the idle gaps labelled ``host python in feed`` over the window
less its busy time.  0 when the label is not among the breakdown's listed
entries (it is then below the tenth)."""

LABEL = "host python in feed"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    idle = t["window_s"] - t["busy_s"]
    if idle <= 0:
        return None
    return 100.0 * sum(s for name, s in t["idle_gaps"] if name == LABEL) / idle
