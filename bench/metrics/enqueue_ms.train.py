"""enqueue_ms.train (program span): host milliseconds from a warm train
step's call to its return, with the card's launch queue empty (the host's
work of enqueueing the step): the mean over the set-up's checked steps
after the first, each of which waits for its loss before the next is
sent.  (In the window steps are sent ahead, so there a call's time also
holds the wait for room in the launch queue.)"""


def read(ctx):
    s = ctx.win.get("warm_enqueue_s")
    return sum(s) / len(s) * 1e3 if s else None
