"""train_tokens_per_s (host clock): tokens of the train steps sent in the
window over the window's seconds.  Steps are sent until ``--seconds`` have
passed; the window then waits for every step sent (each loss read) before
its clock is read, so all the steps count over all that time."""


def read(ctx):
    return ctx.win["tokens"] / ctx.win["window_s"]
