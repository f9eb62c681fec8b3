"""frames_per_s: every frame whose pose came back in the window, over
all the time of the window (host clock; the window ends in
``torch.cuda.synchronize()``)."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
