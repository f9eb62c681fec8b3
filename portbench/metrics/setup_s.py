"""setup_s: process start to the window's first frame (imports, the
kernel library, inputs made on the device, the warm-up)."""


def read(run):
    return run.setup_s
