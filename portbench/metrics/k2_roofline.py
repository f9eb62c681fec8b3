"""k2_roofline: the depth render's share of its roofline.  The work is
``portbench/work/k2.py`` on the inputs of each traced launch; the time
is the device time of the kernels named here."""

from ._roofline import share

KERNELS = ("depth_render_kernel",)


def read(run):
    return share(run, "k2", KERNELS)
