"""k1_roofline: the windowed solve's share of its roofline.  The work is
``portbench/work/k1.py`` on the inputs of each traced launch; the time
is the device time of the kernels named here."""

from ._roofline import share

KERNELS = ("fused_gn_kernel",)


def read(run):
    return share(run, "k1", KERNELS)
