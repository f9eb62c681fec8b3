"""k3a_roofline: the Schur reduce's share of its roofline.  The work is
``portbench/work/k3a.py`` on the inputs of each traced launch; the time
is the device time of the kernels named here."""

from ._roofline import share

KERNELS = ("schur_small_kernel",)


def read(run):
    return share(run, "k3a", KERNELS)
