"""k5_roofline: the plane Jacobians' share of their roofline.  The work
is ``portbench/work/k5.py`` on the inputs of each traced launch; the
time is the device time of the kernels named here."""

from ._roofline import share

KERNELS = ("plane_terms_kernel",)


def read(run):
    return share(run, "k5", KERNELS)
