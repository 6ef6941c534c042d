"""The window's DSLOT up-projections' least time (each call's product at
989 TFLOP/s or its q, W and output bytes once at 3.35 TB/s) over the
device time of the kernels named here, in percent."""
from portbench.harness.readers import dslot_roofline_pct

KERNELS = ("band_kernel", "plane_kernel", "cluster_kernel", "walk_kernel",
           "product_kernel")


def read(rec):
    return dslot_roofline_pct(rec, KERNELS)
