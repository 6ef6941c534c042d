"""DSLOT-NN core (port of ``repro.core``): online (MSDF) arithmetic, early
termination, the SIP baseline, the FPGA cycle model, CSD, MSR analysis,
im2col and the paper's MNIST CNN (``core.mnist_cnn``)."""

from .digits import (fixed_to_sd, first_negative_prefix, sd_from_value,
                     sd_prefix_values, sd_split_posneg, sd_to_value)
from .early_term import TerminationReport, early_termination
from .online import (DELTA_ADD, DELTA_MULT, online_add, online_add_tree,
                     online_emit, online_mult_sp)
from .pe import PESchedule, pe_output_scale, pe_schedule, pe_sop_digits
from .quantize import QTensor, dequantize, quantize, quantize_unsigned
from .sip import SIPSchedule, sip_schedule, sip_sop, sip_sop_trace
from .cycle_model import FPGAModel, TABLE1_PUBLISHED, table1_model
from .conv import (DSLOTConvResult, dslot_conv2d_stats, extract_windows,
                   im2col, sip_conv2d)
from .csd import (binary_digit_count, csd_matmul, csd_planes_nonzero,
                  csd_recode, essential_digit_count)
from .msr import msr_depths, msr_histogram, quantize_weights, tile_plane_bound

__all__ = [
    "fixed_to_sd", "first_negative_prefix", "sd_from_value",
    "sd_prefix_values", "sd_split_posneg", "sd_to_value",
    "TerminationReport", "early_termination",
    "DELTA_ADD", "DELTA_MULT", "online_add", "online_add_tree",
    "online_emit", "online_mult_sp",
    "PESchedule", "pe_output_scale", "pe_schedule", "pe_sop_digits",
    "QTensor", "dequantize", "quantize", "quantize_unsigned",
    "SIPSchedule", "sip_schedule", "sip_sop", "sip_sop_trace",
    "FPGAModel", "TABLE1_PUBLISHED", "table1_model",
    "DSLOTConvResult", "dslot_conv2d_stats", "extract_windows", "im2col",
    "sip_conv2d",
    "binary_digit_count", "csd_matmul", "csd_planes_nonzero", "csd_recode",
    "essential_digit_count",
    "msr_depths", "msr_histogram", "quantize_weights", "tile_plane_bound",
]
