"""Seconds from process start to the start of the window: weights drawn,
the DSLOT step calibrated, the program built and prepared, the cell's
shapes warmed and the traffic's warm period."""


def read(rec):
    return rec["setup_s"]
