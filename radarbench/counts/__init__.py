"""Frozen operation and byte counts of the port's kernels, and the card's
peaks, for the roofline shares the per-layer readers report.  A later
change to a kernel cannot move this yardstick."""
