"""Roofline analysis of the port's dry-run records (counterpart of
``repro.roofline``): the three-term roofline under a ``ChipSpec``, the
step counters and the collective accounting."""
