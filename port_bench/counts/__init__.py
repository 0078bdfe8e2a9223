"""The benchmark's frozen arithmetic: the card's peaks, the least time of
the port's SSD kernels and of the AdamW update, and the model FLOPs of a
step.  Copied once from the port's ``kernels/bounds.py`` and
``core/perfmodel.py`` and frozen here, so that a later change to the port
cannot move the denominators its rooflines are read against."""
