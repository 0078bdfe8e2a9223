"""The loops that drive a window, one file a kind, found by the ``kind``
a traffic mix names (``traffic/<mix>.json``): ``loops/<kind>.py``.

Each file has ``run(ctx)`` -> (the run, the compared numbers, attempted,
failed), which sets up, drives the window and holds what the timed path
produced against the plain reference; ``control_numbers(ctx)``, the same
numbers of the control; ``NUMBERS``, the names a cell's limits may give;
and ``FAULTS``, the planted faults (``harness/faults.py``) the check must
catch.  A new kind of traffic is a new file here.
"""
