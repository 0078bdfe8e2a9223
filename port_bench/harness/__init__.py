"""The benchmark's harness: the same code for every cell, which finds
the cell's configuration, traffic mix, loop, limits and metrics by name
(``manifest``), draws its weights and tokens from the seed (``weights``,
``tokens``), drives the window and holds what the timed path produced
against the plain reference (``loops/<kind>.py``), and traces it
(``trace``, ``spans``)."""
