"""Data plane of the port: synthetic imagery (numpy-seeded, so both
packages write identical bytes)."""
