"""The paper's applications on the card: the §V.C cloud-free composite."""

from repro_torch.apps.composite import composite_tile, run_composite_campaign

__all__ = ["composite_tile", "run_composite_campaign"]
