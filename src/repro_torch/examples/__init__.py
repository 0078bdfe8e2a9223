"""The imagery system's examples on the card: counterparts of the JAX
package's ``examples/{global_composite,field_segmentation,tile_server}.py``.
Run each as a module; ``--device cpu`` runs the plain PyTorch versions:

    PYTHONPATH=src python -m repro_torch.examples.global_composite
    PYTHONPATH=src python -m repro_torch.examples.field_segmentation --device cpu
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def device_arg(doc: str, argv: Optional[Sequence[str]] = None
               ) -> Optional[str]:
    """The ``--device`` of an example's command line (default: the card)."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain PyTorch versions; "
                         "default: the CUDA card")
    return ap.parse_args(argv).device
