"""The system under test: the port's configuration of a cell, built from
the port's registered config with the configuration file's sizes."""

from __future__ import annotations

import dataclasses

from reference.model import Spec

#: the ``model`` keys that say how the benchmark draws and reads the
#: model, not fields of the port's config
NOT_PORT_FIELDS = ("vocab_pad_multiple", "norm_eps", "pattern", "mixer_norm")


def config(arch: str, model: dict, spec: Spec):
    """The port's ``ModelConfig`` of ``arch`` with every size of ``model``
    (an expert's width is ``d_ff``, as Jamba's one ``intermediate_size``
    gives it); raises where the port would pad the vocabulary otherwise
    than the benchmark draws its tables."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import padded_vocab

    fields = {k: v for k, v in model.items() if k not in NOT_PORT_FIELDS}
    if fields.get("num_experts"):
        fields["moe_d_ff"] = fields["d_ff"]
    cfg = dataclasses.replace(get_config(arch), **fields)
    if padded_vocab(cfg) != spec.vocab_rows:
        raise ValueError(f"the port pads {cfg.vocab_size} ids to "
                         f"{padded_vocab(cfg)} rows, the benchmark to "
                         f"{spec.vocab_rows}")
    return cfg
