"""The state carried from the JAX package to the port.

The imagery pipeline's state is the bucket (chunked arrays behind Festivus,
which both packages read and write byte for byte) and the
:class:`ImageryConfig`.  A configuration crosses over as the plain dict of
its fields (``dataclasses.asdict`` of the JAX package's config); a tile's
stack crosses over as numpy arrays and is moved to the device here.

The LM stack's state is its parameter tree.  The JAX package's tree crosses
over as numpy arrays (``jax.tree.map(np.asarray, params)``) and
:func:`params_from_numpy` lays it out as the port's, for the dense and ssm
families: the scanned ``blocks`` stack is split into one dict per layer,
and each leaf takes the dtype the port stores it in.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.festivus_imagery import ImageryConfig


def imagery_config_from_dict(d: Mapping) -> ImageryConfig:
    """``dataclasses.asdict`` of an ``ImageryConfig`` -> the port's config.
    Raises on a field the port does not know, rather than dropping it."""
    names = {f.name for f in dataclasses.fields(ImageryConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown ImageryConfig fields {sorted(unknown)}")
    return ImageryConfig(**dict(d))


def stack_to_device(images: np.ndarray, valid: Optional[np.ndarray],
                    device: torch.device
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A tile's numpy stack (images [T, H, W, C], valid [T, H, W] or None)
    -> contiguous tensors on ``device``, one copy each."""
    imgs = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    if valid is None:
        return imgs, None
    return imgs, torch.from_numpy(np.ascontiguousarray(valid)).to(device)


#: leaves kept in f32 beside the norms' (the JAX package uses them in f32)
F32_LEAVES = ("a_log", "d_skip", "dt_bias")


def _leaf_shapes(cfg: ModelConfig
                 ) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """The dense or ssm family's leaves, '/'-joined paths -> shapes: the
    top-level ones, and one layer's (the JAX package stacks them on a
    leading axis)."""
    d, V = cfg.d_model, cfg.vocab_size
    norm = {"scale": (d,)}
    if cfg.norm == "layernorm":
        norm["bias"] = (d,)
    top = {"embed": (V, d), **{f"norm_out/{k}": s for k, s in norm.items()}}
    if not cfg.tie_embeddings:
        top["unembed"] = (V, d)
    if cfg.family == "ssm":
        return top, _mamba_block_shapes(cfg, norm)
    dq = cfg.num_heads * cfg.head_dim
    dkv = cfg.num_kv_heads * cfg.head_dim
    block = {"attn/wq": (d, dq), "attn/wk": (d, dkv), "attn/wv": (d, dkv),
             "attn/wo": (dq, d)}
    if cfg.qkv_bias:
        block.update({"attn/bq": (dq,), "attn/bk": (dkv,), "attn/bv": (dkv,)})
    for name in ("norm_attn", "norm_ffn"):
        block.update({f"{name}/{k}": s for k, s in norm.items()})
    if cfg.act in ("swiglu", "geglu"):
        block.update({"ffn/w_gate": (d, cfg.d_ff), "ffn/w_up": (d, cfg.d_ff),
                      "ffn/w_down": (cfg.d_ff, d)})
    else:
        block.update({"ffn/w_in": (d, cfg.d_ff), "ffn/b_in": (cfg.d_ff,),
                      "ffn/w_out": (cfg.d_ff, d), "ffn/b_out": (d,)})
    return top, block


def _mamba_block_shapes(cfg: ModelConfig, norm: dict) -> Dict[str, tuple]:
    d, di = cfg.d_model, cfg.ssm_d_inner
    n, h, w = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv_width
    block = {f"norm_mix/{k}": s for k, s in norm.items()}
    block.update({f"mamba/{k}": s for k, s in {
        "w_xz": (d, 2 * di), "w_bc": (d, 2 * n), "w_dt": (d, h),
        "conv_x_w": (w, di), "conv_x_b": (di,),
        "conv_bc_w": (w, 2 * n), "conv_bc_b": (2 * n,),
        "a_log": (h,), "d_skip": (h,), "dt_bias": (h,),
        "norm/scale": (di,), "out_proj": (di, d)}.items()})
    return block


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def _put(tree: dict, path: str, value: torch.Tensor) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device) -> dict:
    """The JAX package's parameter tree of a dense or ssm model, as numpy
    arrays -> the port's, on ``device``.  ``cfg`` is the model's config (its
    vocabulary is padded here as ``build`` pads it).  Norm parameters and
    the Mamba layers' ``a_log``, ``d_skip`` and ``dt_bias`` stay f32; every
    other leaf is cast to ``cfg.dtype``, the cast the JAX package makes at
    each use.  Raises ``ValueError`` on a leaf the port does not know, a
    missing leaf or a shape that differs."""
    from repro_torch.models.model_zoo import _padded_cfg
    from repro_torch.models.transformer import model_dtype, require_ported

    require_ported(cfg)
    pcfg = _padded_cfg(cfg)
    top, block = _leaf_shapes(pcfg)
    layers = pcfg.num_layers
    expected = {**top, **{f"blocks/{k}": (layers,) + s
                          for k, s in block.items()}}
    flat = _flatten(tree)
    unknown = sorted(set(flat) - set(expected))
    missing = sorted(set(expected) - set(flat))
    if unknown or missing:
        raise ValueError(f"parameter tree does not fit {cfg.arch_id}: "
                         f"unknown leaves {unknown}, missing {missing}")
    for path, arr in flat.items():
        if tuple(arr.shape) != expected[path]:
            raise ValueError(f"{path}: shape {tuple(arr.shape)} != "
                             f"{expected[path]}")

    dtype = model_dtype(pcfg)

    def tensor(path: str, arr: np.ndarray) -> torch.Tensor:
        if arr.dtype not in (np.float32, np.float64, np.float16):
            arr = arr.astype(np.float32)  # bf16 widens exactly
        parts = path.split("/")
        keep_f32 = parts[-1] in F32_LEAVES or (
            len(parts) > 1 and parts[-2].startswith("norm"))
        return torch.tensor(arr).to(
            device=device, dtype=torch.float32 if keep_f32 else dtype)

    params: dict = {"blocks": [{} for _ in range(layers)]}
    for path, arr in flat.items():
        if path.startswith("blocks/"):
            sub = path[len("blocks/"):]
            for i in range(layers):
                _put(params["blocks"][i], sub, tensor(path, arr[i]))
        else:
            _put(params, path, tensor(path, arr))
    return params
