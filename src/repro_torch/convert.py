"""The state carried from the JAX package to the port.

The imagery pipeline's state is the bucket (chunked arrays behind Festivus,
which both packages read and write byte for byte) and the
:class:`ImageryConfig`.  A configuration crosses over as the plain dict of
its fields (``dataclasses.asdict`` of the JAX package's config); a tile's
stack crosses over as numpy arrays and is moved to the device here.

The LM stack's state is its parameter tree.  The JAX package's tree crosses
over as numpy arrays (``jax.tree.map(np.asarray, params)``) and
:func:`params_from_numpy` lays it out as the port's, for every family: each
scanned stack (``blocks``; an enc-dec model's ``encoder`` and ``decoder``)
is split into one dict per layer (a hybrid super-block's stacked
sublayers too: see :func:`_block_leaves`), and each leaf takes the dtype
the port stores it in.  :func:`params_to_numpy` is its inverse (training
state crosses back, for checkpoints in the JAX layout), and
:func:`reference_shapes` gives each port leaf the shape of the JAX leaf it
is part of (the optimizer decides on those shapes).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

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


def _norm_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d = cfg.d_model
    return {"scale": (d,), **({"bias": (d,)} if cfg.norm == "layernorm"
                              else {})}


def _ffn_shapes(cfg: ModelConfig, d_ff: int) -> Dict[str, tuple]:
    d = cfg.d_model
    if cfg.act in ("swiglu", "geglu"):
        return {"w_gate": (d, d_ff), "w_up": (d, d_ff), "w_down": (d_ff, d)}
    return {"w_in": (d, d_ff), "b_in": (d_ff,), "w_out": (d_ff, d),
            "b_out": (d,)}


def _mixer_shapes(cfg: ModelConfig, mixer: str) -> Dict[str, tuple]:
    d = cfg.d_model
    if mixer == "mamba":
        di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        w = cfg.ssm_conv_width
        return {"w_xz": (d, 2 * di), "w_bc": (d, 2 * n), "w_dt": (d, h),
                "conv_x_w": (w, di), "conv_x_b": (di,),
                "conv_bc_w": (w, 2 * n), "conv_bc_b": (2 * n,),
                "a_log": (h,), "d_skip": (h,), "dt_bias": (h,),
                "norm/scale": (di,), "out_proj": (di, d)}
    dq = cfg.num_heads * cfg.head_dim
    dkv = cfg.num_kv_heads * cfg.head_dim
    out = {"wq": (d, dq), "wk": (d, dkv), "wv": (d, dkv), "wo": (dq, d)}
    if cfg.qkv_bias:
        out.update({"bq": (dq,), "bk": (dkv,), "bv": (dkv,)})
    return out


def _ff_shapes(cfg: ModelConfig, ff: str) -> Dict[str, tuple]:
    if ff == "ffn":
        return _ffn_shapes(cfg, cfg.d_ff)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    out = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
           "w_down": (e, f, d)}
    if cfg.num_shared_experts:
        out.update({f"shared/{k}": s for k, s in _ffn_shapes(
            cfg, f * cfg.num_shared_experts).items()})
    return out


def _layer_shapes(cfg: ModelConfig, mixer: str, ff: str
                  ) -> Dict[str, tuple]:
    """One port layer's leaves ('/'-joined paths inside its dict) ->
    shapes (``transformer.init_block``'s layout)."""
    from repro_torch.models.transformer import mixer_norm_name

    norm = _norm_shapes(cfg)
    name = mixer_norm_name(cfg, mixer)
    out = {f"{name}/{k}": s for k, s in norm.items()}
    out.update({f"{mixer}/{k}": s
                for k, s in _mixer_shapes(cfg, mixer).items()})
    if ff:
        out.update({f"norm_ffn/{k}": s for k, s in norm.items()})
        out.update({f"{ff}/{k}": s for k, s in _ff_shapes(cfg, ff).items()})
    return out


def _block_leaves(cfg: ModelConfig
                  ) -> Dict[str, Tuple[tuple, List[Tuple[int, tuple]]]]:
    """The JAX package's leaves under ``blocks/`` -> (their shape, and for
    each port layer that takes a slice of the leaf: (layer, the slice's
    index)).  A dense, moe or ssm leaf stacks the layers on axis 0.  A
    hybrid super-block of P sublayers (``nb`` of them) stacks ``attn/*``
    as [nb, ...] (the sublayer at ``attn_layer_offset``, none where the
    offset is P or more), ``mamba/*``,
    ``ffn/*`` and ``moe/*`` as [nb, n, ...] over the n sublayers of that
    kind in order, and ``norm_mix/*``, ``norm_ffn/*`` as [nb, P, ...]."""
    from repro_torch.models.transformer import layer_plan, num_blocks

    plan = layer_plan(cfg)
    if not cfg.is_hybrid:
        n = len(plan)
        return {k: ((n,) + s, [(i, (i,)) for i in range(n)])
                for k, s in _layer_shapes(cfg, *plan[0]).items()}
    period, nb = cfg.attn_layer_period, num_blocks(cfg)
    subs: Dict[str, List[int]] = {"mamba": [], "ffn": [], "moe": []}
    for sub, (mixer, ff) in enumerate(plan[:period]):
        if mixer == "mamba":
            subs["mamba"].append(sub)
        subs[ff].append(sub)
    out = {}
    for kind in ("mamba", "ffn", "moe"):
        shapes = (_mixer_shapes(cfg, kind) if kind == "mamba"
                  else _ff_shapes(cfg, kind))
        where = [(b * period + sub, (b, j)) for b in range(nb)
                 for j, sub in enumerate(subs[kind])]
        for k, s in shapes.items():
            out[f"{kind}/{k}"] = ((nb, len(subs[kind])) + s, where)
    # a super-block cut shorter than its attention offset (a depth cut of
    # the hybrid to its first mamba sublayers) has no attention leaves
    for k, s in (_mixer_shapes(cfg, "attn").items()
                 if cfg.attn_layer_offset < period else ()):
        out[f"attn/{k}"] = ((nb,) + s, [(b * period + cfg.attn_layer_offset,
                                         (b,)) for b in range(nb)])
    for name in ("norm_mix", "norm_ffn"):
        for k, s in _norm_shapes(cfg).items():
            out[f"{name}/{k}"] = ((nb, period) + s, [
                (b * period + sub, (b, sub)) for b in range(nb)
                for sub in range(period)])
    return out


#: an enc-dec layer's parts in each stack, in the JAX package's names
ENCDEC_PARTS = {
    "encoder": (("norm_attn", "norm"), ("attn", "attn"),
                ("norm_ffn", "norm"), ("ffn", "ffn")),
    "decoder": (("norm_self", "norm"), ("self_attn", "attn"),
                ("norm_cross", "norm"), ("cross_attn", "attn"),
                ("norm_ffn", "norm"), ("ffn", "ffn")),
}


def _stacks(cfg: ModelConfig
            ) -> Dict[str, Tuple[int, Dict[str, Tuple[tuple, list]]]]:
    """Each scanned stack of the JAX tree -> (the port's layers in it, and
    its leaves as :func:`_block_leaves` gives them): ``blocks``, or an
    enc-dec model's ``encoder`` and ``decoder`` (layers on axis 0)."""
    if not cfg.is_encdec:
        return {"blocks": (cfg.num_layers, _block_leaves(cfg))}
    kinds = {"norm": _norm_shapes(cfg), "attn": _mixer_shapes(cfg, "attn"),
             "ffn": _ffn_shapes(cfg, cfg.d_ff)}
    out = {}
    for stack, n in (("encoder", cfg.enc_layers),
                     ("decoder", cfg.num_layers)):
        out[stack] = (n, {f"{name}/{k}": ((n,) + s,
                                           [(i, (i,)) for i in range(n)])
                          for name, kind in ENCDEC_PARTS[stack]
                          for k, s in kinds[kind].items()})
    return out


def _is_qtensor(x) -> bool:
    from repro_torch.train.optimizer import QTensor

    return isinstance(x, QTensor)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """'/'-joined paths -> leaves: numpy arrays, or QTensors as they are."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v if _is_qtensor(v) else np.asarray(v)
    return out


def _put(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def _get(tree, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def _layout(cfg: ModelConfig):
    """The JAX package's tree for ``cfg``: (the padded config, its
    top-level leaves -> shapes, its stacks as :func:`_stacks` gives
    them)."""
    from repro_torch.models.model_zoo import _padded_cfg
    from repro_torch.models.transformer import require_ported

    require_ported(cfg)
    pcfg = _padded_cfg(cfg)
    norm = _norm_shapes(pcfg)
    V, d = pcfg.vocab_size, pcfg.d_model
    norms = ("norm_enc", "norm_out") if pcfg.is_encdec else ("norm_out",)
    top = {"embed": (V, d), **{f"{name}/{k}": s for name in norms
                               for k, s in norm.items()}}
    if not pcfg.tie_embeddings and not pcfg.is_encdec:
        top["unembed"] = (V, d)
    if pcfg.is_encdec or pcfg.frontend_tokens:
        top["frontend_proj"] = (pcfg.frontend_dim or d, d)
    return pcfg, top, _stacks(pcfg)


def params_from_numpy(tree: Mapping, cfg: ModelConfig, device,
                      param_dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX package's parameter tree of a model of any family, as numpy
    arrays -> the port's, on ``device``.  ``cfg`` is the model's config
    (its vocabulary is padded here as ``build`` pads it).  Norm parameters
    and the Mamba layers' ``a_log``, ``d_skip`` and ``dt_bias`` stay f32;
    every other leaf (the MoE router and ``frontend_proj`` too) is cast to
    ``param_dtype`` (default ``cfg.dtype``, the cast the JAX package makes
    at each use; ``torch.float32`` keeps its f32 masters).  A leaf may also
    be a ``train.optimizer.QTensor`` (int8 Adam moments): its payload and
    row scales are split into layers as a leaf is.  Raises ``ValueError``
    on a leaf the port does not know, a missing leaf or a shape that
    differs."""
    from repro_torch.models.transformer import model_dtype

    pcfg, top, stacks = _layout(cfg)
    expected = {**top, **{f"{stack}/{k}": s
                          for stack, (_, leaves) in stacks.items()
                          for k, (s, _) in leaves.items()}}
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

    dtype = param_dtype or model_dtype(pcfg)

    def tensor(path: str, arr):
        if _is_qtensor(arr):
            return type(arr)(
                q=torch.tensor(np.asarray(arr.q)).to(device),
                scale=torch.tensor(np.asarray(arr.scale),
                                   dtype=torch.float32).to(device),
                shape=tuple(np.shape(arr.q)))
        if arr.dtype not in (np.float32, np.float64, np.float16):
            arr = arr.astype(np.float32)  # bf16 widens exactly
        parts = path.split("/")
        keep_f32 = parts[-1] in F32_LEAVES or (
            len(parts) > 1 and parts[-2].startswith("norm"))
        return torch.tensor(arr).to(
            device=device, dtype=torch.float32 if keep_f32 else dtype)

    params: dict = {stack: [{} for _ in range(n)]
                    for stack, (n, _) in stacks.items()}
    for path, arr in flat.items():
        stack, _, sub = path.partition("/")
        if stack in stacks:
            for layer, index in stacks[stack][1][sub][1]:
                _put(params[stack][layer], sub, tensor(path, _index(arr,
                                                                    index)))
        else:
            _put(params, path, tensor(path, arr))
    return params


def split_layers(tree: Mapping, cfg: ModelConfig, take) -> dict:
    """A tree in the JAX package's layout, of any leaves -> the port's
    layout, each port leaf ``take(leaf, index)`` of the JAX leaf it is part
    of: ``index`` is its layer's slice of the stacked axes (``()`` for a
    top-level leaf).  :func:`params_from_numpy`'s layout, without its
    checks or casts (a restored tree of DTensors takes this path)."""
    _, top, stacks = _layout(cfg)
    params: dict = {stack: [{} for _ in range(n)]
                    for stack, (n, _) in stacks.items()}
    for path in top:
        _put(params, path, take(_get(tree, path), ()))
    for stack, (_, leaves) in stacks.items():
        for sub, (_, where) in leaves.items():
            leaf = _get(tree, f"{stack}/{sub}")
            for layer, index in where:
                _put(params[stack][layer], sub, take(leaf, index))
    return params


def _index(arr, index: tuple):
    """One layer's slice of a stacked leaf (a QTensor's payload and row
    scales alike)."""
    if _is_qtensor(arr):
        q = np.asarray(arr.q)[index]
        return type(arr)(q=q, scale=np.asarray(arr.scale)[index],
                         shape=q.shape)
    return arr[index]


def _to_numpy(t):
    """A port leaf -> a numpy copy: float tensors as f32 (bf16 widens
    exactly), others (int8 payloads) in their own dtype.  Never a view of
    the tensor, which the optimizer goes on updating in place."""
    t = t.detach()
    t = t.float() if t.is_floating_point() else t
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def params_to_numpy(params: Mapping, cfg: ModelConfig) -> dict:
    """The exact inverse of :func:`params_from_numpy`: the port's tree of
    a model of any family -> the JAX package's, as numpy arrays.  Each
    stack's per-layer dicts are stacked back into its leaves (a hybrid
    super-block's sublayers as :func:`_block_leaves` lays them out), in the
    JAX package's shapes (the vocabulary padded as ``build`` pads it).
    Float leaves come back f32, bf16 widened exactly.  A leaf may be a
    ``train.optimizer.QTensor`` (int8 Adam moments): its payload and row
    scales are stacked as a leaf is, and its ``shape`` is the stacked one.
    Raises ``KeyError`` on a leaf the tree lacks."""
    _, top, stacks = _layout(cfg)
    out: dict = {}
    for path in top:
        leaf = _get(params, path)
        _put(out, path, _qmap(_to_numpy, leaf))
    for stack, (_, leaves) in stacks.items():
        for sub, (shape, where) in leaves.items():
            first = _get(params[stack][where[0][0]], sub)
            if _is_qtensor(first):
                q = np.empty(shape, dtype=np.int8)
                scale = np.empty(shape[:-1], dtype=np.float32)
                for layer, index in where:
                    part = _get(params[stack][layer], sub)
                    q[index] = _to_numpy(part.q)
                    scale[index] = _to_numpy(part.scale)
                value = type(first)(q=q, scale=scale, shape=shape)
            else:
                value = np.empty(shape, dtype=np.float32)
                for layer, index in where:
                    value[index] = _to_numpy(_get(params[stack][layer], sub))
            _put(out, f"{stack}/{sub}", value)
    return out


def _qmap(fn, leaf):
    """``fn`` of a leaf, or of a QTensor's payload and row scales."""
    if _is_qtensor(leaf):
        return type(leaf)(q=fn(leaf.q), scale=fn(leaf.scale),
                          shape=tuple(leaf.shape))
    return fn(leaf)


def reference_shapes(cfg: ModelConfig) -> dict:
    """A tree laid out as the port's parameters of ``cfg``, holding at each
    leaf the shape of the JAX package's leaf it is (a slice of): a layer's
    leaf carries its stack's shape.  The optimizer decides weight decay
    (leaves of two or more dimensions) and int8 moments on these shapes,
    so the port's per-layer tree is updated as the JAX package updates its
    stacked one."""
    _, top, stacks = _layout(cfg)
    out: dict = {stack: [{} for _ in range(n)]
                 for stack, (n, _) in stacks.items()}
    for path, shape in top.items():
        _put(out, path, shape)
    for stack, (_, leaves) in stacks.items():
        for sub, (shape, where) in leaves.items():
            for layer, _ in where:
                _put(out[stack][layer], sub, shape)
    return out


def jax_layout(cfg: ModelConfig) -> dict:
    """The JAX package's parameter tree of ``cfg`` as nested dicts whose
    leaves are the leaves' shapes (tuples): the structure a checkpoint in
    the JAX layout has, without any array."""
    _, top, stacks = _layout(cfg)
    out: dict = {}
    for path, shape in top.items():
        _put(out, path, shape)
    for stack, (_, leaves) in stacks.items():
        for sub, (shape, _) in leaves.items():
            _put(out, f"{stack}/{sub}", shape)
    return out
