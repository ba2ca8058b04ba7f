"""Parameter sharding rules, Megatron-style tensor parallelism (port of
``domainrag_tpu/parallel/sharding.py``).

Flux MMDiT rules over the ``model`` axis, as the JAX package states them
(:func:`flux_param_specs` returns its ``PartitionSpec`` tree):
- column-sharded (output dim): ``img_qkv`` / ``txt_qkv`` / ``linear1`` /
  ``*_mlp1``;
- row-sharded (input dim): ``img_proj`` / ``txt_proj`` / ``linear2`` /
  ``*_mlp2``, their bias replicated and added after the reduction;
- everything else replicated.

In the JAX package those specs are GSPMD layouts: ``P(None, model)`` on a
fused output dim cuts it into n contiguous pieces wherever they fall, and
GSPMD inserts whatever collectives that takes. The port has no compiler to
do that, so :func:`shard_params` makes the explicit Megatron split that
the specs stand for, rank by rank, segment by segment:
- a fused qkv (``3*h``) gives rank r its heads of q, of k and of v;
- ``linear1`` (``3*h + mh``, q k v then the MLP hidden) its heads of q, k
  and v and its slice of the MLP hidden; ``linear2``'s input (``h + mh``,
  the attention output then the MLP hidden) the same rows;
- ``*_mlp1`` / ``*_mlp2`` the rank's slice of the MLP hidden;
- an int8 leaf pair splits ``w_q`` (K-major, (out, in)) and ``w_s`` (per
  output channel) the same way: a column-sharded layer's rows of both, a
  row-sharded layer's columns of ``w_q`` and all of ``w_s``.
Where the heads do not divide over the axis (JAX's attention fallback,
``ops/attention.py:576-577``), the attention stays whole on every rank:
qkv replicated, and the attention rows of the row-sharded layer held by
rank 0 and zeros elsewhere, so that the sum over ranks adds them once.
The model reads its local widths from the weights it is given
(``models.flux.model``); the row-sharded layers sum over the axis. That
fallback serves but never trains: the other ranks would learn in its
zeros, so the trainer refuses it (:func:`check_trainable`).

FSDP (``fsdp_axis``, JAX's rule of :68-69): every leaf of two or more
dims that no TP rule shards (the embedders, the modulation and final
layers) is cut along dim 0 over that axis, so each rank holds, and
steps, 1/n of it (ZeRO-3); the trainer gathers it before use.
:func:`unshard_params` puts a rank's tree back together.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .mesh import P

COL_SHARDED = ("img_qkv", "txt_qkv", "linear1", "img_mlp1", "txt_mlp1")
ROW_SHARDED = ("img_proj", "txt_proj", "linear2", "img_mlp2", "txt_mlp2")


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _owner(names) -> Optional[str]:
    for n in reversed([n for n in names if not n.isdigit()]):
        if n in COL_SHARDED or n in ROW_SHARDED:
            return n
    return None


def flux_param_specs(params, model_axis: str = "model",
                     fsdp_axis: Optional[str] = None):
    """The JAX package's ``PartitionSpec`` tree for a Flux param tree.

    ``fsdp_axis``: additionally shard large replicated weights' first dim
    over that axis (ZeRO-3 style weight sharding)."""
    def spec_for(names, leaf):
        ndim = getattr(leaf, "ndim", 0)
        in_block = any(n in ("double", "single") for n in names)
        owner = _owner(names)
        if in_block and owner in COL_SHARDED:
            if names[-1] == "w" and ndim == 2:
                return P(None, model_axis)
            if names[-1] == "b" and ndim == 1:
                return P(model_axis)
        if in_block and owner in ROW_SHARDED:
            if names[-1] == "w" and ndim == 2:
                return P(model_axis, None)
            return P()          # added after the reduction: replicated
        if fsdp_axis is not None and ndim >= 2:
            return P(fsdp_axis)
        return P()

    return _map_with_path(spec_for, params)


def validate_divisibility(params, specs, mesh) -> None:
    """Every sharded dim must divide by its mesh axis size (GSPMD would
    pad silently; the port could not split it)."""
    def check(names, leaf):
        spec = _leaf_at(specs, names)
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            axes = (axis,) if isinstance(axis, str) else axis
            size = int(np.prod([mesh.shape[a] for a in axes]))
            if leaf.shape[dim] % size != 0:
                raise ValueError(
                    f"param {list(names)} dim {dim} ({leaf.shape[dim]}) "
                    f"not divisible by {axis}={size}")
        return leaf

    _map_with_path(check, params)


def _leaf_at(tree, names):
    for n in names:
        tree = tree[int(n)] if isinstance(tree, (list, tuple)) else tree[n]
    return tree


def _segments(owner: str, block: dict) -> List[int]:
    """The fused segments of a sharded layer's split dim (widths, in
    order): 3 x h for a qkv, h x 3 + mh for ``linear1``, h + mh for
    ``linear2``, one segment otherwise."""
    p = block[owner]
    w_q = "w_q" in p
    d_in = p["w_q"].shape[1] if w_q else p["w"].shape[0]
    d_out = p["w_q"].shape[0] if w_q else p["w"].shape[1]
    if owner in ("img_qkv", "txt_qkv"):
        return [d_out // 3] * 3
    if owner == "linear1":
        return [d_in] * 3 + [d_out - 3 * d_in]
    if owner == "linear2":
        return [d_out, d_in - d_out]
    return [d_out if owner in COL_SHARDED else d_in]


def _attention_segments(owner: str) -> int:
    """How many leading segments of the split dim belong to attention."""
    return {"img_qkv": 3, "txt_qkv": 3, "linear1": 3, "linear2": 1,
            "img_proj": 1, "txt_proj": 1}.get(owner, 0)


def _head_dim(block: dict) -> int:
    norm = block.get("qknorm", block.get("img_qknorm"))
    return int(norm["q"]["scale"].shape[0])


def _split(x: torch.Tensor, dim: int, segs: List[int], n: int, r: int,
           whole: int, col: bool) -> torch.Tensor:
    """Rank r's piece of ``x`` along ``dim``: per segment its r-th of n
    slices, but the first ``whole`` segments whole: on every rank in a
    column-sharded layer, on rank 0 (zeros on the others) in a
    row-sharded one."""
    parts, start = [], 0
    for j, width in enumerate(segs):
        seg = x.narrow(dim, start, width)
        if j >= whole:
            parts.append(seg.narrow(dim, r * (width // n), width // n))
        elif col or r == 0:
            parts.append(seg)
        else:
            parts.append(torch.zeros_like(seg))
        start += width
    return torch.cat(parts, dim=dim).contiguous()


def fsdp_leaf(spec, fsdp_axis: Optional[str]) -> bool:
    """True for a leaf that FSDP cuts along dim 0 over ``fsdp_axis``."""
    return fsdp_axis is not None and tuple(spec) == (fsdp_axis,)


def _fsdp_split(params, specs, mesh, fsdp_axis):
    n = mesh.shape.get(fsdp_axis, 1)
    if n == 1:
        return params
    r = mesh.index(fsdp_axis)

    def cut(names, leaf):
        if not fsdp_leaf(_leaf_at(specs, names), fsdp_axis):
            return leaf
        piece = leaf.shape[0] // n
        return leaf.narrow(0, r * piece, piece).contiguous()

    return _map_with_path(cut, params)


def whole_attention(params, n: int) -> bool:
    """True where the heads do not divide over a TP axis of ``n`` ranks,
    so :func:`shard_params` keeps the attention whole (the zero-row
    fallback)."""
    if n == 1:
        return False
    return any((_segments(owner, block)[0] // n) % _head_dim(block) != 0
               for kind in ("double", "single") for block in params[kind]
               for owner in block if _attention_segments(owner))


def check_trainable(params, mesh, model_axis: str = "model") -> None:
    """Refuse to train a tree whose TP split is the zero-row fallback:
    rank 0 holds the attention rows of the row-sharded layers and the
    others zeros, in which they would learn."""
    n = mesh.shape.get(model_axis, 1)
    if whole_attention(params, n):
        raise ValueError(
            f"the heads do not divide over {model_axis}={n}: the split "
            "keeps the attention whole (rank 0's rows, zeros elsewhere), "
            "which serves but cannot train; choose a model_parallel that "
            "divides the heads")


def shard_params(params, mesh, specs=None, **kw):
    """This rank's tree of a full Flux param tree (the JAX ``device_put``
    of each leaf with its spec): the blocks' sharded layers split by
    segment over ``model_axis`` (default ``"model"``), and with
    ``fsdp_axis`` the FSDP leaves cut along dim 0 over it; every other
    leaf shared. ``specs`` (default :func:`flux_param_specs` of ``kw``)
    are validated against the mesh first. An axis of one rank leaves the
    leaves as they are (the same tensors)."""
    model_axis = kw.get("model_axis", "model")
    if specs is None:
        specs = flux_param_specs(params, **kw)
    validate_divisibility(params, specs, mesh)
    if kw.get("fsdp_axis") is not None:
        params = _fsdp_split(params, specs, mesh, kw["fsdp_axis"])
    n = mesh.shape.get(model_axis, 1)
    if n == 1:
        return params
    r = mesh.index(model_axis)

    def shard_block(block: dict) -> dict:
        hd = _head_dim(block)
        out = dict(block)
        for owner in COL_SHARDED + ROW_SHARDED:
            if owner not in block:
                continue
            segs = _segments(owner, block)
            attn = _attention_segments(owner)
            whole_attn = attn and (segs[0] // n) % hd != 0
            for width in segs[attn if whole_attn else 0:]:
                if width % n:
                    raise ValueError(f"{owner} segment {width} not "
                                     f"divisible by {model_axis}={n}")
            col = owner in COL_SHARDED
            whole = attn if whole_attn else 0
            q = {}
            for key, x in block[owner].items():
                if key == "w":
                    dim = 1 if col else 0
                elif key == "w_q":                  # K-major: (out, in)
                    dim = 0 if col else 1
                elif col:                           # b, w_s: per out lane
                    dim = 0
                else:
                    q[key] = x          # b, w_s of a row-sharded layer
                    continue
                q[key] = _split(x, dim, segs, n, r, whole, col)
            out[owner] = q
        return out

    shared = {k: v for k, v in params.items() if k not in ("double",
                                                         "single")}
    shared["double"] = [shard_block(b) for b in params["double"]]
    shared["single"] = [shard_block(b) for b in params["single"]]
    return shared


def _unsplit(x: torch.Tensor, dim: int, segs: List[int], n: int, mesh,
             axis: str) -> torch.Tensor:
    """Inverse of :func:`_split` without a whole segment: every rank's
    piece of each segment gathered over ``axis``, in order."""
    gathered = mesh.all_gather(x, axis, dim)
    local = x.shape[dim]
    pieces, start = [], 0
    for width in segs:
        w = width // n
        pieces += [gathered.narrow(dim, r * local + start, w)
                   for r in range(n)]
        start += w
    return torch.cat(pieces, dim=dim)


def unshard_params(local, full_shapes, mesh, model_axis: str = "model",
                   fsdp_axis: Optional[str] = None):
    """The whole tree of a rank's :func:`shard_params` share (a
    collective: every rank of the mesh calls it and gets the whole
    tree). ``full_shapes`` is a tree of the whole leaves, or of anything
    with their ``shape`` (the params before sharding): it gives each
    sharded layer's fused segments. The zero-row fallback has no inverse
    here (it trains nowhere)."""
    specs = flux_param_specs(full_shapes, model_axis=model_axis,
                             fsdp_axis=fsdp_axis)
    out = local
    nd = mesh.shape.get(fsdp_axis, 1) if fsdp_axis else 1
    if nd > 1:
        out = _map_with_path(
            lambda names, x: mesh.all_gather(x.detach(), fsdp_axis, 0)
            if fsdp_leaf(_leaf_at(specs, names), fsdp_axis) else x, out)
    n = mesh.shape.get(model_axis, 1)
    if n == 1:
        return out
    check_trainable(full_shapes, mesh, model_axis)

    def unshard_block(block: dict, full: dict) -> dict:
        res = dict(block)
        for owner in COL_SHARDED + ROW_SHARDED:
            if owner not in block:
                continue
            segs = _segments(owner, full)
            col = owner in COL_SHARDED
            res[owner] = {key: _unsplit(x.detach(), int(col and key == "w"),
                                        segs, n, mesh, model_axis)
                          if key == "w" or (key == "b" and col) else x
                          for key, x in block[owner].items()}
        return res

    out = dict(out)
    for kind in ("double", "single"):
        out[kind] = [unshard_block(b, f)
                     for b, f in zip(out[kind], full_shapes[kind])]
    return out

