"""Sharding rules for the LM zoo: the port of ``repro.models.sharding``.

Pure rules over names and shapes.  A spec is a tuple with one entry per
dim: an axis name, a tuple of names, or None (the reference's
``PartitionSpec`` in plain Python).  The mesh is a
``launch.mesh.MeshShape`` (anything with ``axis_names`` and a ``shape``
dict).  Axes: ``("data", "model")``, or ``("pod", "data", "model")``;
``"pod"`` composes with ``"data"`` for the batch, ``"model"`` carries
tensor / expert / channel parallelism:

  * embed (V, d) shards d (an audio model's tied embed shards V);
    lm_head (d, V) shards V;
  * attention wq / wk / wv shard their output, wo its input;
  * MLP gate / up shard ff, down its input;
  * MoE experts (E, d, ff) shard E when the experts (times
    ``moe_ff_split``) divide the model axis, else ff inside each expert;
  * Mamba and RG-LRU shard every channel dim;
  * caches shard their batch over the data axes and their KV-slot (or
    largest divisible channel) axis over ``"model"``.

The port's params hold one entry a layer where the reference stacks
``(L, ...)``; every rule places its axis from the right, so a layer's
spec is the reference's without the leading stacked entry.  On a process
mesh ``convert.shard_params`` cuts every family by these rules
(:func:`mesh_pspec`), so the dry run's per-device bytes are a rank's.
"""
from __future__ import annotations

from typing import Any, Tuple

from .config import ArchConfig

MODEL_AXIS = "model"
Spec = Tuple[Any, ...]


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_sharded(mesh, global_batch: int) -> bool:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return global_batch % n == 0 and global_batch >= n


def batch_pspec(mesh, global_batch: int, ndim: int) -> Spec:
    """``(data axes, None, ...)`` when the batch divides the data axes,
    else replicated."""
    if batch_sharded(mesh, global_batch):
        return (data_axes(mesh),) + (None,) * (ndim - 1)
    return (None,) * ndim


def _expert_parallel(cfg: ArchConfig, axis_size: int) -> bool:
    if cfg.moe is None:
        return False
    return cfg.moe.n_experts * max(1, cfg.moe_ff_split or 1) % axis_size == 0


#: (parent, leaf) -> dim (from the right) sharded over the model axis; a
#: parent of "" matches any
_RULES = {
    ("wq", "w"): -1, ("wk", "w"): -1, ("wv", "w"): -1,
    ("wq", "b"): -1, ("wk", "b"): -1, ("wv", "b"): -1, ("wo", "w"): -2,
    ("gate", "w"): -1, ("up", "w"): -1, ("down", "w"): -2,
    ("in_proj", "w"): -1, ("", "conv_w"): -1, ("", "conv_b"): -1,
    ("x_proj", "w"): -2, ("dt_proj", "w"): -1, ("dt_proj", "b"): -1,
    ("", "A_log"): -2, ("", "D"): -1, ("out_proj", "w"): -2,
    ("in_x", "w"): -1, ("in_gate", "w"): -1, ("wa", "w"): -1,
    ("wa", "b"): -1, ("wx", "w"): -1, ("wx", "b"): -1, ("", "lam"): -1,
    ("out", "w"): -2,
}


def param_pspec(cfg: ArchConfig, path: Tuple[str, ...], ndim: int,
                axis_size: int) -> Spec:
    """The spec of one param leaf, identified by its tree path."""
    last = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    pos = None
    if last == "embed":
        pos = -2 if cfg.family == "audio" else -1
    elif last == "lm_head":
        pos = -1
    elif cfg.moe and parent == "moe" and last in ("gate", "up", "down") \
            and ndim >= 3:
        if _expert_parallel(cfg, axis_size):
            pos = -3
        else:
            pos = -2 if last == "down" else -1
    else:
        pos = _RULES.get((parent, last), _RULES.get(("", last)))
    spec = [None] * ndim
    if pos is not None:
        spec[ndim + pos] = MODEL_AXIS
    return tuple(spec)


#: the families a process mesh cuts by :func:`param_pspec`: the
#: attention families (their blocks share ``attn_*`` and ``mlp``), the
#: channel-parallel recurrences (Mamba, and the hybrid's RG-LRU beside its
#: attention and MLP) and the encoder-decoder (its tied ``embed`` by
#: vocab rows, ``dec_pos`` whole, the cross-attention as the
#: self-attention)
TP_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def mesh_pspec(cfg: ArchConfig, path: Tuple[str, ...], ndim: int,
               axis_size: int) -> Spec:
    """A leaf's layout on a process mesh (``convert.shard_params``):
    :func:`param_pspec`'s for :data:`TP_FAMILIES`.  Two deviations:

      * with ``cfg.moe_impl == "gspmd"`` an MoE layer's experts stay
        whole, the gspmd impl running the rank's block of tokens through
        every expert (``blocks.moe_apply`` on a mesh);
      * mamba's fused ``in_proj`` (d, 2 d_in), whose output the block
        splits into ``xi | z``, has this spec (dim -1 over the axis) but
        a rank holds ``[xi's channel block | z's channel block]``, (d, 2
        d_in / n), not the n-th contiguous block of its columns (which
        on two ranks would be all of xi, or all of z): under GSPMD the
        reference's contiguous cut is a storage layout, here it is the
        rank's compute (``convert.share_of`` / ``convert.whole_of``).
        The bytes are the same."""
    if cfg.family not in TP_FAMILIES or (
            cfg.moe_impl != "shard_map" and len(path) >= 2
            and path[-2] == "moe"):
        return (None,) * ndim
    return param_pspec(cfg, path, ndim, axis_size)


def tp_config(cfg: ArchConfig, axis_size: int) -> ArchConfig:
    """``cfg`` with its KV slots raised to ``axis_size`` where it carries
    fewer (as the reference's dry run raises them to 16); an
    attention-free config (``n_heads == 0``) as it is."""
    return cfg.with_(kv_groups=axis_size) \
        if cfg.n_heads and cfg.groups < axis_size else cfg


def _tp_dims(cfg: ArchConfig) -> dict:
    """The dims of ``cfg`` a model axis cuts, by name."""
    dims = {"padded_vocab": cfg.padded_vocab, "d_model": cfg.d_model}
    if cfg.family == "ssm":
        dims["d_inner"] = cfg.ssm.expand * cfg.d_model
        return dims
    dims.update({"groups (KV slots)": cfg.groups,
                 "padded_heads()": cfg.padded_heads(),
                 "n_kv_heads * hd": cfg.n_kv_heads * cfg.hd})
    if cfg.moe is None:
        dims["d_ff"] = cfg.d_ff
    if cfg.family == "hybrid":
        dims["lru_width"] = cfg.hybrid.lru_width or cfg.d_model
    return dims


def check_tp(cfg: ArchConfig, axis_size: int) -> None:
    """Raise ``ValueError`` naming each dim of ``cfg`` that a model axis of
    ``axis_size`` cannot cut (:data:`TP_FAMILIES` only): nothing is
    replicated in its place.  For the SSM family the rank's ``d_inner /
    n`` must also be a multiple of ``kernels.selective_scan.D_IN_MULTIPLE``
    (z's rows start that many elements into the rank's in_proj output,
    on the scan kernel's 16-byte rows)."""
    if axis_size == 1 or cfg.family not in TP_FAMILIES:
        return
    dims = _tp_dims(cfg)
    bad = [f"{k} = {v} is not a multiple of it" for k, v in dims.items()
           if v % axis_size]
    if cfg.family == "ssm" and not dims["d_inner"] % axis_size:
        from ..kernels.selective_scan import D_IN_MULTIPLE
        share = dims["d_inner"] // axis_size
        if share % D_IN_MULTIPLE:
            bad.append(f"d_inner / n = {share} is not a multiple of "
                       f"{D_IN_MULTIPLE} (the scan kernel's rows)")
    if cfg.tie_embeddings and cfg.family != "audio":
        bad.append(f"a tied embedding in the {cfg.family} family is not "
                   f"cut (only the audio family's head reads its vocab "
                   f"rows)")
    if cfg.moe_impl == "shard_map" and cfg.moe is not None \
            and not _expert_parallel(cfg, axis_size):
        bad.append(f"{cfg.moe.n_experts} experts (x moe_ff_split) do not "
                   f"divide into it (tensor parallelism inside each "
                   f"expert: ROADMAP Queue 1 item 6)")
    if bad:
        raise ValueError(f"{cfg.arch_id} on a model axis of {axis_size}: "
                         + "; ".join(bad))


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(cfg: ArchConfig, mesh, params_tree) -> Any:
    """The spec of every leaf of ``params_tree`` (tensors, meta ones too)."""
    size = mesh.shape[MODEL_AXIS]
    return _map(lambda p, x: param_pspec(cfg, p, x.dim(), size), params_tree)


def batch_shardings(mesh, global_batch: int, batch_tree) -> Any:
    return _map(lambda _, x: batch_pspec(mesh, global_batch, x.dim()),
                batch_tree)


def cache_shardings(cfg: ArchConfig, mesh, global_batch: int,
                    cache_tree) -> Any:
    """Caches carry a leading layer (or period) axis, then the batch.  Per
    leaf: the batch axis (the first of axes 0-1 of size ``global_batch``)
    over the data axes when they divide it; the KV-slot axis (size
    ``cfg.groups``, when the model axis divides it), else the largest
    later axis the model axis divides, over ``"model"``."""
    size = mesh.shape[MODEL_AXIS]
    dp = data_axes(mesh)
    shard_batch = batch_sharded(mesh, global_batch)

    def one(_, x):
        shape = tuple(x.shape)
        spec = [None] * len(shape)
        b_ax = next((i for i, s in enumerate(shape[:2])
                     if s == global_batch), None)
        if b_ax is not None and shard_batch and global_batch > 1:
            spec[b_ax] = dp
        start = 1 if b_ax is None else b_ax + 1
        m_ax = next((i for i in range(start, len(shape))
                     if shape[i] == cfg.groups and cfg.groups % size == 0),
                    None)
        if m_ax is None:
            best = -1
            for i in range(start, len(shape)):
                if shape[i] % size == 0 and shape[i] > best:
                    best, m_ax = shape[i], i
            if best < size:
                m_ax = None
        if m_ax is not None:
            spec[m_ax] = MODEL_AXIS
        return tuple(spec)

    return _map(one, cache_tree)


def replicated(mesh, tree) -> Any:
    return _map(lambda *_: (), tree)


def shard_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """One device's block of a ``shape`` laid out by ``spec`` on ``mesh``.
    A dim its axes do not divide raises ``ValueError``, as the
    reference's ``NamedSharding.shard_shape`` does."""
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        parts = 1
        for a in names:
            parts *= mesh.shape[a]
        if n % parts:
            raise ValueError(f"dim {i} of {tuple(shape)} ({n}) does not "
                             f"divide into {parts} parts ({spec})")
        out.append(n // parts)
    return tuple(out)


def device_bytes(tree, specs, mesh) -> Tuple[int, int]:
    """``(global bytes, bytes on one device)`` of a tree of tensors laid
    out by the matching tree of specs."""
    sums = [0, 0]

    def walk(x, spec):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], spec[k])
        elif isinstance(x, (list, tuple)):
            for a, b in zip(x, spec):
                walk(a, b)
        else:
            n = x.element_size()
            for d in shard_shape(x.shape, spec, mesh):
                n *= d
            sums[0] += x.numel() * x.element_size()
            sums[1] += n

    walk(tree, specs)
    return sums[0], sums[1]
