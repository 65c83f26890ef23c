"""KGE model interface.

Every model maps integer (h, r, t) ids to a real-valued plausibility score —
**higher is more plausible** (distance models return negative distance).
Params are plain dicts of tensors on one device, as the JAX package's are
plain pytrees of arrays.

The paper trains all models with PyKEEN defaults except dim=200 and
epochs=100; those two are the framework defaults here too.

The port of ``repro.kge.base``.  Random draws come from an explicit
``torch.Generator`` (they differ from ``jax.random``'s for the same seed);
:func:`params_from_numpy` and :func:`params_to_numpy` carry parameters
between the two packages, e.g. through ``SnapshotStore.save_params``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]

#: paper's fixed hyperparameters
PAPER_DIM = 200
PAPER_EPOCHS = 100


@dataclasses.dataclass(frozen=True)
class KGESpec:
    """Static model hyperparameters."""

    name: str
    n_entities: int
    n_relations: int
    dim: int = PAPER_DIM
    loss: str = "margin"      # margin | nssa | softplus | bce
    margin: float = 1.0
    p_norm: int = 1           # for translational models
    dtype: Any = torch.float32


class KGEModel:
    """Base class. Subclasses define ``param_shapes``, ``init``, ``score``
    and the score_all_* fast paths (+ optionally the post-step constraint
    and ``kge_score_model``, the name under which ``kernels.ops.kge_score``
    scores this model)."""

    #: ``kernels.ops.kge_score`` model name, or None for no fused scoring
    kge_score_model: Optional[str] = None

    def __init__(self, spec: KGESpec):
        self.spec = spec

    # ------------------------------------------------------------------ #
    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """``{name: shape}`` of every table ``init`` makes."""
        raise NotImplementedError

    def init(self, generator: torch.Generator) -> Params:
        """Fresh params on ``generator``'s device."""
        raise NotImplementedError

    def score(self, params: Params, h: torch.Tensor, r: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
        """Elementwise score over broadcastable id tensors."""
        raise NotImplementedError

    def score_all_tails(self, params: Params, h: torch.Tensor,
                        r: torch.Tensor) -> torch.Tensor:
        """(B,) ids -> (B, N) scores against every entity as tail (the
        1-vs-all fast path of the ranking eval)."""
        raise NotImplementedError

    def score_all_heads(self, params: Params, r: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    def constrain(self, params: Params) -> Params:
        """Post-step constraint (e.g. TransE's entity norm clamp), applied
        in place. Default: none."""
        return params

    def regularizer(self, params: Params, h: torch.Tensor, r: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
        return torch.zeros((), dtype=self.spec.dtype,
                           device=params["entity"].device)

    def entity_embeddings(self, params: Params) -> torch.Tensor:
        """(N, dim) table that the serving layer snapshots and serves."""
        return params["entity"]

    # ------------------------------------------------------------------ #
    def param_roles(self) -> Dict[str, Optional[str]]:
        """Which vocabulary each param table's leading axis indexes.

        Returns {param_name: "entity" | "relation" | None}, inferred from
        the leading dimension of ``param_shapes`` (nothing is allocated).
        Entity wins ties when n_entities == n_relations; override for
        models where that inference is wrong.
        """
        roles: Dict[str, Optional[str]] = {}
        for name, shape in self.param_shapes().items():
            if shape and shape[0] == self.spec.n_entities:
                roles[name] = "entity"
            elif shape and shape[0] == self.spec.n_relations:
                roles[name] = "relation"
            else:
                roles[name] = None
        return roles

    def param_shardings(self, mesh_axis: str = "model",
                        axis_size: Optional[int] = None
                        ) -> Dict[str, Tuple[Optional[str], ...]]:
        """``{name: spec}`` (``models.sharding``'s plain-tuple specs): each
        table row-sharded over ``mesh_axis``, or replicated when its rows
        do not divide ``axis_size`` (e.g. the 3-row GO relation table on a
        16-way axis)."""
        def spec_for(shape) -> Tuple[Optional[str], ...]:
            if axis_size and shape[0] % axis_size != 0:
                return (None,) * len(shape)
            return (mesh_axis,) + (None,) * (len(shape) - 1)

        return {k: spec_for(v) for k, v in self.param_shapes().items()}


# ---------------------------------------------------------------------- #
_REGISTRY: Dict[str, Callable[[KGESpec], KGEModel]] = {}


def register(name: str) -> Callable:
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def make_model(name: str, n_entities: int, n_relations: int, dim: int = PAPER_DIM,
               **kw) -> KGEModel:
    if name not in _REGISTRY:
        raise KeyError(f"unknown KGE model {name!r}; have {sorted(_REGISTRY)}")
    defaults = _MODEL_DEFAULTS.get(name, {})
    merged = {**defaults, **kw}
    spec = KGESpec(name=name, n_entities=n_entities, n_relations=n_relations,
                   dim=dim, **merged)
    return _REGISTRY[name](spec)


def available_models() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


#: per-model default losses (mirrors PyKEEN's per-model defaults)
_MODEL_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "transe": dict(loss="margin", p_norm=1),
    "transr": dict(loss="margin", p_norm=2),
    "distmult": dict(loss="margin"),
    "hole": dict(loss="margin"),
    "boxe": dict(loss="nssa"),
    "rdf2vec": dict(loss="bce"),
}


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for an id tensor of any shape, through
    ``index_select``.  Its backward scatters with atomic adds; the
    backward of advanced indexing sorts the ids and walks each id's
    duplicates serially, so a (1024, 32) batch of ids into a 3-row
    relation table (or onto RDF2vec's few relation tokens) puts ~11,000
    duplicates of a row through one serial loop."""
    return table.index_select(0, ids.reshape(-1)).view(
        *ids.shape, *table.shape[1:])


def _uniform_init(generator: torch.Generator, shape: Tuple[int, ...],
                  dim: int, dtype) -> torch.Tensor:
    """PyKEEN/TransE-style xavier-uniform: U(-6/sqrt(d), 6/sqrt(d)), drawn
    on ``generator``'s device."""
    bound = 6.0 / math.sqrt(dim)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.uniform_(-bound, bound, generator=generator)


# --------------------- params across the packages --------------------- #
def params_from_numpy(model: KGEModel, arrays: Mapping[str, Any],
                      device) -> Params:
    """``model``'s tables from numpy arrays (the JAX package's params, or
    what ``SnapshotStore.load_params`` returns) as contiguous tensors of the
    model's dtype on ``device``.  Raises ``KeyError`` for a missing table
    and ``ValueError`` for a table of another shape."""
    out: Params = {}
    for name, shape in model.param_shapes().items():
        if name not in arrays:
            raise KeyError(f"{model.spec.name}: no table {name!r} in "
                           f"{sorted(arrays)}")
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{model.spec.name}: table {name!r} has shape "
                             f"{tuple(a.shape)}, the model {tuple(shape)}")
        # a copy: training writes the tables in place
        out[name] = torch.tensor(a, dtype=model.spec.dtype).to(device)
    return out


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host numpy copies of ``params`` (what the registry publishes)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


# ------------------------- warm-start helpers ------------------------- #
def vocab_remap(old_vocab, new_vocab) -> np.ndarray:
    """Row map from a new vocabulary onto an old one, matched by name.

    Returns an (len(new_vocab),) int32 array: ``map[i]`` is the old row of
    new item ``i``, or -1 if the item did not exist in the old vocabulary
    (fresh-initialize). Works for entity lists, relation lists, and
    rdf2vec walk-token vocabularies alike — anything addressed by string.
    """
    old_index = {name: i for i, name in enumerate(old_vocab)}
    return np.asarray([old_index.get(name, -1) for name in new_vocab],
                      dtype=np.int32)


def remap_params(
    model: KGEModel,
    generator: torch.Generator,
    prev_params: Mapping[str, Any],
    entity_map,
    relation_map,
) -> Tuple[Params, Dict[str, int]]:
    """Map a previous version's params onto ``model``'s index space.

    For each param table, rows whose vocabulary item survived the release
    (map >= 0) are carried over from ``prev_params`` (tensors or numpy
    arrays); rows for new items keep their fresh initialization; rows for
    removed items are dropped.  Tables whose trailing shape changed (e.g.
    a dim change between versions) or that the previous checkpoint lacks
    fall back to fresh init wholesale — a silent architecture mismatch
    must not corrupt training.

    Returns (params on ``generator``'s device, stats) with per-role
    carried/fresh row counts.
    """
    fresh = model.init(generator)
    roles = model.param_roles()
    maps = {"entity": np.asarray(entity_map, dtype=np.int32),
            "relation": np.asarray(relation_map, dtype=np.int32)}
    out: Params = {}
    stats = {"entity_carried": int((maps["entity"] >= 0).sum()),
             "entity_fresh": int((maps["entity"] < 0).sum()),
             "relation_carried": int((maps["relation"] >= 0).sum()),
             "relation_fresh": int((maps["relation"] < 0).sum()),
             "tables_carried": 0, "tables_fresh": 0}
    for name, table in fresh.items():
        role = roles.get(name)
        prev = prev_params.get(name)
        if role is None or prev is None:
            out[name] = table
            stats["tables_fresh"] += 1
            continue
        if not isinstance(prev, torch.Tensor):
            prev = torch.from_numpy(np.array(prev))    # may be read-only
        prev = prev.to(device=table.device, dtype=table.dtype)
        mapping = maps[role]
        if (prev.dim() != table.dim() or prev.shape[1:] != table.shape[1:]
                or mapping.shape[0] != table.shape[0]):
            out[name] = table
            stats["tables_fresh"] += 1
            continue
        m = torch.from_numpy(mapping.astype(np.int64)).to(table.device)
        carried = prev[m.clamp(0, prev.shape[0] - 1)]
        keep = (m >= 0).reshape((-1,) + (1,) * (table.dim() - 1))
        out[name] = torch.where(keep, carried, table)
        stats["tables_carried"] += 1
    return out, stats
