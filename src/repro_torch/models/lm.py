"""Shared LM scaffolding: the port of ``repro.models.lm``.

Every model exposes the JAX package's surface, with the params held in the
model (``model.params``, a :class:`~repro_torch.models.layers.ParamTree`
keyed as the reference's param pytree) instead of passed in:

    model.init(generator)                 -> model (params drawn on the
                                             generator's device)
    model.loss(batch)                     -> (scalar loss, metrics dict)
    model.prefill(batch, cache_len)       -> (last_logits, cache)
    model.decode_step(cache, token, pos)  -> (logits, cache)
    model.batch_spec(batch, seq)          -> meta tensors of a training batch
    model.cache_spec(batch, seq)          -> meta tensors (shapes, dtypes)

``models/convert.py`` fills ``model.params`` from the JAX package's params
instead.  The reference's ``jax.lax.scan`` over stacked layers is a loop
over ``params["layers"]``, an ``nn.ModuleList`` (:func:`scan_layers`), and
its ``jax.checkpoint`` policies are ``torch.utils.checkpoint``
(:func:`maybe_remat`).

Under a model axis that cuts the weights (``runtime.tp_group``) ``embed``
holds the rank's d columns and ``lm_head`` its vocab block: the embedding
gathers its rows locally, then all-gathers the columns; the logits are
the rank's vocab block (an encoder-decoder's tied ``embed``: its vocab
rows, ``encdec``), all-gathered, so ``prefill`` and ``decode_step``
return every ``padded_vocab`` column on every rank and ``loss`` reads the
full logits (the gather's backward takes the rank's block).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..kernels.ref import no_tf32
from . import runtime
from .config import ArchConfig
from .layers import Gen, ParamTree, apply_norm, norm_init, normal
from .sharding import batch_sharded


def cache_leaves(tree) -> list:
    """The tensors of a cache: a dict of tensors, or the hybrid's nested
    dicts and tuples of them."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for x in items for t in cache_leaves(x)]


def cache_nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in cache_leaves(tree))


def xent(logits: torch.Tensor, labels: torch.Tensor, group=None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy with label -1 = ignore, in fp32: logits (B, S, V),
    labels (B, S) -> (mean loss, accuracy) over the labelled positions.
    With a process ``group`` (a mesh's data axes) the sums and the count
    are taken over every rank's positions: the global masked mean, whose
    backward on each rank is its own positions' share of the gradient."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    sums = torch.stack([((lse - ll) * mask).sum(),
                        ((lf.argmax(-1) == labels).float() * mask).sum()])
    n = mask.sum()
    if group is not None:
        sums = runtime.psum_identity_bwd(sums, group)
        n = runtime.psum_identity_bwd(n, group)
    loss, acc = sums / n.clamp(min=1.0)
    return loss, acc


#: the matmuls with no batch dims (the dense projections: ``x @ w``
#: reaches ``mm``), which ``jax.checkpoint_policies.
#: checkpoint_dots_with_no_batch_dims`` saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(fn: Callable, cfg: ArchConfig) -> Callable:
    """``fn`` under the config's rematerialisation: ``"full"`` keeps only
    its inputs and recomputes the rest in backward, ``"dots"`` also keeps
    the outputs of its dense projections, anything else (``"none"``) keeps
    everything."""
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    return fn


def scan_layers(layers, x: torch.Tensor, body: Callable,
                cfg: ArchConfig, with_aux: bool = False):
    """``body(layer_params, x) -> x`` over the layers in order, each under
    :func:`maybe_remat`.  With ``with_aux`` the body returns ``(x, aux)``
    and the result is ``(x, sum of the layers' aux)``, the sum in fp32
    from 0 as the reference's scan carries it."""
    body_r = maybe_remat(body, cfg)
    if with_aux:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in layers:
            x, a = body_r(p, x)
            aux = aux + a
        return x, aux
    for p in layers:
        x = body_r(p, x)
    return x


class BaseLM(nn.Module):
    """Decoder-only scaffold shared by the zoo's families."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.params: Optional[ParamTree] = None

    # ---------------- params ---------------- #
    def init_layers(self, gen: Gen) -> list:
        raise NotImplementedError

    def param_tree(self, gen: Gen) -> dict:
        """A fresh param dict, keyed as the reference's ``model.init``;
        ``gen=None`` gives meta tensors (shapes and dtypes only)."""
        cfg = self.cfg
        p = {
            "embed": normal(gen, (cfg.padded_vocab, cfg.d_model), 0.02,
                            cfg.jdtype),
            "layers": self.init_layers(gen),
            "ln_f": norm_init(gen, cfg.d_model, cfg.jdtype, cfg.norm),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = normal(gen, (cfg.d_model, cfg.padded_vocab), 0.02,
                                  cfg.jdtype)
        return p

    def init(self, gen: torch.Generator) -> "BaseLM":
        """Draw every param from ``gen``, on ``gen``'s device."""
        self.params = ParamTree(self.param_tree(gen))
        return self

    def _p(self) -> ParamTree:
        if self.params is None:
            raise RuntimeError(f"{self.cfg.arch_id}: no params; call "
                               f"init(generator) or convert.params_from_numpy")
        if self.params["embed"].is_cuda:
            no_tf32()
        return self.params

    # ---------------- forward pieces ---------------- #
    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) token ids -> (B, S, d)."""
        e = self._p()["embed"][tokens.long()]
        group = runtime.tp_group(self.cfg)
        if group is None:
            return e
        n = runtime.group_index(group)[0]
        if e.shape[-1] * n != self.cfg.d_model:
            raise ValueError(f"embed holds {e.shape[-1]} columns, want "
                             f"{self.cfg.d_model // n} on a model axis of "
                             f"{n} (convert.shard_params cuts them)")
        return runtime.gather_last(e, group)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        p = self._p()
        w = p["embed"].T if self.cfg.tie_embeddings else p["lm_head"]
        group = runtime.tp_group(self.cfg)
        if group is None:
            return h @ w
        return runtime.gather_last(runtime.pvary(h, group) @ w, group)

    def local(self, width: int) -> int:
        """``width`` channels (KV slots) of a model axis: this rank's
        ``width / n`` on a model axis of n (``runtime.tp_group``), else
        all of them."""
        group = runtime.tp_group(self.cfg)
        return width // (1 if group is None
                         else runtime.group_index(group)[0])

    def kv_slots(self) -> int:
        """The KV slots a layer's cache holds here: ``cfg.groups``, or this
        rank's ``groups / n`` on a model axis of n (``runtime.tp_group``)."""
        return self.local(self.cfg.groups)

    @staticmethod
    def cache_rows(batch: int) -> int:
        """The rows of a global ``batch`` this process holds: ``B / n_dp``
        where the active mesh's data axes divide it (``steps.local_batch``),
        else B."""
        mesh = runtime.get_mesh()
        if mesh is None or not batch_sharded(mesh, batch):
            return batch
        return batch * mesh.shape["model"] // mesh.size

    # ---------------- family-specific hooks ---------------- #
    def backbone(self, x: torch.Tensor):
        """Full-sequence residual stream (train). Returns (h, aux)."""
        raise NotImplementedError

    def backbone_prefill(self, x: torch.Tensor, cache_len: Optional[int] = None):
        """Returns (h, cache). ``cache_len`` pads attention caches with
        headroom for subsequent decode_step writes (serving allocates the
        max length up front)."""
        raise NotImplementedError

    def backbone_decode(self, cache, x: torch.Tensor, pos: int):
        """Returns (h (B,1,d), cache)."""
        raise NotImplementedError

    def embed_batch(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The residual stream's input for ``loss`` and ``prefill``: the
        token embeddings here; a family with other inputs (the VLM's image
        embeddings) overrides it."""
        return self.embed(batch["tokens"])

    # ---------------- public API ---------------- #
    def loss(self, batch: Dict[str, torch.Tensor]):
        """``batch["tokens"]``, ``batch["labels"]`` (B, S) -> (total loss,
        metrics ``ce``, ``aux``, ``acc``): ``total = ce + 0.01 * aux``,
        over the last S positions of the residual stream (a VLM's text).
        Differentiable in the params once they want gradients.  Under a
        process mesh (``runtime.use_mesh``) the batch is this rank's and
        ``ce`` / ``acc`` are over the data axes' positions (``xent``)."""
        x = self.embed_batch(batch)
        h, aux = self.backbone(x)
        h = apply_norm(self._p()["ln_f"],
                       h[:, h.shape[1] - batch["labels"].shape[1]:])
        mesh = runtime.get_mesh()
        loss, acc = xent(self.logits(h), batch["labels"],
                         None if mesh is None else runtime.data_group(mesh))
        total = loss + 0.01 * aux
        return total, {"ce": loss, "aux": aux, "acc": acc}

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None):
        """``batch["tokens"]`` (B, S) -> (logits (B, 1, V) of the last
        position, cache)."""
        x = self.embed_batch(batch)
        h, cache = self.backbone_prefill(x, cache_len)
        h = apply_norm(self._p()["ln_f"], h[:, -1:])
        return self.logits(h), cache

    @torch.no_grad()
    def decode_step(self, cache, token: torch.Tensor, pos: int):
        """One token (B, 1) at position ``pos`` against ``cache``, which is
        updated in place -> (logits (B, 1, V), cache)."""
        x = self.embed(token)                            # (B,1,d)
        h, cache = self.backbone_decode(cache, x, int(pos))
        h = apply_norm(self._p()["ln_f"], h)
        return self.logits(h), cache

    def batch_spec(self, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        """A training batch's tensors on the meta device, in the
        reference's key order (``launch.train`` draws them in it)."""
        return {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                      device="meta"),
                "labels": torch.empty((batch, seq), dtype=torch.int32,
                                      device="meta")}

    def cache_spec(self, batch: int, seq: int):
        raise NotImplementedError

    def supports_long_context(self) -> bool:
        return False
