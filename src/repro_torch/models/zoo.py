"""Model zoo facade — the port of ``repro.models.zoo``: one :class:`Model`
per architecture exposing init / forward / decode with shape-spec-aware
batch construction, plus :func:`params_from_numpy`, which carries the JAX
package's params into the port.

``Model.init`` and :func:`params_from_numpy` are entry points: they put
the params on the card unless the caller passes ``device="cpu"``.
``forward``, ``decode_step`` and the serving functions run where their
tensors lie. ``abstract_params`` (JAX's ``eval_shape`` of ``init``) gives
the params on the ``meta`` device, with no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------- params
    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> dict:
        """Random params drawn from ``generator`` (default: seed 0 on
        ``device``) on ``device`` (default: the card)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        elif generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, params "
                             f"asked for on {dev}")
        return T.init_params(self.cfg, generator)

    def abstract_params(self, generator: Optional[torch.Generator] = None
                        ) -> dict:
        """The params' tree, shapes and dtypes on the ``meta`` device with
        no storage (``init`` traced under ``FakeTensorMode``)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            tree = T.init_params(self.cfg, generator or torch.Generator())
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), tree)

    # -------------------------------------------------------------- shapes
    def text_len(self, seq_len: int) -> int:
        """Decoder token length for a cell's seq_len (frontends/enc-dec
        consume part of the sequence)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return seq_len - int(seq_len * cfg.enc_seq_fraction)
        if cfg.frontend == "vision_stub":
            return seq_len - cfg.n_frontend_tokens
        return seq_len

    def batch_shapes(self, shape: ShapeSpec
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of every model input of this cell."""
        cfg = self.cfg
        b = shape.global_batch
        s_text = self.text_len(shape.seq_len)
        out = {"tokens": ((b, s_text), torch.int32)}
        if shape.is_train:
            out["labels"] = ((b, s_text), torch.int32)
        if cfg.family == "encdec":
            out["frames"] = ((b, shape.seq_len - s_text, cfg.d_model),
                             torch.float32)
        if cfg.frontend == "vision_stub":
            out["frontend"] = ((b, cfg.n_frontend_tokens, cfg.d_model),
                               torch.float32)
        return out

    def concrete_batch(self, shape: ShapeSpec,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> Dict[str, torch.Tensor]:
        """Random inputs of this cell on ``device`` (default: the card),
        drawn from ``generator`` (default: seed 7), names in sorted
        order."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(7)
        out = {}
        for name, (shp, dtype) in sorted(self.batch_shapes(shape).items()):
            if dtype.is_floating_point:
                out[name] = torch.randn(shp, generator=generator,
                                        device=dev, dtype=dtype)
            else:
                out[name] = torch.randint(0, self.cfg.vocab_size, shp,
                                          generator=generator, device=dev,
                                          dtype=dtype)
        return out

    # ------------------------------------------------------------- compute
    def forward(self, params, batch, axes=None):
        return T.forward(params, batch, self.cfg, axes)

    def init_cache(self, batch_size: int, s_max: int, dtype=None,
                   enc_len: int = 0, device=None) -> dict:
        """Zero decode cache on ``device`` (default: the card)."""
        return T.init_cache(self.cfg, batch_size, s_max, dtype, enc_len,
                            device=resolve_device(device))

    def decode_step(self, params, cache, tokens, pos, axes=None):
        return T.decode_step(params, cache, tokens, pos, self.cfg, axes)

    @property
    def padded_vocab(self) -> int:
        return T.padded_vocab(self.cfg)


def build(cfg: ModelConfig) -> Model:
    """A :class:`Model` for ``cfg``; raises :class:`NotImplementedError`
    for a family or block kind the model does not know."""
    cfg.validate()
    T.check_supported(cfg)
    return Model(cfg)


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """numpy -> tensor on ``dev``, bfloat16 arrays (numpy's ``ml_dtypes``
    extension type) by their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def _check_layout(tree, split, what: str) -> None:
    """``tree``'s ``blocks`` slots and ``tail`` against the (n_periods,
    period, tail) ``split``, each slot with ``n_periods`` along its leading
    axis."""
    n_periods, period, tail = split
    slots = {f"s{si}" for si in range(len(period))}
    if set(tree["blocks"]) != slots or len(tree["tail"]) != len(tail):
        raise ValueError(f"params do not match {what}'s layout: blocks "
                         f"{sorted(tree['blocks'])}, {len(tree['tail'])} "
                         f"tail blocks; want {len(period)} slots and "
                         f"{len(tail)} tail blocks")
    for slot, block in tree["blocks"].items():
        leads = set()
        tree_map(lambda a: leads.add(np.shape(a)[0]), block)
        if leads != {n_periods}:
            raise ValueError(f"params do not match {what}'s layout: slot "
                             f"{slot} stacks {sorted(leads)} periods; want "
                             f"{n_periods}")


def params_from_numpy(tree, cfg: ModelConfig, device=None,
                      shardings=None) -> dict:
    """The JAX package's params (``jax.tree.map(np.asarray, params)``) as
    the port's: the same nesting (dicts, the ``tail`` lists) and dtypes, on
    ``device`` (default: the card), or, with ``shardings`` (a matching tree
    of ``sharding.NamedSharding``), as DTensors on their mesh, each rank
    keeping its slice. Checks the tree against ``cfg``'s block layout, the
    encoder's included."""
    if shardings is not None:
        from repro_torch.sharding import distribute, mesh_device

        dev = mesh_device(tree_leaves(shardings)[0].mesh)
        return distribute(params_from_numpy(tree, cfg, dev), shardings)
    dev = resolve_device(device)
    _check_layout(tree, cfg.pattern_split(), cfg.name)
    if (cfg.family == "encdec") != ("encoder" in tree):
        raise ValueError(f"params do not match {cfg.name}'s layout: "
                         f"encoder {'encoder' in tree}, family {cfg.family}")
    if "encoder" in tree:
        _check_layout(tree["encoder"], T._encoder_split(cfg),
                      f"{cfg.name}'s encoder")
    want = (T.padded_vocab(cfg), cfg.d_model)
    if tuple(np.shape(tree["embed"]["tok"])) != want:
        raise ValueError(f"embedding {np.shape(tree['embed']['tok'])}, "
                         f"want {want}")
    return tree_map(lambda a: _tensor(a, dev), tree)
