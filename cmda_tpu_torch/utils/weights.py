"""Carry weights into the port's modules.

* ``load_jax_variables``: a JAX package variable tree ({'params',
  'batch_stats'} as numpy arrays, e.g. from ``FusionEncoderDecoder.init``)
  -> the port's module of the same kind. It renames flax paths to the
  reference mmseg state_dict keys, unstacks the scanned MiT stages
  (``blocks{s}`` -> ``block{s}.{i}``) and transposes kernels:
      Dense       [in, out]       -> Linear weight [out, in]
      Conv        [kh, kw, in, out] -> Conv2d weight [out, in, kh, kw]
      Depthwise   [k, k, 1, C]    -> Conv2d weight [C, 1, k, k]
  Every model key must be filled and every tree leaf used, at the right
  shape; anything else raises.
* ``strip_prefix`` / ``load_reference_state_dict``: a reference
  ``iter_40000.pth`` state_dict (keys ``module.model.*`` /``model.*``) into
  the port's FusionEncoderDecoder.
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn as nn

# one flax path segment -> its reference name (context-free: the JAX names
# below occur only where these rules apply)
_SEGMENT_RULES = (
    (re.compile(r"block_image(\d+)$"), lambda m: f"basic_block.{2 * int(m[1])}"),
    (re.compile(r"block_events(\d+)$"),
     lambda m: f"basic_block.{2 * int(m[1]) + 1}"),
    (re.compile(r"block(\d+)$"), lambda m: f"basic_block.{m[1]}"),
    (re.compile(r"mlp(\d+)$"), lambda m: f"linear_block.{m[1]}"),
    (re.compile(r"embed(\d+)$"), lambda m: f"embed_layers_image.{m[1]}.proj"),
    (re.compile(r"aspp(\d+)$"), lambda m: f"aspp_modules.{m[1]}"),
    (re.compile(r"sr_norm$"), lambda m: "norm"),
    (re.compile(r"fuse$"), lambda m: "fuse_layer_image"),
    (re.compile(r"depthwise$"), lambda m: "depthwise_conv"),
    (re.compile(r"pointwise$"), lambda m: "pointwise_conv"),
    (re.compile(r"(decoder_image|cls)$"), lambda m: None),   # flattened
)
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}
_STACKED = re.compile(r"blocks(\d+)$")


def _rename(seg: str):
    for pat, fn in _SEGMENT_RULES:
        m = pat.match(seg)
        if m:
            return fn(m)
    return seg


def _to_torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return arr
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))
    raise ValueError(f"unexpected kernel rank {arr.ndim}")


def _walk(tree, path):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, path + (str(k),))
        else:
            yield path + (str(k),), np.asarray(v)


def jax_to_state_dict(variables) -> dict[str, np.ndarray]:
    """JAX variable tree -> {reference state_dict key: numpy array}."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, arr in _walk(variables.get(coll, {}), ()):
            *mods, leaf = path
            stage = None
            names = []
            for seg in mods:
                m = _STACKED.match(seg)
                if m:
                    stage = len(names)
                    names.append(f"block{m[1]}")
                    continue
                new = _rename(seg)
                if new is not None:
                    names.append(new)
            if leaf not in _LEAF:
                raise KeyError(f"unmapped leaf {'/'.join(path)}")
            if stage is None:
                out[".".join(names + [_LEAF[leaf]])] = _to_torch_layout(leaf, arr)
                continue
            for i in range(arr.shape[0]):   # unstack a scanned stage
                key = names[:stage + 1] + [str(i)] + names[stage + 1:]
                out[".".join(key + [_LEAF[leaf]])] = _to_torch_layout(leaf, arr[i])
    return out


def _expected_keys(model: nn.Module) -> dict[str, torch.Tensor]:
    # BatchNorm's step counter has no JAX counterpart
    return {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def match_state_dict(model: nn.Module, sd: dict) -> dict[str, torch.Tensor]:
    """The module's state tensors by key, after checking that ``sd`` (from
    ``jax_to_state_dict``) has exactly these keys at these shapes."""
    want = _expected_keys(model)
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"JAX variables do not match the module: missing "
                       f"{missing[:8]}{'...' if len(missing) > 8 else ''}, "
                       f"left over {extra[:8]}"
                       f"{'...' if len(extra) > 8 else ''}")
    for k, t in want.items():
        if tuple(t.shape) != tuple(sd[k].shape):
            raise ValueError(f"shape mismatch at {k}: module "
                             f"{tuple(t.shape)} vs JAX {tuple(sd[k].shape)}")
    return want


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Fill ``model`` (a port module) from the JAX variables of its
    counterpart. Raises on a missing, left-over or mis-shaped entry."""
    sd = jax_to_state_dict(variables)
    for k, t in match_state_dict(model, sd).items():
        t.copy_(torch.from_numpy(np.ascontiguousarray(sd[k])).to(t.dtype))
    return model


def strip_prefix(sd: dict, prefixes=("module.", "model.")) -> dict:
    """Strip the reference checkpoint's wrapper prefixes, repeatedly (keys of
    a DACS run saved from MMDataParallel are ``module.model.*``). Keys of
    sibling models (``ema_model.*``, ``imnet_model.*``) match neither
    prefix and pass through unchanged."""
    out = {}
    for k, v in sd.items():
        changed = True
        while changed:
            changed = False
            for pre in prefixes:
                if k.startswith(pre):
                    k = k[len(pre):]
                    changed = True
                    break
        out[k] = v
    return out


@torch.no_grad()
def load_reference_state_dict(model: nn.Module, sd: dict) -> nn.Module:
    """Load a reference FusionEncoderDecoder state_dict (after
    ``strip_prefix``): the keys of the model's own children are taken, keys
    of sibling models are ignored, and a missing or mis-shaped key raises."""
    sd = strip_prefix(sd)
    roots = tuple(f"{name}." for name, _ in model.named_children())
    own = {k: v for k, v in sd.items() if k.startswith(roots)}
    result = model.load_state_dict(own, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"reference checkpoint does not match the model: "
                       f"missing {missing[:8]}, unexpected "
                       f"{result.unexpected_keys[:8]}")
    return model
