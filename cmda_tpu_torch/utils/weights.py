"""Carry weights into the port's modules.

* ``load_jax_variables``: a JAX package variable tree ({'params',
  'batch_stats'} as numpy arrays, e.g. from ``FusionEncoderDecoder.init``
  or ``EncoderDecoder.init``) -> the port's module of the same kind. It renames flax paths to the
  reference mmseg state_dict keys, unstacks the scanned MiT stages
  (``blocks{s}`` -> ``block{s}.{i}``) and transposes kernels:
      Dense       [in, out]       -> Linear weight [out, in]
      Conv        [kh, kw, in, out] -> Conv2d weight [out, in, kh, kw]
      Depthwise   [k, k, 1, C]    -> Conv2d weight [C, 1, k, k]
  Every model key must be filled and every tree leaf used, at the right
  shape; anything else raises. The model zoo's modules map the same way:
  a ResNet's flax ``stem{j}`` / ``layer{s}_{i}`` / ``conv{k}`` /
  ``downsample`` ConvBNReLUs become mmcv's V1c keys (``stem.{3j}`` conv and
  ``stem.{3j+1}`` BN, ``layer{s}.{i}.conv{k}`` / ``bn{k}``,
  ``downsample.{0,1}``), a BasicBlock's ``conv{k}`` the same ``conv{k}`` /
  ``bn{k}``, a GenericEncoderDecoder's ``head`` ``decode_head``, the
  unshared decoders ``embed_layers_{events,fusion}`` and
  ``fuse_layer_{events,fusion}``; a scalar parameter (DAHead's
  ``pam_gamma``) keeps its name.
* ``cyclegan_to_state_dict`` / ``discriminator_to_state_dict`` and their
  inverses: the JAX CycleGAN generator's and discriminators' flax trees
  (``conv_in`` .. ``conv_out``; ``conv0`` .. ``conv_out``) <-> the reference
  pix2pix ``nn.Sequential`` keys, HWIO <-> OIHW.
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
    (re.compile(r"fuse_rawconv$"), lambda m: "fuse_rawconv_image"),
    (re.compile(r"layer(\d)_(\d+)$"), lambda m: f"layer{m[1]}.{m[2]}"),
    (re.compile(r"depthwise$"), lambda m: "depthwise_conv"),
    (re.compile(r"pointwise$"), lambda m: "pointwise_conv"),
    (re.compile(r"(decoder_image|cls)$"), lambda m: None),   # flattened
)
# whole-key rewrites after the segments are renamed: the single-stream
# head's ``decoder`` (the reference DAFormerHead's unsuffixed names) and
# the split classifiers (``conv_seg_events`` / ``conv_seg_fusion``)
_KEY_RULES = (
    (re.compile(r"(^|\.)decoder\.(embed_layers|fuse_layer|fuse_rawconv)"
                r"_image\."), r"\1\2."),
    (re.compile(r"(^|\.)decoder_(events|fusion)\."
                r"(embed_layers|fuse_layer|fuse_rawconv)_image\."),
     r"\1\3_\2."),
    (re.compile(r"(^|\.)cls_(events|fusion)\.conv_seg\."), r"\1conv_seg_\2."),
    # a GenericEncoderDecoder's head: SegFormerHead's unsuffixed names, and
    # the reference's ``decode_head``
    (re.compile(r"^head\.(embed_layers|fuse_layer)_image\."), r"head.\1."),
    (re.compile(r"^head\."), "decode_head."),
)
# two flax segments -> one reference name: a ConvBNReLU's ``conv`` / ``bn``
# under a ResNet stem conv, a numbered conv or a shortcut
_PAIR_RULES = (
    (re.compile(r"stem(\d)$"), {"conv": lambda m: f"stem.{3 * int(m[1])}",
                                "bn": lambda m: f"stem.{3 * int(m[1]) + 1}"}),
    (re.compile(r"conv(\d+)$"), {"conv": lambda m: f"conv{m[1]}",
                                 "bn": lambda m: f"bn{m[1]}"}),
    (re.compile(r"downsample$"), {"conv": lambda m: "downsample.0",
                                  "bn": lambda m: "downsample.1"}),
)
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}
_STACKED = re.compile(r"blocks(\d+)$")


def _pair(seg: str, nxt: str | None):
    for pat, by_next in _PAIR_RULES:
        m = pat.match(seg)
        if m and nxt in by_next:
            return by_next[nxt](m)
    return None


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


def _to_jax_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    """The inverse of ``_to_torch_layout``."""
    if leaf != "kernel":
        return arr
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return np.transpose(arr, (2, 3, 1, 0))
    raise ValueError(f"unexpected kernel rank {arr.ndim}")


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _walk(v, path + (str(k),))
        else:
            yield path + (str(k),), np.asarray(v)


def _torch_keys(path: tuple, depth: int) -> list[str]:
    """The reference state_dict keys of the flax leaf at ``path``: one key,
    or, under a scanned stage (``blocks{s}``), one per block of the
    leading axis of length ``depth``."""
    *mods, leaf = path
    stage = None
    names = []
    i = 0
    while i < len(mods):
        seg = mods[i]
        m = _STACKED.match(seg)
        if m:
            stage = len(names)
            names.append(f"block{m[1]}")
            i += 1
            continue
        pair = _pair(seg, mods[i + 1] if i + 1 < len(mods) else None)
        if pair is not None:
            names.append(pair)
            i += 2
            continue
        new = _rename(seg)
        if new is not None:
            names.append(new)
        i += 1
    if leaf.endswith("_gamma"):      # a scalar parameter of its module
        last = leaf
    elif leaf in _LEAF:
        last = _LEAF[leaf]
    else:
        raise KeyError(f"unmapped leaf {'/'.join(path)}")
    if stage is None:
        return [_rewrite(".".join(names + [last]))]
    return [_rewrite(".".join(names[:stage + 1] + [str(i)]
                              + names[stage + 1:] + [last]))
            for i in range(depth)]


def _rewrite(key: str) -> str:
    for pat, repl in _KEY_RULES:
        key = pat.sub(repl, key)
    return key


def _is_stacked(path: tuple) -> bool:
    return any(_STACKED.match(seg) for seg in path[:-1])


def tree_to_state_dict(tree) -> dict[str, np.ndarray]:
    """One flax collection tree -> {reference key: numpy array}, scanned
    stages unstacked and kernels in torch layout."""
    out = {}
    for path, arr in _walk(tree):
        keys = _torch_keys(path, arr.shape[0] if _is_stacked(path) else 1)
        if not _is_stacked(path):
            out[keys[0]] = _to_torch_layout(path[-1], arr)
            continue
        for i, key in enumerate(keys):   # unstack a scanned stage
            out[key] = _to_torch_layout(path[-1], arr[i])
    return out


def state_dict_to_tree(sd: dict, layout) -> dict:
    """The inverse of ``tree_to_state_dict``: a nested dict shaped like the
    flax tree ``layout`` (numpy leaves; only the paths and stage depths are
    read) with each leaf taken from ``sd`` (tensors or arrays) in JAX
    layout. Raises on a key of the layout that ``sd`` lacks."""
    out = {}
    for path, arr in _walk(layout):
        stacked = _is_stacked(path)
        keys = _torch_keys(path, arr.shape[0] if stacked else 1)
        missing = [k for k in keys if k not in sd]
        if missing:
            raise KeyError(f"no {missing[:4]} for {'/'.join(path)}")
        vals = [_to_jax_layout(path[-1], _numpy(sd[k])) for k in keys]
        node = out
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = np.stack(vals) if stacked else vals[0]
    return out


def _numpy(t) -> np.ndarray:
    """A copy, never a view: a CPU tensor's ``.numpy()`` shares its memory,
    and the optimizer and BN update parameters and buffers in place. A
    bfloat16 tensor (bfloat16 AdamW moments) comes out as the float32
    array of its values, which holds them exactly."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    return np.array(t)


def _moment_tensor(arr, like: torch.Tensor, dtype: torch.dtype):
    """A new tensor of an AdamW moment in ``dtype`` on ``like``'s device
    from a numpy array, a bfloat16 one (``ml_dtypes``, as JAX hands them
    out) included: a copy, never a view of the caller's array, since AdamW
    updates its moments in place."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)   # exact
    return torch.tensor(arr, device=like.device).to(dtype)


def jax_to_state_dict(variables) -> dict[str, np.ndarray]:
    """JAX variable tree -> {reference state_dict key: numpy array}."""
    out = {}
    for coll in ("params", "batch_stats"):
        out.update(tree_to_state_dict(variables.get(coll, {})))
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
        t.copy_(torch.from_numpy(np.array(sd[k])).to(t.dtype))
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


def load_torch_file(path: str) -> dict:
    """A state_dict saved with ``torch.save``, on the CPU; an mmcv-style
    ``{'state_dict': ...}`` wrapper is unwrapped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("state_dict", ckpt)


@torch.no_grad()
def load_pretrained_backbone(backbone: nn.Module, sd: dict) -> nn.Module:
    """An NVlabs ``mit_bX.pth`` state_dict into a MixVisionTransformer, or
    an mmcv ``resnet*_v1c`` one into a ResNetV1c: its keys are the
    backbone's own; the ImageNet classifier (``head.*``, ``fc.*``) and any
    other extra key are left out, BatchNorm's step counter may be missing,
    any other missing or mis-shaped key raises."""
    own = [k for k in backbone.state_dict()
           if not k.endswith("num_batches_tracked")]
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"pretrained backbone lacks {missing[:8]}")
    backbone.load_state_dict({k: sd[k] for k in own}, strict=False)
    return backbone


# ---------------------------------------------------------------------------
# the DACS training state
# ---------------------------------------------------------------------------
# A training state in the JAX tree's key layout, as numpy ("the JAX
# layout" below):
#   {"step": int,
#    "params", "batch_stats", "ema_params": flax trees (scanned stages
#        stacked, flax kernel layouts),
#    "opt": {"head" | "backbone": {"count": int, "mu": tree, "nu": tree}}
#        (the optax multi_transform AdamW moments of each group, the
#        group's own leaves only, and its bias-correction count; float32,
#        or bfloat16 with optim.moment_dtype='bfloat16', which
#        ``train_state_to_numpy`` hands out as their exact float32 values;
#        optim.grad_clip's chain level holds no state),
#    "cyclegan_params": the ResnetGenerator's flax tree, or None,
#    "imnet_params" (optional): the frozen ImageNet EncoderDecoder's params
#        tree, or None}

def _cyclegan_keys(n_blocks: int) -> dict[tuple, str]:
    """flax path (module, leaf) of the JAX ResnetGenerator -> reference
    key prefix of its ``nn.Sequential``."""
    idx = {("conv_in",): 1, ("down0",): 4, ("down1",): 7}
    for i in range(n_blocks):
        idx[(f"resblock{i}", "conv1")] = f"{10 + i}.conv_block.1"
        idx[(f"resblock{i}", "conv2")] = f"{10 + i}.conv_block.5"
    idx[("up0",)] = 10 + n_blocks
    idx[("up1",)] = 10 + n_blocks + 3
    idx[("conv_out",)] = 10 + n_blocks + 7
    return {k: f"model.{v}" for k, v in idx.items()}


def cyclegan_to_state_dict(params) -> dict[str, np.ndarray]:
    """JAX ResnetGenerator params -> its reference state_dict."""
    n_blocks = sum(1 for k in params if str(k).startswith("resblock"))
    keys = _cyclegan_keys(n_blocks)
    out = {}
    for path, arr in _walk(params):
        out[f"{keys[path[:-1]]}.{_LEAF[path[-1]]}"] = _to_torch_layout(
            path[-1], arr)
    if len(out) != 2 * len(keys):
        raise KeyError(f"CycleGAN params: {len(out)} leaves for "
                       f"{len(keys)} convs")
    return out


def cyclegan_to_tree(sd: dict) -> dict:
    """The inverse of ``cyclegan_to_state_dict``."""
    n_blocks = sum(1 for k in sd if k.endswith("conv_block.1.weight"))
    out = {}
    for path, prefix in _cyclegan_keys(n_blocks).items():
        node = out
        for seg in path:
            node = node.setdefault(seg, {})
        node["kernel"] = _to_jax_layout("kernel", _numpy(sd[f"{prefix}.weight"]))
        node["bias"] = _numpy(sd[f"{prefix}.bias"])
    return out


def _discriminator_keys(n_convs: int, pixel: bool) -> dict[tuple, str]:
    """flax module of the JAX NLayerDiscriminator (``conv0`` ..
    ``conv{n_convs - 2}``, ``conv_out``) or PixelDiscriminator (``conv0``,
    ``conv1``, ``conv_out``) -> reference key prefix: ``model.{0, 2, 5,
    ...}`` or ``net.{0, 2, 5}``."""
    if pixel:
        return {("conv0",): "net.0", ("conv1",): "net.2",
                ("conv_out",): "net.5"}
    out = {(f"conv{i}",): f"model.{0 if i == 0 else 3 * i - 1}"
           for i in range(n_convs - 1)}
    out[("conv_out",)] = f"model.{3 * (n_convs - 1) - 1}"
    return out


def discriminator_to_state_dict(params) -> dict[str, np.ndarray]:
    """JAX NLayerDiscriminator / PixelDiscriminator params -> the reference
    state_dict (kernels HWIO -> OIHW); the pixel one is told by its 1x1
    kernels."""
    pixel = np.shape(params["conv0"]["kernel"])[0] == 1
    keys = _discriminator_keys(len(params), pixel)
    out = {}
    for path, arr in _walk(params):
        out[f"{keys[path[:-1]]}.{_LEAF[path[-1]]}"] = _to_torch_layout(
            path[-1], arr)
    return out


def discriminator_to_tree(sd: dict) -> dict:
    """The inverse of ``discriminator_to_state_dict``."""
    pixel = any(k.startswith("net.") for k in sd)
    n_convs = sum(1 for k in sd if k.endswith(".weight"))
    out = {}
    for (name,), prefix in _discriminator_keys(n_convs, pixel).items():
        out[name] = {
            "kernel": _to_jax_layout("kernel", _numpy(sd[f"{prefix}.weight"])),
            "bias": _numpy(sd[f"{prefix}.bias"])}
    return out


def _params_by_key(model: nn.Module) -> dict[str, torch.Tensor]:
    return dict(model.named_parameters())


def _groups_by_part(optimizer) -> dict[str, list]:
    parts = {}
    for group in optimizer.param_groups:
        parts.setdefault(group["part"], []).extend(group["params"])
    return parts


@torch.no_grad()
def load_jax_train_state(state, jax_state: dict):
    """Fill a ``DACSTrainState`` from a training state in the JAX layout:
    params, running BN statistics, the EMA params, the AdamW moments and
    counts of both groups, the step, the CycleGAN and the frozen ImageNet
    encoder's backbone (the part its feature distance reads; the JAX
    ``imnet_params`` hold no BatchNorm statistics for its head), or the
    whole encoder where ``imnet_params`` is a variables dict ({'params',
    'batch_stats'}: a legacy twin with BatchNorm). Raises on
    any key left over or missing, or a parameter whose optimizer group
    differs."""
    load_jax_variables(state.model, {"params": jax_state["params"],
                                     "batch_stats": jax_state["batch_stats"]})
    ema_sd = tree_to_state_dict(jax_state["ema_params"])
    ema = _params_by_key(state.ema_model)
    if set(ema_sd) != set(ema):
        raise KeyError(f"EMA params do not match: missing "
                       f"{sorted(set(ema) - set(ema_sd))[:8]}, left over "
                       f"{sorted(set(ema_sd) - set(ema))[:8]}")
    for k, t in ema.items():
        t.copy_(torch.from_numpy(np.ascontiguousarray(ema_sd[k])))
    params = _params_by_key(state.model)
    parts = {part: {id(p) for p in ps}
             for part, ps in _groups_by_part(state.optimizer).items()}
    # bfloat16 with LowPrecisionAdamW, the parameter's dtype with AdamW
    moment_dtype = getattr(state.optimizer, "moment_dtype", None)
    seen = set()
    for part, opt in jax_state["opt"].items():
        mu, nu = tree_to_state_dict(opt["mu"]), tree_to_state_dict(opt["nu"])
        if set(mu) != set(nu):
            raise KeyError(f"AdamW {part}: mu and nu keys differ")
        for k in mu:
            p = params[k]
            if id(p) not in parts[part]:
                raise KeyError(f"{k} is not in the {part!r} group")
            state.optimizer.state[p] = {
                "step": torch.tensor(float(opt["count"]), dtype=torch.float32),
                "exp_avg": _moment_tensor(mu[k], p, moment_dtype or p.dtype),
                "exp_avg_sq": _moment_tensor(nu[k], p,
                                             moment_dtype or p.dtype)}
            seen.add(k)
    if seen != set(params):
        raise KeyError(f"AdamW moments missing for "
                       f"{sorted(set(params) - seen)[:8]}")
    state.step = int(jax_state["step"])
    if state.cyclegan is not None:
        sd = cyclegan_to_state_dict(jax_state["cyclegan_params"])
        state.cyclegan.load_state_dict({k: torch.from_numpy(
            np.ascontiguousarray(v)) for k, v in sd.items()})
    imnet = jax_state.get("imnet_params")
    if state.imnet is not None and imnet is not None:
        if "params" in imnet:   # a whole variables dict (a BN-bearing twin)
            load_jax_variables(state.imnet, imnet)
        else:
            load_jax_variables(state.imnet.backbone,
                               {"params": imnet["backbone"]})
    return state


def train_state_to_numpy(state, layout: dict) -> dict:
    """A ``DACSTrainState`` in the JAX layout. ``layout`` holds the flax
    'params' and 'batch_stats' trees (numpy, e.g. the JAX state's) that fix
    the key layout; only paths and stage depths are read."""
    model_sd = {k: v for k, v in state.model.state_dict().items()
                if not k.endswith("num_batches_tracked")}
    opt = {}
    params = _params_by_key(state.model)
    for part, ps in _groups_by_part(state.optimizer).items():
        ids = {id(p) for p in ps}
        mine = {k: p for k, p in params.items() if id(p) in ids}
        st = [state.optimizer.state.get(p, {}) for p in mine.values()]
        counts = {float(s["step"]) for s in st if "step" in s} or {0.0}
        if len(counts) != 1:
            raise ValueError(f"AdamW {part}: parameters at different steps "
                             f"{sorted(counts)}")
        sub = _subtree(layout["params"], mine)
        zeros = {k: torch.zeros_like(p) for k, p in mine.items()}
        opt[part] = {
            "count": int(counts.pop()),
            "mu": state_dict_to_tree({k: state.optimizer.state.get(
                p, {}).get("exp_avg", zeros[k]) for k, p in mine.items()}, sub),
            "nu": state_dict_to_tree({k: state.optimizer.state.get(
                p, {}).get("exp_avg_sq", zeros[k]) for k, p in mine.items()},
                sub)}
    return {
        "step": state.step,
        "params": state_dict_to_tree(model_sd, layout["params"]),
        "batch_stats": state_dict_to_tree(model_sd, layout["batch_stats"]),
        "ema_params": state_dict_to_tree(dict(state.ema_model.named_parameters()),
                                         layout["params"]),
        "opt": opt,
        "cyclegan_params": (cyclegan_to_tree(state.cyclegan.state_dict())
                            if state.cyclegan is not None else None)}


def _subtree(layout, keys) -> dict:
    """The leaves of ``layout`` whose reference keys are all in ``keys``
    (a scanned stage's leaf belongs to one group as a whole)."""
    out = {}
    for path, arr in _walk(layout):
        ks = _torch_keys(path, arr.shape[0] if _is_stacked(path) else 1)
        if all(k in keys for k in ks):
            node = out
            for seg in path[:-1]:
                node = node.setdefault(seg, {})
            node[path[-1]] = arr
    return out
