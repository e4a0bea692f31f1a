"""Single-image inference API (mirrors cmda_tpu.apis).

    from cmda_tpu_torch.apis import init_segmentor, inference_segmentor
    seg = init_segmentor("cs2dz")                    # on cuda, random weights
    seg = init_segmentor("cs2dz", "work_dirs/dz/iter_40000.pth",
                         use_teacher=True, overrides=["seed=1"])
    pred = inference_segmentor(seg, "night.png")     # [H, W] int32
    inference_segmentor(seg, "night.png", out_file="panel.png")

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU the default raises. The prediction comes from the stride-4 logits
through the fused upsample+argmax kernel, so the full-resolution logits are
never formed. For image-only input the second modality is the ISR of the
image, computed on the device by the batched ISR kernel with the config's
target ISR parameters.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import config as C
from .data.host_isr import normalize_image, open_rgb, pick_shift_direction
from .models.common import init_weights
from .models.segmentor import OUTPUT_KEYS, FusionEncoderDecoder
from .ops.fused_resize import (fused_resize_argmax, is_integer_factor,
                               resize_argmax)
from .ops.isr import SHIFT_DIRECTIONS, pil_grayscale
from .ops.isr_kernel import batched_isr
from .ops.resize import resize_bilinear


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: cmda_tpu_torch runs on the "
                           "GPU by default; pass device='cpu' to run on the "
                           "CPU")
    return dev


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def build_model(cfg: C.RunConfig, device="cuda", seed: int | None = None):
    """The config's FusionEncoderDecoder on ``device``, in eval mode, with
    the reference random init drawn from a generator seeded with ``seed``
    (default ``cfg.seed``)."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = FusionEncoderDecoder(cfg.model, dtype=cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed if seed is None else seed)
    init_weights(model, gen)
    return model.eval()


def select_logits(model: FusionEncoderDecoder, image, second, output: str):
    """The ``output`` stream's stride-4 logits (NHWC) for NHWC ``image`` and
    optional ``second`` modality, decoding only that stream; 'fusion'
    without a second modality, or of a model without a fusion module
    (``model.fusion=''``), falls back to the image stream, as in the JAX
    package."""
    if output == "fusion" and model.fusion_module is None:
        output = "image"
    if output == "image" or second is None:
        args, mode, output = (image, None, None), "no_fusion", "image"
    elif output == "isr":
        args, mode = (image, None, second), "no_fusion"
    else:
        args, mode = (image, second, None), "default"
    out = model.forward_logits(*args, mode=mode, resize_to_input=False,
                               streams=(output,))
    if out[OUTPUT_KEYS[output]] is None:
        return select_logits(model, image, None, "image")
    return out[OUTPUT_KEYS[output]]


def predict_labels(logits: torch.Tensor, size) -> torch.Tensor:
    """argmax of the bilinear upsample of stride-4 ``logits`` [B, h, w, C]
    to ``size``: the fused kernel for integer factors, the plain
    resize+argmax for any other geometry (a dispatch on shape, visible in
    ``fused_resize_argmax.launches``)."""
    if is_integer_factor(logits.shape, size):
        return fused_resize_argmax(logits.contiguous(), size,
                                   with_prob=False)[0]
    return resize_argmax(logits, size, with_prob=False)[0]


class Segmentor:
    """A weight-loaded model plus its output stream."""

    def __init__(self, cfg: C.RunConfig, model: FusionEncoderDecoder,
                 output: str = "fusion"):
        self.cfg = cfg
        self.model = model
        self.output = output

    @property
    def device(self) -> torch.device:
        return model_device(self.model)

    def _padded(self, x):
        """[H, W, C] array or tensor -> [1, H', W', C] on the device,
        reflect-padded to a multiple of 32."""
        t = torch.as_tensor(x, dtype=torch.float32, device=self.device)[None]
        h, w = t.shape[1:3]
        ph, pw = (-h) % 32, (-w) % 32
        if ph or pw:
            t = F.pad(t.permute(0, 3, 1, 2), (0, pw, 0, ph),
                      mode="reflect").permute(0, 2, 3, 1)
        return t

    def _stride4(self, image, second, output):
        """Padded input size and the selected stream's stride-4 logits."""
        img = self._padded(image)
        sec = self._padded(second) if second is not None else None
        return img.shape[1:3], select_logits(self.model, img, sec,
                                             output or self.output)

    @torch.no_grad()
    def predict(self, image, second=None, output: str | None = None):
        """Normalized [H, W, 3] image (+ optional second modality) -> pred
        [H, W] int32 tensor on the device."""
        h, w = image.shape[:2]
        size, logits = self._stride4(image, second, output)
        return predict_labels(logits, size)[0, :h, :w]

    @torch.no_grad()
    def __call__(self, image, second=None, output: str | None = None):
        """Normalized [H, W, 3] image (+ optional second modality) ->
        (logits [H, W, C], pred [H, W] int32) as numpy, like the JAX
        Segmentor: padded to a multiple of 32, cropped back."""
        h, w = image.shape[:2]
        size, logits = self._stride4(image, second, output)
        pred = predict_labels(logits, size)[0, :h, :w]
        full = resize_bilinear(logits, size)[0, :h, :w]
        return full.cpu().numpy(), pred.cpu().numpy()


def load_weights(model: FusionEncoderDecoder, checkpoint: str,
                 use_teacher: bool = False) -> FusionEncoderDecoder:
    """Fill ``model`` from ``checkpoint``: the port's own ``iter_<n>.pth``
    (``train/loop.py::save_checkpoint``: the student in ``state_dict``, the
    EMA teacher in ``ema_state_dict``), or a reference ``iter_40000.pth``
    (mmseg keys, its student taken). ``use_teacher`` takes the port
    checkpoint's EMA parameters with the student's BatchNorm statistics, as
    the JAX package evaluates the teacher; a reference checkpoint's teacher
    is its student, as in the JAX package (``cmda_tpu/apis.py:126``)."""
    from .utils.weights import load_reference_state_dict
    ckpt = torch.load(checkpoint, map_location="cpu", weights_only=False)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    if use_teacher and "ema_state_dict" in ckpt:
        params = {k for k, _ in model.named_parameters()}
        ema = ckpt["ema_state_dict"]
        sd = {k: (ema[k] if k in params else v) for k, v in sd.items()}
    return load_reference_state_dict(model, sd)


def init_segmentor(config="cs2dz", checkpoint: str | None = None,
                   device="cuda", output: str | None = None,
                   seed: int | None = None, use_teacher: bool = False,
                   overrides=()) -> Segmentor:
    """A Segmentor from a preset name (or RunConfig) with the dotted
    ``overrides`` (``KEY=VAL``, as the CLIs' ``--set``) applied: random
    weights from ``seed`` (default the config's), or the weights of
    ``checkpoint`` (``load_weights``; ``use_teacher`` for the EMA teacher).
    Default output stream: 'fusion' for cs2dsec, 'image' for cs2dz."""
    cfg = C.PRESETS[config]() if isinstance(config, str) else config
    cfg = C.apply_overrides(cfg, overrides)
    model = build_model(cfg, device, seed)
    if checkpoint:
        load_weights(model, checkpoint, use_teacher)
    if output is None:
        output = ("fusion" if cfg.model.train_type.startswith("cs2dsec")
                  else "image")
    return Segmentor(cfg, model, output=output)


def image_isr(segmentor: Segmentor, pil_image) -> torch.Tensor:
    """On-the-fly ISR of an RGB PIL image, on the device: PIL-exact
    grayscale, then the batched ISR kernel with the config's target ISR
    parameters and shift type -> [H, W, 3] float32."""
    d = segmentor.cfg.data
    p = d.target_isr
    rgb = torch.as_tensor(np.array(pil_image, np.uint8),
                          device=segmentor.device)
    gray = pil_grayscale(rgb).float()
    direction = pick_shift_direction(d.shift_type, 0, 0)
    # 'all' averages the four one-sided terms, which is the mean of the
    # leftdown and rightup results
    dirs = ([SHIFT_DIRECTIONS.index("leftdown"), SHIFT_DIRECTIONS.index("rightup")]
            if direction == "all" else [SHIFT_DIRECTIONS.index(direction)])
    isr = batched_isr(
        gray[None].expand(len(dirs), -1, -1).contiguous(),
        torch.tensor(dirs, dtype=torch.int32, device=segmentor.device),
        val_range=tuple(p.val_range), threshold=p.threshold,
        clip_range=p.clip_range, shift_pixel=p.shift_pixel).mean(dim=0)
    return isr[..., None].expand(-1, -1, 3)


def inference_segmentor(segmentor: Segmentor, image, second=None,
                        out_file: str | None = None,
                        opacity: float | None = None):
    """Segment one image file (or pre-normalized [H, W, 3] array) -> the
    [H, W] int32 prediction as numpy. Without ``second``, a stream that
    needs a second modality gets the image's ISR (``image_isr``). With
    ``out_file`` the image|second|pred panel is written there (the pred
    blended at ``opacity``)."""
    if isinstance(image, str):
        pil = open_rgb(image)
        arr = normalize_image(pil)
        if second is None and segmentor.output != "image":
            second = image_isr(segmentor, pil)
    else:
        arr = np.asarray(image, np.float32)
    pred = segmentor.predict(arr, second).cpu().numpy()
    if out_file:
        from .utils.visualization import show_result
        show_result(arr, pred, out_path=out_file, opacity=opacity,
                    events=(None if second is None
                            else torch.as_tensor(second).cpu().numpy()))
    return pred
