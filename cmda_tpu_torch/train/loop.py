"""The DACS training run: periodic whole-frame evaluation, JSON-lines logs,
``class_mix_debug`` grids and torch checkpoints around
``DACSTrainer.train_step`` (mirrors cmda_tpu.train.loop on one device;
reference mmseg/apis/train.py:39-131 and its hooks).

* ``evaluate_fusion``: whole-image, sliding-window or multi-scale+flip
  inference of the student or the EMA teacher over a test dataset ->
  mIoU, with optional prediction panels in ``show_dir``.
* ``save_checkpoint`` / ``load_checkpoint``: one ``iter_<n>.pth`` holding
  the student in reference mmseg keys (``state_dict``, what
  ``apis.init_segmentor(checkpoint=...)`` reads), the teacher
  (``ema_state_dict``), AdamW (``optimizer``), ``step`` and ``meta``, and
  with the feature distance the frozen ImageNet encoder
  (``imnet_state_dict``);
  written to a temporary name and renamed, so a cut run never leaves a
  partial checkpoint.
* ``TrainLoop.run``: per iteration the debug snapshot (before the step, on
  its draws), the step, the log record (the step's logs, the backbone's
  ``lr`` and, with the events/ISR coin, ``random_choice_thres``), the
  checkpoint and the evaluation, in that order. The batches reach the step through the loader's worker
  threads, the bf16 wire encoding (``data.wire_bf16``) and the pinned,
  asynchronous device feed (``data.device_prefetch`` batches ahead). The
  logs are fetched in one device-to-host copy per logged iteration.

Evaluation is an observer that may raise: a failure in it ends the run (the
JAX loop logs it, sleeps and retries up to three times).
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import platform
import re
import shutil
import tarfile
import time

import numpy as np
import torch

from ..apis import Segmentor, model_device, predict_labels, select_logits
from ..config import RunConfig
from ..data.loader import (PrefetchLoader, collate, device_prefetch,
                           host_tensor)
from ..data.wire import encode_wire
from ..models.segmentor import multi_scale_flip_inference, slide_inference
from ..ops.metrics import eval_metrics, intersect_and_union, summarize_miou
from ..ops.resize import resize_bilinear
from ..uda.dacs import DACSTrainer, DACSTrainState
from ..utils.visualization import (CITYSCAPES_PALETTE, colorize_label,
                                   denorm_to_uint8, grid_panel,
                                   show_result, signed_to_uint8)

CLASS_NAMES = ("road", "sidewalk", "building", "wall", "fence", "pole",
               "traffic light", "traffic sign", "vegetation", "terrain",
               "sky", "person", "rider", "car", "truck", "bus", "train",
               "motorcycle", "bicycle")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# the reference's aug_test scales (tools/test.py:118-123), each also flipped
TTA_SCALES = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)


def teacher_model(state: DACSTrainState):
    """The EMA teacher as evaluation runs it: the EMA parameters with the
    student's BatchNorm statistics, as the JAX package evaluates
    ``{"params": ema_params, "batch_stats": batch_stats}``. (The port's
    teacher module keeps BN buffers of its own, which never move: the EMA
    update touches parameters only.) A module that shares the tensors of
    both and copies none."""
    memo = {id(p): p for p in state.ema_model.parameters()}
    student = dict(state.model.named_buffers())
    for name, buf in state.ema_model.named_buffers():
        memo[id(buf)] = student[name]
    return copy.deepcopy(state.ema_model, memo)


@torch.no_grad()
def evaluate_fusion(model, dataset, *, output: str = "fusion",
                    use_teacher: bool = False, num_classes: int = 19,
                    max_samples: int | None = None, batch_size: int = 1,
                    show_dir: str | None = None, inference: str = "whole",
                    slide_crop: tuple[int, int] = (512, 512),
                    slide_stride: tuple[int, int] = (341, 341),
                    slide_crop_chunk: int | None = None,
                    aug_test: bool = False,
                    opacity: float | None = None) -> dict:
    """Inference over a test dataset -> mIoU summary.

    ``model`` is the port's FusionEncoderDecoder, a Segmentor, or a
    DACSTrainState (the student, or with ``use_teacher`` the EMA teacher on
    the student's BN statistics, ``teacher_model``). Each prediction is the
    argmax of the ``output`` stream's logits at the input size
    (``select_logits``; a dataset without a second modality gives the image
    stream):
    * ``inference='whole'``: through the fused upsample+argmax kernel
      (``apis.predict_labels``);
    * ``'slide'``: the reference's overlapping crops over both modalities
      (``slide_inference``, ``slide_crop`` / ``slide_stride`` /
      ``slide_crop_chunk``), whole mode for an image-only dataset;
    * ``aug_test``: the softmax averaged over TTA_SCALES and their flips
      (``multi_scale_flip_inference``), in whole mode only.
    19-class histograms, and the 18-class summary with the x19/18 rule.
    With ``show_dir`` each sample's image|second|pred|GT panel (the pred
    blended at ``opacity``) is written there as ``{index:06d}.png``.
    Nothing of the model changes (eval-mode BN, no draws)."""
    if aug_test and inference == "slide":
        raise ValueError("aug_test applies to whole-image inference only")
    if inference not in ("whole", "slide"):
        raise ValueError(f"unknown inference mode {inference!r}")
    if isinstance(model, DACSTrainState):
        model = teacher_model(model) if use_teacher else model.model
    elif use_teacher:
        raise ValueError("use_teacher needs the DACSTrainState that holds "
                         "the EMA teacher")
    if isinstance(model, Segmentor):
        model = model.model
    dev = model_device(model)

    def full_logits(x):
        """The stream's logits at x's size; x is the RGB image with the
        second modality (if any) after it on the channel axis."""
        second = x[..., 3:] if x.shape[-1] > 3 else None
        return resize_bilinear(select_logits(model, x[..., :3], second,
                                             output), x.shape[1:3])

    totals = [np.zeros(num_classes, np.float64) for _ in range(4)]
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for start in range(0, n, batch_size):
        samples = [dataset[i] for i in range(start, min(start + batch_size, n))]
        batch = collate(samples)
        image = host_tensor(batch["image"]).to(dev, torch.float32)
        second = batch.get("events", batch.get("isr"))
        if second is not None:
            second = host_tensor(second).to(dev, torch.float32)
        both = image if second is None else torch.cat([image, second], -1)
        if inference == "slide" and second is not None:
            pred = slide_inference(
                full_logits, both, crop_size=tuple(slide_crop),
                stride=tuple(slide_stride), num_classes=num_classes,
                crop_chunk=slide_crop_chunk).argmax(dim=-1)
        elif aug_test:
            pred = multi_scale_flip_inference(
                full_logits, both, scales=TTA_SCALES,
                flip=True).argmax(dim=-1)
        else:
            pred = predict_labels(select_logits(model, image, second, output),
                                  image.shape[1:3])
        pred = pred.cpu().numpy()
        for j, s in enumerate(samples):
            res = intersect_and_union(pred[j], s["label"], num_classes)
            for k in range(4):
                totals[k] += res[k]
            if show_dir is not None:
                show_result(s["image"], pred[j], gt=s.get("label"),
                            events=s.get("events", s.get("isr")),
                            out_path=os.path.join(show_dir,
                                                  f"{start + j:06d}.png"),
                            opacity=opacity)
    ret = eval_metrics(*totals)
    summary = summarize_miou(ret, valid_classes=18)
    summary["per_class_iou"] = {
        CLASS_NAMES[i]: float(ret["IoU"][i]) for i in range(num_classes)}
    return summary


def collect_env() -> dict:
    """Python, platform, torch and CUDA versions and the CUDA devices."""
    cuda = torch.cuda.is_available()
    return {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())]
                    if cuda else []),
    }


def snapshot_code(work_dir: str) -> str:
    """``code.tar.gz`` of the port's package, its tests and
    ``chip_smoke.py`` in ``work_dir`` (reference tools/train.py:111)."""
    out = os.path.join(work_dir, "code.tar.gz")

    def no_cache(info):
        return None if "__pycache__" in info.name.split("/") else info
    with tarfile.open(out, "w:gz") as tar:
        for sub in ("cmda_tpu_torch", "tests", "chip_smoke.py"):
            path = os.path.join(REPO_ROOT, sub)
            if os.path.exists(path):
                tar.add(path, arcname=sub, filter=no_cache)
    return out


def save_checkpoint(state: DACSTrainState, path: str,
                    meta: dict | None = None):
    """Write ``state`` to ``path`` (a ``.tmp`` file renamed into place)."""
    ckpt = {"state_dict": state.model.state_dict(),
            "ema_state_dict": state.ema_model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step, "meta": meta}
    if state.imnet is not None:
        ckpt["imnet_state_dict"] = state.imnet.state_dict()
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def load_checkpoint(state: DACSTrainState, path: str) -> DACSTrainState:
    """Fill ``state`` (from ``DACSTrainer.init_state``) from a checkpoint
    of ``save_checkpoint``: student, teacher, AdamW, step and the frozen
    ImageNet encoder where both have one. Read on the
    CPU: ``load_state_dict`` moves each tensor to where its counterpart
    lives, and AdamW's step counts stay on the CPU, as in a run that was
    never cut (on the device, each would cost a synchronisation per
    parameter and step)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["state_dict"])
    state.ema_model.load_state_dict(ckpt["ema_state_dict"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.imnet is not None and "imnet_state_dict" in ckpt:
        state.imnet.load_state_dict(ckpt["imnet_state_dict"])
    state.step = int(ckpt["step"])
    return state


class TrainLoop:
    """The single-device DACS run of ``cfg`` on ``device`` (cuda unless the
    caller asks for the CPU), logging to ``<work_dir>/<time>.log.json``.
    ``run`` starts the loader's worker threads and stops them when it
    returns or raises."""

    def __init__(self, cfg: RunConfig, *, dataset, val_dataset=None,
                 work_dir: str | None = None, num_workers: int | None = None,
                 device="cuda"):
        self.cfg = cfg
        self.trainer = DACSTrainer(cfg, device)
        self.dataset = dataset
        self.val_dataset = val_dataset
        ts = time.strftime("%Y%m%d_%H%M%S")
        self.work_dir = work_dir or os.path.join(cfg.work_dir,
                                                 f"{ts}_{cfg.name}")
        os.makedirs(self.work_dir, exist_ok=True)
        self.log_path = os.path.join(self.work_dir, f"{ts}.log.json")
        self.num_workers = num_workers or cfg.data.workers
        self.state = None

    def log(self, record: dict):
        with open(self.log_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def _dump_debug_grids(self, it: int, dbg: dict):
        """class_mix_debug grids (reference dacs.py:882-1097): per batch
        sample (at most 2) one PNG of the source, target and mixed images,
        their labels, second modality (the events, or the ISR where the
        train type has no events), and the mix mask and pixel weights."""
        from PIL import Image
        out_dir = os.path.join(self.work_dir, "class_mix_debug")
        os.makedirs(out_dir, exist_ok=True)

        def gray(x):  # [H, W] float in [0, 1] -> rgb uint8
            u8 = np.clip(x * 255.0, 0, 255).astype(np.uint8)
            return np.repeat(u8[..., None], 3, -1)

        second = "night_events" if "night_events" in dbg else "night_isr"
        mixed2 = "mixed_events" if "mixed_events" in dbg else "mixed_isr"
        for i in range(min(dbg["day_image"].shape[0], 2)):
            rows = [
                [denorm_to_uint8(dbg["day_image"][i]),
                 denorm_to_uint8(dbg["night_image"][i]),
                 denorm_to_uint8(dbg["mixed_img"][i])],
                [colorize_label(dbg["day_label"][i]),
                 colorize_label(dbg["pseudo_label"][i]),
                 colorize_label(dbg["mixed_lbl"][i])],
                [signed_to_uint8(dbg["day_isr"][i][..., 0]),
                 signed_to_uint8(dbg[second][i][..., 0]),
                 signed_to_uint8(dbg[mixed2][i][..., 0])],
                [gray(dbg["masks"][i].astype(np.float32)),
                 gray(dbg["pseudo_weight"][i]),
                 gray(dbg["mixed_weight"][i])],
            ]
            Image.fromarray(grid_panel(rows)).save(
                os.path.join(out_dir, f"{it + 1:06d}_{i}.png"))

    def _evaluate(self, it: int, state: DACSTrainState):
        """Evaluate the student; panels land in ``test_results_<iter>``,
        which is then renamed with the score (reference
        eval_hooks.py:43-60)."""
        eval_dir = os.path.join(self.work_dir, f"test_results_{it + 1}")
        summary = evaluate_fusion(state.model, self.val_dataset,
                                  num_classes=self.cfg.data.num_classes,
                                  show_dir=eval_dir)
        self.log({"iter": it + 1, "eval": summary})
        scored = f"{eval_dir}_{summary['mIoU'] * 100:.2f}"
        if os.path.isdir(eval_dir):
            # a resumed run may replay an evaluation: the newer one wins
            if os.path.isdir(scored):
                shutil.rmtree(scored)
            os.rename(eval_dir, scored)
        else:
            os.makedirs(scored, exist_ok=True)

    def run(self, max_iters: int | None = None,
            state: DACSTrainState | None = None) -> DACSTrainState:
        """Train from ``state`` (default: ``init_state`` from the config's
        seed) up to ``max_iters`` (default ``optim.max_iters``); returns the
        final state, also kept as ``self.state``."""
        cfg = self.cfg
        max_iters = max_iters or cfg.optim.max_iters
        loader = PrefetchLoader(self.dataset, cfg.data.batch_size,
                                num_workers=self.num_workers, seed=cfg.seed)
        try:
            snapshot_code(self.work_dir)
            self.log({"env": collect_env(), "config": cfg.name,
                      "max_iters": max_iters})
            if state is None:
                state = self.trainer.init_state(cfg.seed)
            host = loader
            if cfg.data.wire_bf16:
                host = (encode_wire(b) for b in loader)
            batches = device_prefetch(host, self.trainer.device,
                                      cfg.data.device_prefetch)
            t_last = time.perf_counter()
            for it in range(state.step, max_iters):
                t_data = time.perf_counter()
                batch = next(batches)
                data_time = time.perf_counter() - t_data
                if (cfg.debug_img_interval
                        and (it + 1) % cfg.debug_img_interval == 0):
                    dbg = self.trainer.debug_tensors(state, batch)
                    self._dump_debug_grids(it, {k: v.cpu().numpy()
                                                for k, v in dbg.items()})
                state, logs = self.trainer.train_step(state, batch)
                if (it + 1) % cfg.log_interval == 0 or it == 0:
                    keys = sorted(logs)
                    vals = torch.stack([logs[k].float() for k in keys]).cpu()
                    now = time.perf_counter()
                    rec = dict(zip(keys, vals.tolist()))
                    rec.update(self._schedule_values(state, it))
                    rec = dict(sorted(rec.items()))
                    rec.update(iter=it + 1,
                               time=(now - t_last) / cfg.log_interval,
                               data_time=data_time)
                    t_last = now
                    self.log(rec)
                if ((it + 1) % cfg.checkpoint_interval == 0
                        or (it + 1) == max_iters):
                    meta = {"classes": CLASS_NAMES,
                            "palette": CITYSCAPES_PALETTE.tolist(),
                            "config": dataclasses.asdict(cfg),
                            "iter": it + 1}
                    save_checkpoint(state, os.path.join(
                        self.work_dir, f"iter_{it + 1}.pth"), meta=meta)
                    self._prune_checkpoints(cfg.checkpoint_max_keep)
                if (self.val_dataset is not None
                        and (it + 1) % cfg.eval_interval == 0):
                    self._evaluate(it, state)
            batches.close()
        finally:
            loader.close()
        self.state = state
        return state

    def _schedule_values(self, state: DACSTrainState, it: int) -> dict:
        """The schedules' values at iteration ``it`` (0-based): the
        backbone's ``lr`` (the head's is ``optim.head_lr_mult`` times it)
        and, where the step draws the events/ISR coin, its
        ``random_choice_thres``. A segmented run's log shows by them that
        its horizon is the whole run's."""
        out = {"lr": state.schedules["backbone"](it)}
        if self.trainer.has_events:
            out["random_choice_thres"] = self.trainer._choice_thres(it)
        return out

    def _prune_checkpoints(self, max_keep: int):
        """Keep the newest ``max_keep`` ``iter_<n>.pth`` (the reference's
        max_keep_ckpts=1)."""
        if not max_keep or max_keep < 1:
            return
        ckpts = sorted((f for f in os.listdir(self.work_dir)
                        if re.fullmatch(r"iter_\d+\.pth", f)),
                       key=lambda f: int(f[5:-4]))
        for f in ckpts[:-max_keep]:
            os.remove(os.path.join(self.work_dir, f))
