"""DSEC-Night: the unlabeled night target (warped image, real events, ISR)
and its labeled test split (mirrors cmda_tpu.data.dsec; reference
mmseg/datasets/dsec.py:125-384).

* list file: one line per sample, ``<image_path> <unused>``; the events
  window of frame ``i`` is ``[index[i - image_change_range], index[i]]`` of
  the sequence's ``images_to_events_index.txt``, sliced from
  ``events/left/events.h5`` and mapped through ``rectify_map.h5``.
* train: one ``(x, y, flip)`` draw in the 640x480 frame; the warped image
  cropped 400x400, flipped, resized to 512x512 PIL-bilinear; the ISR of
  that crop in direction ``direct[x % 2][y % 2]``; the events voxel grid
  (1 bin, or 5 averaged to 1) splatted at 480x640, normalised with the clip
  ``n / 5e5 * 1.5`` (or uniform in ``events_clip_range``), then cropped,
  flipped and resized bilinearly (torch's ``align_corners=False``).
* test: whole frames cut to the top 440 rows; labels
  ``labels/<seq>_<idx>_grey_gtFine_labelTrainIds.png``.

Building a ``DSECDataset`` imports h5py (and hdf5plugin when present, which
only registers codecs); without h5py it raises there. The voxel splat and
the norm are numpy (``host_voxel_grid``, ``host_events_norm``); the JAX
package's C++ ingest is not ported (ROADMAP queue A item 4).

Outputs: ``image``, ``events``, ``isr`` (HWC float32), ``label`` (HW int32,
test mode).
"""
from __future__ import annotations

import os
import random
import threading

import numpy as np
from PIL import Image

from .cache import DecodeCache
from .h5 import read_slice
from .host_isr import (host_image_change, normalize_image, open_rgb,
                       pick_shift_direction)


def host_voxel_grid(t, x, y, p, width, height, num_bins):
    """Trilinear splat of events into a [bins, H, W] float32 grid: each
    event adds ``2p - 1`` to its 8 neighbours in (x, y, normalised t)."""
    grid = np.zeros((num_bins, height, width), np.float32)
    if len(t) == 0:
        return grid
    denom = t[-1] - t[0]
    t_norm = (num_bins - 1) * (t - t[0]) / (denom if denom != 0 else 1.0)
    x0, y0 = x.astype(np.int32), y.astype(np.int32)
    t0 = t_norm.astype(np.int32)
    value = 2.0 * p - 1.0
    flat = grid.reshape(-1)
    for dx in (0, 1):
        for dy in (0, 1):
            for dt in (0, 1):
                xl, yl, tl = x0 + dx, y0 + dy, t0 + dt
                m = ((xl >= 0) & (xl < width) & (yl >= 0) & (yl < height)
                     & (tl >= 0) & (tl < num_bins))
                w = (value * (1 - np.abs(xl - x)) * (1 - np.abs(yl - y))
                     * (1 - np.abs(tl - t_norm)))
                idx = height * width * tl + width * yl + xl
                np.add.at(flat, idx[m], w[m])
    return grid


def host_events_norm(grid, clip_range, final_range=1.0):
    """Standardise the non-zero cells, then clip each sign to
    ``clip_range`` and min-max it to ``[0, final_range]`` and
    ``[-final_range, 0]``."""
    nz = grid != 0
    n = nz.sum()
    if n > 0:
        mean = grid.sum() / n
        std = np.sqrt(max((grid ** 2).sum() / n - mean ** 2, 0.0))
        grid = np.where(nz, (grid - mean) / (std + 1e-8),
                        0.0).astype(np.float32)

    def norm(xx, lo, hi):
        mn, mx = xx.min(), xx.max()
        return (xx - mn) / (mx - mn + 1e-8) * (hi - lo) + lo

    pos = norm(np.clip(np.maximum(grid, 0), 0, clip_range), 0, final_range)
    neg = norm(np.clip(np.minimum(grid, 0), -clip_range, 0), -final_range, 0)
    return pos + neg


def bilinear_resize(arr2d, out_hw):
    """[H, W] -> ``out_hw`` by torch's CPU bilinear resize
    (``align_corners=False``), as the reference resizes the events
    (dsec.py:365-369)."""
    import torch
    import torch.nn.functional as F
    if arr2d.shape == tuple(out_hw):
        return arr2d.astype(np.float32)
    t = torch.from_numpy(np.ascontiguousarray(arr2d, np.float32))
    out = F.interpolate(t[None, None], size=tuple(out_hw), mode="bilinear",
                        align_corners=False)
    return out[0, 0].numpy()


class DSECDataset:
    HEIGHT, WIDTH = 480, 640
    TEST_ROWS = 440

    def __init__(self, dataset_txt_path: str, *, events_bins: int = 1,
                 crop_size=(400, 400), after_crop_resize_size=(512, 512),
                 image_change_range: int = 1, isr_params=None,
                 shift_type: str = "random", test_mode: bool = False,
                 events_clip_range=None, decode_cache: int = 0,
                 outputs=("image", "events", "isr")):
        import h5py
        try:
            import hdf5plugin  # noqa: F401  (registers codecs, if present)
        except ImportError:
            pass
        self._h5py = h5py
        self.txt_path = dataset_txt_path
        self.events_bins = events_bins
        self.crop = tuple(crop_size)                 # (W, H), train mode
        self.resize = tuple(after_crop_resize_size)  # (W, H)
        self.image_change_range = image_change_range
        self.events_clip_range = events_clip_range
        self.test_mode = test_mode
        self.outputs = set(outputs)
        self.shift_type = shift_type
        p = isr_params
        self.isr_kw = dict(val_range=p.val_range, threshold=p.threshold,
                           clip_range=p.clip_range, shift_pixel=p.shift_pixel)
        self.rows = np.loadtxt(dataset_txt_path, dtype=str, encoding="utf-8",
                               ndmin=2)
        # one lock for every libhdf5 call on this dataset's File handles,
        # which the loader's worker threads share
        self._h5_lock = threading.Lock()
        self._h5_files = {}
        # immutable side tables: the per-sequence index file, rectify maps
        self._index_cache = {}
        self._rect_cache = {}
        self._cache = DecodeCache(decode_cache)   # warp frames, grids

    def __len__(self):
        return len(self.rows)

    # ---------------- events ----------------
    def _open_h5(self, path):
        with self._h5_lock:
            if path not in self._h5_files:
                self._h5_files[path] = self._h5py.File(path, "r")
            return self._h5_files[path]

    def _rectify_map(self, image_path):
        path = image_path.replace("images", "events")[:-20] + "rectify_map.h5"
        if path not in self._rect_cache:
            rmap = None
            if os.path.exists(path):
                h5 = self._open_h5(path)
                with self._h5_lock:
                    rmap = np.asarray(h5["rectify_map"])
            self._rect_cache[path] = rmap
        return self._rect_cache[path]

    def _splat_grid(self, image_path, finish, start):
        """The un-normalised [bins, H, W] voxel grid of the window, a
        function of (events file, window) only, so the decode LRU may keep
        it; the random part of the draw comes after."""
        h5 = self._open_h5(image_path.replace("images", "events")[:-20]
                           + "events.h5")
        t, x, y, p = (read_slice(h5, f"events/{k}", start, finish + 1,
                                 lock=self._h5_lock) for k in "txyp")
        p = p.astype(np.float32)
        t = (t - t[0]).astype(np.float32)
        if t[-1] > 0:
            t = t / t[-1]
        rmap = self._rectify_map(image_path)
        if rmap is not None:
            xy = rmap[y, x]
            x, y = xy[:, 0].astype(np.float32), xy[:, 1].astype(np.float32)
        else:
            x, y = x.astype(np.float32), y.astype(np.float32)
        return host_voxel_grid(t, x, y, p, self.WIDTH, self.HEIGHT,
                               self.events_bins)

    def _events_grid(self, image_path, finish, start, rng):
        grid = self._cache.get(
            ("grid", image_path, start, finish),
            lambda: self._splat_grid(image_path, finish, start))
        if self.events_clip_range is not None:
            lo, hi = self.events_clip_range
            clip = rng.uniform(lo, hi)
        else:
            clip = (finish - start) / 500000.0 * 1.5
        return host_events_norm(grid.copy(), clip)

    def _window(self, image_path, now_index):
        """(start, finish) event indices of frame ``now_index``."""
        idx_file = os.path.join(image_path.split("left/rectified")[0],
                                "images_to_events_index.txt")
        if idx_file not in self._index_cache:
            self._index_cache[idx_file] = np.loadtxt(
                idx_file, dtype=str, encoding="utf-8")
        index_map = self._index_cache[idx_file]
        return (int(index_map[now_index - self.image_change_range]),
                int(index_map[now_index]))

    # ---------------- samples ----------------
    def load(self, idx: int, rng: random.Random | None = None):
        """Sample ``idx``; ``rng`` is the loader worker's ``random.Random``
        (the module's ``random`` when None)."""
        r = rng if rng is not None else random
        image_path = str(self.rows[idx][0])
        now_index = int(os.path.basename(image_path).split(".")[0])
        rows = self.TEST_ROWS
        out = {}
        if not self.test_mode:
            flip = r.random() < 0.5
            x = r.randint(0, self.WIDTH - self.crop[0])
            y = r.randint(0, self.HEIGHT - self.crop[1])
            box = (x, y, x + self.crop[0], y + self.crop[1])

        warp_path = image_path.replace("images/left/rectified", "warp_images")
        warp_pil = self._cache.get(("warp", warp_path),
                                   lambda: open_rgb(warp_path))
        warp_crop_pil = None
        if not self.test_mode and ({"image", "isr"} & self.outputs):
            warp_crop_pil = warp_pil.crop(box)
            if flip:
                warp_crop_pil = warp_crop_pil.transpose(Image.FLIP_LEFT_RIGHT)
            warp_crop_pil = warp_crop_pil.resize(self.resize,
                                                 resample=Image.BILINEAR)

        if "image" in self.outputs:
            out["image"] = (normalize_image(warp_pil)[:rows] if self.test_mode
                            else normalize_image(warp_crop_pil))

        if "isr" in self.outputs:
            if self.test_mode:
                src_pil, a, b = warp_pil, 0, 0
            else:
                src_pil, a, b = warp_crop_pil, x, y
            isr = host_image_change(
                src_pil, shift_direction=pick_shift_direction(
                    self.shift_type, a, b), **self.isr_kw)
            if self.test_mode:
                isr = isr[:rows]
            out["isr"] = np.broadcast_to(isr[..., None], isr.shape + (3,))

        if "events" in self.outputs:
            start, finish = self._window(image_path, now_index)
            grid = self._events_grid(image_path, finish, start, r)
            ev = grid[0] if self.events_bins == 1 else grid.mean(0)
            if self.test_mode:
                ev = ev[:rows]
            else:
                ev = ev[y: y + self.crop[1], x: x + self.crop[0]]
                if flip:
                    ev = ev[:, ::-1]
                ev = bilinear_resize(ev, (self.resize[1], self.resize[0]))
            ev = np.ascontiguousarray(ev)
            out["events"] = np.broadcast_to(ev[..., None], ev.shape + (3,))

        if "label" in self.outputs:
            seq = image_path.split("/")[-5]
            lbl_path = (f"{image_path.split('images/left/rectified')[0]}"
                        f"labels/{seq}_{now_index:06d}"
                        "_grey_gtFine_labelTrainIds.png")
            with Image.open(lbl_path) as im:
                out["label"] = np.asarray(im).astype(np.int32)[:rows]
        return out

    def __getitem__(self, idx):
        return self.load(idx)
