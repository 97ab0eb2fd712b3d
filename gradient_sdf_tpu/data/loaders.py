"""Dataset loaders: TUM RGB-D, Redwood, Synth, Printed3D.

Python re-design of the reference's loader hierarchy
(`cpp/include/img_loader/ImageLoader.h:51-263` + 4 concrete loaders):
same directory conventions, depth units, and trajectory format, but exposed
as iterators yielding numpy frames ready for host->device transfer.

Conventions preserved:
  * 16-bit depth PNGs scaled by per-dataset unit to float32 meters
    (TUM: 1/5000, others: 1/1000 — `TumrgbdLoader.h:62`, `SynthLoader.h:53`).
  * color as float32 in [0, 1]; stored RGB channel order (the reference keeps
    OpenCV BGR — only scalar intensity is ever consumed, so order is
    irrelevant downstream; we note it for byte-level comparisons).
  * TUM trajectory lines `timestamp tx ty tz qx qy qz qw`, with the
    quaternion-norm validity warning (`ImageLoader.h:231-259`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np

from ..utils import png, tumio


def _imread(path: str) -> np.ndarray:
    # native zlib-based PNG decoder first (no GIL held while inflating),
    # then the stdlib codec; PIL is imported only for formats neither
    # handles (JPEG rgb in Redwood, palette or interlaced PNGs, ...)
    if path.endswith(".png"):
        from .. import native

        arr = native.decode_png(path)
        if arr is not None:
            return arr
        try:
            return png.read_png(path)
        except png.UnsupportedPng:
            pass
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def _depth_from_raw(raw: np.ndarray, unit: float) -> np.ndarray:
    return raw.astype(np.float32) * unit


def _color_from_raw(raw: np.ndarray) -> np.ndarray:
    if raw.ndim == 2:
        raw = np.stack([raw] * 3, axis=-1)
    if raw.shape[-1] == 4:
        raw = raw[..., :3]
    return raw.astype(np.float32) / 255.0


def load_depth_png(path: str, unit: float) -> np.ndarray:
    """16-bit depth PNG -> float32 meters (`ImageLoader.h:159-175`)."""
    return _depth_from_raw(_imread(path), unit)


def load_color_png(path: str) -> np.ndarray:
    """Color image -> float32 RGB in [0,1]; grayscale is replicated to 3
    channels (`ImageLoader.h:196-217`)."""
    return _color_from_raw(_imread(path))


class _PrefetchReader:
    """Ordered decode-ahead over a path list.

    PNG files are decoded by the native threaded prefetcher
    (`native.Prefetcher`, 2 worker threads, bounded decode-ahead window)
    so disk IO + zlib inflate overlap the consumer's device compute; any
    non-PNG path (Redwood rgb JPEGs) and any native-decoder failure fall
    back to the synchronous `_imread` path. Frames come back identical to
    the synchronous loader byte for byte (tests/test_loaders.py)."""

    def __init__(self, paths: list, n_threads: int = 2, window: int = 16):
        self._paths = paths
        self._pf = None
        self._pf_pos = {}  # path-list index -> prefetcher index
        png = [(i, p) for i, p in enumerate(paths) if p.endswith(".png")]
        if png:
            from .. import native

            if native.available():
                try:
                    self._pf = native.Prefetcher(
                        [p for _, p in png], n_threads, window)
                    self._pf_pos = {i: j for j, (i, _) in enumerate(png)}
                except Exception:
                    self._pf = None

    def get(self, i: int) -> np.ndarray:
        j = self._pf_pos.get(i)
        if self._pf is not None and j is not None:
            arr = self._pf.get(j)
            if arr is not None:
                return arr
        return _imread(self._paths[i])

    def close(self):
        if self._pf is not None:
            self._pf.close()
            self._pf = None


@dataclasses.dataclass
class Frame:
    color: np.ndarray           # [H, W, 3] float32 RGB in [0,1]
    depth: np.ndarray           # [H, W] float32 meters
    timestamp: str
    index: int


class ImageLoader:
    """Base loader: intrinsics + GT-pose files + frame iteration."""

    unit: float = 1e-3

    def __init__(self, path: str):
        self.path = path.rstrip("/") + "/"
        self.timestamps: list[str] = []

    def load_intrinsics(self, filename: str = "intrinsics.txt") -> Optional[np.ndarray]:
        """3x3 row-major K from a whitespace text file (`ImageLoader.h:138-157`)."""
        p = os.path.join(self.path, filename)
        if not os.path.isfile(p):
            return None
        vals = np.loadtxt(p, dtype=np.float64).reshape(3, 3)
        return vals.astype(np.float32)

    def load_poses(self, filename: str):
        """TUM trajectory -> list of (R, t) camera-to-world, or None."""
        p = os.path.join(self.path, filename)
        if not os.path.isfile(p):
            return None
        return tumio.read_trajectory(p)

    def _frame_specs(self, first: int, last: Optional[int]):
        """Ordered list of (index, timestamp, color_path, depth_path) for
        the requested range — the loader-specific directory convention.
        Enables the shared decode-ahead `frames()` below."""
        raise NotImplementedError

    def frames(self, first: int = 0, last: Optional[int] = None) -> Iterator[Frame]:
        """Iterate frames with decode-ahead: the file list is enumerated up
        front and handed to the native threaded prefetcher (fallback:
        synchronous decode), so the NEXT frames' PNG inflate overlaps this
        frame's consumption, and frame decode leaves the app loop's
        per-frame critical path."""
        specs = self._frame_specs(first, last)
        paths = []
        for _, _, cp, dp in specs:
            paths.append(cp)
            paths.append(dp)
        reader = _PrefetchReader(paths)
        try:
            for k, (i, ts, cp, dp) in enumerate(specs):
                self.timestamps.append(ts)
                yield Frame(
                    color=_color_from_raw(reader.get(2 * k)),
                    depth=_depth_from_raw(reader.get(2 * k + 1), self.unit),
                    timestamp=ts,
                    index=i,
                )
        finally:
            reader.close()

    def load_keyframe(self, index: int) -> Optional[Frame]:
        return None

    def load_color_at(self, index: int) -> Optional[np.ndarray]:
        """Random-access reload of one frame's color image.

        Lets PhotoBA keep only frame INDICES for keyframe candidates during
        phase 1 and decode the <= --key-frame sampled images right before
        BA — bounding host memory to O(max_keyframes) images instead of one
        float image per keyframe-eligible frame (the reference copies every
        candidate into RAM, main_photo_ba.cpp:228-231/:252-254 — unbounded
        on long sequences)."""
        return None


class TumrgbdLoader(ImageLoader):
    """TUM RGB-D: `associated.txt` lines `ts_rgb rgb_path ts_depth depth_path`
    (`TumrgbdLoader.h:79-103`); depth unit 1/5000."""

    unit = 1.0 / 5000.0

    def __init__(self, path: str):
        super().__init__(path)
        self.assoc = []
        assoc_path = os.path.join(self.path, "associated.txt")
        with open(assoc_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts_rgb, rgb_f, ts_depth, depth_f = line.split()[:4]
                self.assoc.append((ts_rgb, rgb_f, ts_depth, depth_f))

    def _frame_specs(self, first=0, last=None):
        last = len(self.assoc) if last is None else min(last, len(self.assoc))
        return [
            (i, self.assoc[i][0],
             os.path.join(self.path, self.assoc[i][1]),
             os.path.join(self.path, self.assoc[i][3]))
            for i in range(first, last)
        ]

    def __len__(self):
        return len(self.assoc)

    def load_color_at(self, index: int):
        if not (0 <= index < len(self.assoc)):
            return None
        return load_color_png(os.path.join(self.path, self.assoc[index][1]))


class RedwoodLoader(ImageLoader):
    """Redwood: sorted `depth/*.png` + `rgb/*.jpg` listings
    (`RedwoodLoader.h:57-141`); unit 1/1000; timestamp = filename stem."""

    unit = 1.0 / 1000.0

    def __init__(self, path: str):
        super().__init__(path)
        self.depth_files = sorted(os.listdir(os.path.join(self.path, "depth")))
        self.rgb_files = sorted(os.listdir(os.path.join(self.path, "rgb")))

    def _frame_specs(self, first=0, last=None):
        n = min(len(self.depth_files), len(self.rgb_files))
        last = n if last is None else min(last, n)
        return [
            (i, os.path.splitext(self.depth_files[i])[0],
             os.path.join(self.path, "rgb", self.rgb_files[i]),
             os.path.join(self.path, "depth", self.depth_files[i]))
            for i in range(first, last)
        ]

    def __len__(self):
        return min(len(self.depth_files), len(self.rgb_files))

    def load_color_at(self, index: int):
        if not (0 <= index < len(self.rgb_files)):
            return None
        return load_color_png(
            os.path.join(self.path, "rgb", self.rgb_files[index]))


class SynthLoader(ImageLoader):
    """Synthetic spheres: `depth/%03d.png` + `rgb/%03d.png` from 1
    (`SynthLoader.h:65-84`); unit 1/1000; keyframes read `albedo/`."""

    unit = 1.0 / 1000.0

    def __init__(self, path: str):
        super().__init__(path)

    def _name(self, i: int) -> str:
        return f"{i + 1:03d}.png"

    def _frame_specs(self, first=0, last=None):
        specs = []
        i = first
        while last is None or i < last:
            dp = os.path.join(self.path, "depth", self._name(i))
            cp = os.path.join(self.path, "rgb", self._name(i))
            if not (os.path.isfile(dp) and os.path.isfile(cp)):
                break
            specs.append((i, f"{i + 1:03d}", cp, dp))
            i += 1
        return specs

    def load_color_at(self, index: int):
        cp = os.path.join(self.path, "rgb", self._name(index))
        return load_color_png(cp) if os.path.isfile(cp) else None

    def load_keyframe(self, index: int):
        """Keyframe color comes from `albedo/` (`SynthLoader.h:86-107`)."""
        dp = os.path.join(self.path, "depth", self._name(index))
        cp = os.path.join(self.path, "albedo", self._name(index))
        if not (os.path.isfile(dp) and os.path.isfile(cp)):
            return None
        return Frame(
            color=load_color_png(cp),
            depth=load_depth_png(dp, self.unit),
            timestamp=f"{index + 1:03d}",
            index=index,
        )


class Printed3dLoader(ImageLoader):
    """Printed3D: `depth_%06d.png` + `color_%06d.png` from 0
    (`Printed3dLoader.h:52-112`); unit 1/1000."""

    unit = 1.0 / 1000.0

    def load_color_at(self, index: int):
        cp = os.path.join(self.path, f"color_{index:06d}.png")
        return load_color_png(cp) if os.path.isfile(cp) else None

    def _frame_specs(self, first=0, last=None):
        specs = []
        i = first
        while last is None or i < last:
            dp = os.path.join(self.path, f"depth_{i:06d}.png")
            cp = os.path.join(self.path, f"color_{i:06d}.png")
            if not (os.path.isfile(dp) and os.path.isfile(cp)):
                break
            specs.append((i, f"{i:06d}", cp, dp))
            i += 1
        return specs


def make_loader(data_type: str, path: str) -> ImageLoader:
    """Dataset dispatch (`main_scan_3d.cpp:117-159`)."""
    data_type = data_type.lower()
    if data_type in ("tum", "tumrgbd"):
        return TumrgbdLoader(path)
    if data_type in ("rw", "redwood"):
        return RedwoodLoader(path)
    if data_type in ("synth", "synthetic"):
        return SynthLoader(path)
    if data_type in ("printed", "printed3d"):
        return Printed3dLoader(path)
    raise ValueError(f"unknown data type: {data_type}")
