"""Dataset readers: TUM RGB-D/mono and EUROC MAV directory layouts.

Capability parity with the reference's dataset plumbing:
- directory scan + lexicographic sort + minimum-count check
  (/root/reference/src/System.cpp:290-350 `AddLists`, >=15 images)
- TUM depth convention: 16-bit PNG, metric depth = value * 0.0002
  (/root/reference/src/Tracker.cpp:1223)
- EUROC layout: mav0/cam0/data/*.png (reference README.md:101-129)

Host-side I/O is deliberately outside jit; `FramePrefetcher` overlaps disk
decode with device compute via a background thread + jax.device_put double
buffering (SURVEY.md §7 "host/device pipeline").
"""
from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field

import numpy as np

MIN_IMAGES = 15  # reference src/System.cpp:347 requires >= 15 images


def read_pgm(path: str) -> np.ndarray:
    """Netpbm graymap (binary P5 or ASCII P2), 8- or 16-bit -> float32.

    16-bit samples are big-endian (the Netpbm spec) and keep their raw
    values, like 16-bit PNG depth."""
    with open(path, "rb") as f:
        data = f.read()
    tokens, pos = [], 0
    while len(tokens) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        tokens.append(data[pos:end])
        pos = end
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic == b"P2":
        vals = np.array(data[pos:].split()[: w * h], dtype=np.float32)
    elif magic == b"P5":
        dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
        vals = np.frombuffer(data, dtype, count=w * h, offset=pos + 1)
    else:
        raise IOError(f"not a PGM graymap ({magic!r}): {path}")
    return vals.reshape(h, w).astype(np.float32)


def write_pgm(path: str, image: np.ndarray) -> None:
    """Binary PGM: uint8 as 8-bit, uint16 as 16-bit big-endian."""
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_pgm takes uint8 or uint16, got {image.dtype}")
    h, w = image.shape
    maxval = 255 if image.dtype == np.uint8 else 65535
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n{maxval}\n".encode())
        f.write(image.astype(image.dtype.newbyteorder(">")).tobytes())


def _decode_image(path: str) -> np.ndarray:
    """Decode to grayscale float32 [0, 255] (16-bit images keep raw values;
    caller applies the depth factor). PGM is read in numpy; other formats
    by the native C++ decoder (native/loader.cpp via io.native), else by
    Pillow."""
    if os.path.splitext(path)[1].lower() == ".pgm":
        return read_pgm(path)
    from . import native

    if native.available():
        try:
            return native.decode(path)
        except IOError:
            pass  # fall through to Pillow for exotic formats
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"cannot decode {path}: neither the native loader "
            "(native/loader.cpp, built at first use with g++, libpng and "
            "libjpeg) nor Pillow is available; PGM needs neither"
        ) from None

    with Image.open(path) as im:
        if im.mode in ("I;16", "I"):
            return np.asarray(im, dtype=np.float32)
        return np.asarray(im.convert("L"), dtype=np.float32)


def list_images(directory: str, exts=(".png", ".jpg", ".jpeg", ".pgm")) -> list[str]:
    """Sorted image paths (the reference sorts raw dirent names and drops
    . / .., src/System.cpp:322-341).

    Sort is NUMERIC by timestamp stem when every name parses as a number,
    lexicographic otherwise: TUM/EUROC stamp filenames are fixed-width so
    both orders agree there, but variable-width numeric names (e.g.
    "99.png" vs "100.png") would scramble the frame order under a plain
    string sort — an out-of-order pair is a teleport the tracker cannot
    absorb."""
    names = [
        n for n in os.listdir(directory)
        if os.path.splitext(n)[1].lower() in exts
    ]
    try:
        names.sort(key=lambda n: float(os.path.splitext(n)[0]))
    except ValueError:
        names.sort()
    paths = [os.path.join(directory, n) for n in names]
    if len(paths) < MIN_IMAGES:
        raise ValueError(
            f"insufficient images in {directory}: {len(paths)} < {MIN_IMAGES}"
        )
    return paths


@dataclass
class Sequence:
    """A monocular (optionally +depth) image sequence."""

    image_paths: list[str]
    depth_paths: list[str] | None = None
    timestamps: np.ndarray | None = None  # (N,) float64 seconds
    name: str = ""

    def __len__(self):
        return len(self.image_paths)

    def load(self, i: int) -> tuple[np.ndarray, np.ndarray | None]:
        img = _decode_image(self.image_paths[i])
        depth = (
            _decode_image(self.depth_paths[i])
            if self.depth_paths is not None
            else None
        )
        return img, depth


def _tum_timestamp(path: str) -> float:
    stem = os.path.splitext(os.path.basename(path))[0]
    try:
        return float(stem)
    except ValueError:
        return 0.0


def open_tum(
    rgb_dir: str, depth_dir: str | None = None, start: int = 0
) -> Sequence:
    """TUM layout: rgb/<timestamp>.png [+ depth/<timestamp>.png].

    Depth frames are associated to RGB frames by nearest timestamp (the
    reference naively pairs by sort order, src/System.cpp:308-320)."""
    imgs = list_images(rgb_dir)[start:]
    depths = None
    if depth_dir is not None:
        dpaths = list_images(depth_dir)
        dts = np.array([_tum_timestamp(p) for p in dpaths])
        depths = []
        for p in imgs:
            t = _tum_timestamp(p)
            depths.append(dpaths[int(np.abs(dts - t).argmin())])
    ts = np.array([_tum_timestamp(p) for p in imgs])
    return Sequence(imgs, depths, ts, name="tum")


def open_euroc(mav_dir: str, cam: str = "cam0", start: int = 0) -> Sequence:
    """EUROC layout: <mav_dir>/<cam>/data/<ns>.png."""
    data_dir = os.path.join(mav_dir, cam, "data")
    imgs = list_images(data_dir)[start:]
    ts = np.array(
        [_tum_timestamp(p) * 1e-9 for p in imgs]
    )  # filenames are nanoseconds
    return Sequence(imgs, None, ts, name="euroc")


def open_directory(directory: str, start: int = 0) -> Sequence:
    """Bare directory of images (the reference's -d flag semantics).

    Timestamps are parsed from numeric filenames (TUM-style) when possible;
    otherwise left as None (frame index is used downstream)."""
    imgs = list_images(directory)[start:]
    ts = np.array([_tum_timestamp(p) for p in imgs])
    if not (np.diff(ts) > 0).all():
        ts = None
    return Sequence(imgs, None, ts, name=os.path.basename(directory))


class FramePrefetcher:
    """Background-thread image decoder feeding device memory.

    Decodes frame i+k while the tracker consumes frame i, so per-frame host
    I/O overlaps device compute (the reference does blocking imread inside the
    main loop, src/System.cpp:228)."""

    def __init__(self, seq: Sequence, depth_factor: float | None = None,
                 lookahead: int = 4):
        self._seq = seq
        self._q: queue.Queue = queue.Queue(maxsize=lookahead)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        for i in range(len(self._seq)):
            if self._stop.is_set():
                return
            self._q.put((i, self._seq.load(i)))
        self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class DeviceFramePrefetcher:
    """Wraps FramePrefetcher and issues the device upload ONE frame ahead,
    so frame i+1's host->device copy overlaps frame i's fused step.
    Yields (i, (image_device_or_np, depth)); frames with a depth image pass
    through un-uploaded (the RGBD path is not pipelined)."""

    def __init__(self, seq: Sequence, depth_factor: float | None = None,
                 lookahead: int = 4):
        self._inner = FramePrefetcher(
            seq, depth_factor=depth_factor, lookahead=lookahead
        )

    def __iter__(self):
        import jax

        held = None  # (i, img_dev, depth)
        for i, (img, depth) in self._inner:
            if depth is not None:
                if held is not None:
                    yield held[0], (held[1], held[2])
                    held = None
                yield i, (img, depth)
                continue
            # Ship 8-bit frames as uint8 — 4x fewer bytes than the
            # decoded f32; the megastep casts on device (its jit already
            # starts with astype(float32)). Decoders emit integral values
            # for 8-bit sources, so the cast is lossless; 16-bit mono
            # frames (max > 255) keep f32.
            if img.dtype != np.uint8 and img.max() <= 255.0:
                img = img.astype(np.uint8)
            dev = jax.device_put(img)
            if held is not None:
                yield held[0], (held[1], held[2])
            held = (i, dev, depth)
        if held is not None:
            yield held[0], (held[1], held[2])

    def close(self):
        self._inner.close()
