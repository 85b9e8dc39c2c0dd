"""ctypes bindings for the C++ libav data plane, ``native/libvimo_dataplane.so``
(the port's own copy of ``vimoclip_tpu/data/native.py``, over the same
library: ``make native`` builds it from ``native/dataplane.cc``).

The library decodes a whole video, or an exact window after a seek, into a
caller-owned uint8 RGB buffer, and runs a corpus decode pool (C++ workers
and a bounded ready queue). ``available()`` is False while the library is
not built; ``data/video_reader.py`` then decodes with OpenCV.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libvimo_dataplane.so",
    )


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.vimo_open.restype = ctypes.c_void_p
    lib.vimo_open.argtypes = [ctypes.c_char_p]
    lib.vimo_close.argtypes = [ctypes.c_void_p]
    lib.vimo_frame_count.restype = ctypes.c_long
    lib.vimo_frame_count.argtypes = [ctypes.c_void_p]
    lib.vimo_dims.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vimo_read_window.restype = ctypes.c_long
    lib.vimo_read_window.argtypes = [
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_void_p,
    ]
    lib.vimo_pool_create.restype = ctypes.c_void_p
    lib.vimo_pool_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.vimo_pool_submit.restype = ctypes.c_int
    lib.vimo_pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p]
    lib.vimo_pool_seal.argtypes = [ctypes.c_void_p]
    lib.vimo_pool_peek.restype = ctypes.c_int
    lib.vimo_pool_peek.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.vimo_pool_take.restype = ctypes.c_long
    lib.vimo_pool_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.vimo_pool_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


class _Decoder:
    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native data plane not built")
        self._lib = lib
        self._h = lib.vimo_open(path.encode())
        if not self._h:
            raise IOError(f"native decoder could not open {path}")
        w, h = ctypes.c_int(), ctypes.c_int()
        lib.vimo_dims(self._h, ctypes.byref(w), ctypes.byref(h))
        self.width, self.height = w.value, h.value

    def frame_count(self) -> int:
        return int(self._lib.vimo_frame_count(self._h))

    def read_window(self, start: int, num: int) -> np.ndarray:
        buf = np.empty((num, self.height, self.width, 3), dtype=np.uint8)
        got = self._lib.vimo_read_window(
            self._h, start, num, buf.ctypes.data_as(ctypes.c_void_p)
        )
        if got < 0:
            raise IOError(f"native decode failed (code {got})")
        return buf[:got]

    def close(self):
        if self._h:
            self._lib.vimo_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_POOL_ERRORS = {
    1: "could not open video",
    2: "native decode failed",
    3: "no frames decoded",
}


class DecodePool:
    """The native corpus decode pool: C++ workers decode many videos at once
    (workers and the bounded ready queue live in ``native/dataplane.cc``;
    Python only submits paths and drains blocks), with no GIL in the decode
    path and one copy per block into numpy. Usage::

        with DecodePool(workers=8, chunk_frames=128) as pool:
            for vid, path in videos:
                pool.submit(vid, path)
            pool.seal()
            for vid, frames, final, error in pool:
                ...  # frames: (n, H, W, 3) uint8 RGB, in-order per video
    """

    def __init__(self, workers: int = 0, chunk_frames: int = 128,
                 max_ready: int = 16):
        lib = _load()
        if lib is None:
            raise RuntimeError("native data plane not built")
        self._lib = lib
        self._h = lib.vimo_pool_create(workers, chunk_frames, max_ready)
        self._ids: dict[int, str] = {}
        self._next = 0

    def submit(self, video_id: str, path: str) -> None:
        job = self._next
        self._next += 1
        self._ids[job] = video_id
        if self._lib.vimo_pool_submit(self._h, job, path.encode()) != 0:
            raise RuntimeError("submit after seal")

    def seal(self) -> None:
        self._lib.vimo_pool_seal(self._h)

    def __iter__(self):
        import ctypes as ct

        jid, n = ct.c_long(), ct.c_long()
        w, h, fin, err = ct.c_int(), ct.c_int(), ct.c_int(), ct.c_int()
        while self._lib.vimo_pool_peek(
            self._h, ct.byref(jid), ct.byref(n), ct.byref(w), ct.byref(h),
            ct.byref(fin), ct.byref(err),
        ):
            frames = np.empty((n.value, h.value, w.value, 3), dtype=np.uint8)
            got = self._lib.vimo_pool_take(
                self._h,
                frames.ctypes.data_as(ct.c_void_p) if n.value else None,
            )
            assert got == n.value, (got, n.value)
            yield (
                self._ids[jid.value],
                frames,
                bool(fin.value),
                _POOL_ERRORS.get(err.value),
            )

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.vimo_pool_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def read_video(path: str, max_frames: int | None = None) -> np.ndarray:
    d = _Decoder(path)
    try:
        n = d.frame_count()
        if n <= 0:
            # unknown container frame count: bounded windows until EOF
            # instead of one speculative huge buffer
            chunks = []
            got_total = 0
            while max_frames is None or got_total < max_frames:
                want = 512 if max_frames is None else min(512, max_frames - got_total)
                chunk = d.read_window(got_total, want)
                chunks.append(chunk)
                got_total += chunk.shape[0]
                if chunk.shape[0] < want:
                    break
            out = (
                np.concatenate(chunks)
                if chunks
                else np.zeros((0, d.height, d.width, 3), np.uint8)
            )
        else:
            if max_frames is not None:
                n = min(n, max_frames)
            out = d.read_window(0, n)
        if out.shape[0] == 0:
            raise IOError(f"no frames decoded from {path}")
        return out
    finally:
        d.close()


def read_video_window(path: str, start: int, num_frames: int) -> np.ndarray:
    d = _Decoder(path)
    try:
        out = d.read_window(start, num_frames)
        if out.shape[0] == 0:
            raise IOError(f"no frames decoded from {path} at {start}")
        return out
    finally:
        d.close()
