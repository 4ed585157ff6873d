"""ctypes binding of the port's C++ libav ingest (`ingest.cpp`, a copy of the
JAX package's `avsync/ingest/ingest.cpp`).

The library builds at first use, never at import:

    g++ -O2 -fPIC -std=c++17 -shared $(pkg-config --cflags --libs libavformat
        libavcodec libswscale libswresample libavutil)
        -o build/avsync_torch_ingest/libavsingest-<hash>.so

The file name carries a hash of the source and the flags, so an edited source
is never served from a stale build, and nothing is written into the package
directory. Where pkg-config, a libav development package or g++ is missing,
`available()` is False and `why_unavailable()` holds the tool's message;
`avsync_torch.data.video` then takes cv2, where it imports.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("ingest.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "avsync_torch_ingest"
PKGS = ("libavformat", "libavcodec", "libswscale", "libswresample", "libavutil")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

Clip = Tuple[np.ndarray, float, np.ndarray, int]  # (video (T, H, W) u8, fps, audio f32, sr)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_why: Optional[str] = None  # set when the build or the load failed
_info: dict = {}  # {"seconds": build time (0 when cached), "libavformat": version}


def _run(cmd: List[str]) -> str:
    """stdout of `cmd`; raises RuntimeError with its stderr when it fails."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{cmd[0]}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:3])} ... failed: "
                           f"{(proc.stderr or proc.stdout).strip()}")
    return proc.stdout.strip()


def library_path(flags: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + flags.encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libavsingest-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """The library's path, compiled first when there is no current build."""
    cflags = _run(["pkg-config", "--cflags", *PKGS])
    libs = _run(["pkg-config", "--libs", *PKGS])
    _info["libavformat"] = _run(["pkg-config", "--modversion", "libavformat"])
    out = library_path(cflags + " " + libs)
    _info["seconds"] = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        _run(["g++", *CXX_FLAGS, *cflags.split(), "-o", str(tmp), str(SOURCE), *libs.split()])
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        _info["seconds"] = time.perf_counter() - t0
    return out


def _declare(lib: ctypes.CDLL) -> None:
    vp, cp, i, d = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_double
    sig = {
        "avs_decode": (vp, [cp, i, i]),
        "avs_error": (cp, [vp]),
        "avs_fps": (d, [vp]),
        "avs_video_data": (ctypes.POINTER(ctypes.c_uint8), [vp]),
        "avs_audio_data": (ctypes.POINTER(ctypes.c_float), [vp]),
        "avs_release": (None, [vp]),
        "avs_decode_batch": (ctypes.POINTER(vp), [ctypes.POINTER(cp), i, i, i, i]),
        "avs_decode_batch_roi": (ctypes.POINTER(vp),
                                 [ctypes.POINTER(cp), i, i, i, d, d, d, d, i, i, i]),
        "avs_release_batch": (None, [ctypes.POINTER(vp), i]),
        "avs_mux_mp4": (i, [cp, ctypes.POINTER(ctypes.c_uint8), i, i, i, d,
                            ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, i, cp, i]),
    }
    for name in ("avs_n_frames", "avs_height", "avs_width", "avs_n_samples",
                 "avs_sample_rate"):
        sig[name] = (i, [vp])
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None (with the reason in
    `why_unavailable()`) where it cannot be built or loaded. Tried once."""
    global _lib, _why
    with _lock:
        if _lib is None and _why is None:
            try:
                lib = ctypes.CDLL(str(_build()))
                _declare(lib)
                _lib = lib
            except (RuntimeError, OSError, AttributeError) as e:
                _why = str(e)
        return _lib


def available() -> bool:
    return _load() is not None


def why_unavailable() -> Optional[str]:
    """Why the library could not be built or loaded (pkg-config's, g++'s or
    the loader's message); None when it is available."""
    _load()
    return _why


def build_info() -> dict:
    """{"seconds": the build's time in this process (0.0 when a current
    build existed), "libavformat": pkg-config's version}; empty when
    unavailable."""
    _load()
    return dict(_info) if _lib is not None else {}


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native ingest library unavailable: {_why}")
    return lib


def _unpack(lib: ctypes.CDLL, h) -> Clip:
    """A decoded handle's (video, fps, audio, sample_rate), copied out."""
    T, H, W = lib.avs_n_frames(h), lib.avs_height(h), lib.avs_width(h)
    video = (np.ctypeslib.as_array(lib.avs_video_data(h), shape=(T, H, W)).copy() if T > 0
             else np.zeros((0, 0, 0), np.uint8))
    n = lib.avs_n_samples(h)
    audio = (np.ctypeslib.as_array(lib.avs_audio_data(h), shape=(n,)).copy() if n > 0
             else np.zeros(0, np.float32))
    return video, float(lib.avs_fps(h)), audio, int(lib.avs_sample_rate(h))


def _unpack_batch(lib: ctypes.CDLL, handles, n: int) -> List[Clip]:
    """Each handle's clip; a handle that failed gives the empty row
    (empty video, 0.0, empty audio, 0), so one bad file cannot fail a batch."""
    try:
        return [(np.zeros((0, 0, 0), np.uint8), 0.0, np.zeros(0, np.float32), 0)
                if lib.avs_error(handles[i]) else _unpack(lib, handles[i]) for i in range(n)]
    finally:
        lib.avs_release_batch(handles, n)


def _paths(paths) -> Tuple[ctypes.Array, int]:
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths]), len(paths)


def decode(path: str, max_frames: int = 0, target_sr: int = 0) -> Clip:
    """Full decode: (video (T, H, W) uint8, fps, mono float32 audio,
    sample_rate). Raises RuntimeError on a demux or codec failure."""
    lib = _lib_or_raise()
    h = lib.avs_decode(os.fsencode(path), int(max_frames), int(target_sr))
    try:
        err = lib.avs_error(h)
        if err:
            raise RuntimeError(f"ingest: {err.decode()} ({path})")
        return _unpack(lib, h)
    finally:
        lib.avs_release(h)


def decode_batch(paths, max_frames: int = 0, target_sr: int = 0,
                 n_threads: int = 0) -> List[Clip]:
    """Decode many files on the library's thread pool, in order; a file
    that fails gives the empty row."""
    lib = _lib_or_raise()
    arr, n = _paths(paths)
    return _unpack_batch(lib, lib.avs_decode_batch(arr, n, int(max_frames), int(target_sr),
                                                   int(n_threads)), n)


def decode_batch_roi(paths, crop: Tuple[float, float, float, float], out_hw: Tuple[int, int],
                     max_frames: int = 0, target_sr: int = 0,
                     n_threads: int = 0) -> List[Clip]:
    """`decode_batch` with a crop + resize at decode time: frames arrive at
    `out_hw`. `crop` is (y0, y1, x0, x1), normalized."""
    lib = _lib_or_raise()
    arr, n = _paths(paths)
    y0, y1, x0, x1 = (float(c) for c in crop)
    return _unpack_batch(lib, lib.avs_decode_batch_roi(
        arr, n, int(max_frames), int(target_sr), y0, y1, x0, x1, int(out_hw[1]),
        int(out_hw[0]), int(n_threads)), n)


def mux_mp4(path: str, frames: np.ndarray, fps: float, audio: Optional[np.ndarray] = None,
            sample_rate: int = 0) -> None:
    """Encode (T, H, W, 3) BGR uint8 frames, and mono float32 audio if given,
    into an `.mp4` with libx264 and AAC."""
    lib = _lib_or_raise()
    frames = np.ascontiguousarray(frames, np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (T, H, W, 3) BGR, got {frames.shape}")
    if audio is None or audio.size == 0:
        a_ptr, n_samples, sample_rate = ctypes.POINTER(ctypes.c_float)(), 0, 0
    else:
        audio = np.ascontiguousarray(audio, np.float32)
        a_ptr, n_samples = audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), audio.size
    err = ctypes.create_string_buffer(256)
    rc = lib.avs_mux_mp4(os.fsencode(path), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         frames.shape[0], frames.shape[1], frames.shape[2], float(fps), a_ptr,
                         n_samples, int(sample_rate), err, 256)
    if rc != 0:
        raise RuntimeError(f"mux failed: {err.value.decode()}")


def decode_video_gray(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    return decode(path, max_frames or 0)[0]


def get_fps(path: str) -> float:
    return decode(path, max_frames=1)[1]


def decode_audio(path: str, target_sr: int = 0) -> Tuple[np.ndarray, int]:
    _, _, audio, sr = decode(path, max_frames=1, target_sr=target_sr)
    return audio, sr
