"""Mouth-ROI detection on the host; the crop runs on the device from the
boxes (port of `avsync/data/mouth.py`).

The reference's TF stack finds the mouth with dlib's 68 landmarks and falls
back to a fixed crop (`train.py:126-203`). Without dlib the host stage is
OpenCV's Haar cascades (frontal face, then the smile cascade in the face's
lower half, then a padded box), where `cv2.CascadeClassifier` and the cascade
files exist; otherwise every frame gets the fixed crop `FALLBACK_BOX`. cv2 is
imported only when the cascade files are there. The detector returns
normalized boxes; `ops.image.crop_resize_boxes` crops on the device.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

import numpy as np

CASCADE_DIRS = (
    "/usr/share/opencv4/haarcascades",
    "/usr/local/share/opencv4/haarcascades",
)

# The fixed-crop fallback (`train.py:196-199`): rows [0.4, 0.7], cols [0.25, 0.75].
FALLBACK_BOX = (0.4, 0.7, 0.25, 0.75)


def _find_cascade(name: str) -> Optional[str]:
    for d in CASCADE_DIRS:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


class MouthDetector:
    """Per-frame mouth ROI as a normalized (y0, y1, x0, x1) box."""

    def __init__(self, padding_px: int = 30):
        self.padding_px = padding_px
        self._face = None
        self._mouth = None
        # detectMultiScale is not thread-safe, and the serving daemon calls
        # one detector from concurrent handler threads: detection is
        # serialized under this lock
        self._lock = threading.Lock()
        face_xml = _find_cascade("haarcascade_frontalface_default.xml")
        mouth_xml = _find_cascade("haarcascade_smile.xml")
        if face_xml and mouth_xml:
            try:
                import cv2
            except ImportError:
                cv2 = None
            # OpenCV 5 dropped CascadeClassifier from its core wheel: the
            # cascades run only where it exists
            if cv2 is not None and hasattr(cv2, "CascadeClassifier"):
                face, mouth = cv2.CascadeClassifier(face_xml), cv2.CascadeClassifier(mouth_xml)
                if not face.empty() and not mouth.empty():
                    self._face, self._mouth = face, mouth
        self.use_cascade = self._face is not None

    def detect_box(self, gray: np.ndarray) -> Tuple[float, float, float, float]:
        """Normalized mouth box of one gray frame; the fixed crop where
        detection fails (`train.py:130-138,190-203`)."""
        H, W = gray.shape[:2]
        if self.use_cascade:
            with self._lock:
                box = self._detect_cascade(gray)
            if box is not None:
                y0, y1, x0, x1 = box
                return (max(0.0, y0 / H), min(1.0, y1 / H), max(0.0, x0 / W), min(1.0, x1 / W))
        return FALLBACK_BOX

    def _detect_cascade(self, gray: np.ndarray):
        faces = self._face.detectMultiScale(gray, 1.1, 4)
        if len(faces) == 0:
            return None
        # the largest face, like dlib's first detection on a one-face frame
        fx, fy, fw, fh = max(faces, key=lambda f: f[2] * f[3])
        lower = gray[fy + fh // 2:fy + fh, fx:fx + fw]
        if lower.size == 0:
            return None
        mouths = self._mouth.detectMultiScale(lower, 1.5, 8)
        pad = self.padding_px
        if len(mouths) == 0:  # the lower third of the face box
            return (fy + int(fh * 0.65) - pad, fy + fh + pad,
                    fx + int(fw * 0.25) - pad, fx + int(fw * 0.75) + pad)
        mx, my, mw, mh = max(mouths, key=lambda m: m[2] * m[3])
        # back to frame coordinates, with the reference's padding
        return (fy + fh // 2 + my - pad, fy + fh // 2 + my + mh + pad,
                fx + mx - pad, fx + mx + mw + pad)

    def detect_clip(self, frames: np.ndarray) -> np.ndarray:
        """(T, H, W) -> (T, 4) float32 normalized boxes."""
        return np.asarray([self.detect_box(f) for f in frames], dtype=np.float32)

    def extract_mouth(self, frame: np.ndarray) -> np.ndarray:
        """Host-side crop of one frame for reference-compatible callers
        (`train.py:140-154`)."""
        H, W = frame.shape[:2]
        y0, y1, x0, x1 = self.detect_box(
            frame if frame.ndim == 2 else frame.mean(-1).astype(np.uint8))
        return frame[int(y0 * H):int(y1 * H), int(x0 * W):int(x1 * W)]
