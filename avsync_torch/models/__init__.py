"""Models of the port."""

from avsync_torch.models.detector import MisalignmentDetector
from avsync_torch.models.lipnet import LipNet

__all__ = ["LipNet", "MisalignmentDetector"]
